"""Data iterators.

PyTorch counterpart of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``,
``DataIter``, the in-memory ``NDArrayIter``, ``ResizeIter``,
``PrefetchingIter``, ``KBatchIter`` and the file readers ``CSVIter``,
``MNISTIter`` (IDX files) and ``LibSVMIter``.  Iterators are host-side:
they yield NDArrays on the CPU in the dtype they were given (int32 token
ids stay int32), and ``Module.forward`` copies a batch to its device,
unless a ``PrefetchingIter(device_put=True)`` has put it there already.
``MXDataIter`` raises, as in the JAX package.
"""
from __future__ import annotations

import gzip
import logging
import struct
import threading
import time
from collections import OrderedDict, namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import as_device, cpu
from .ndarray import NDArray
from .ndarray.sparse import CSRNDArray


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data description with dtype and layout (reference: io.py
    DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return (f"DataDesc[{self.name},{self.shape},{self.dtype},"
                f"{self.layout}]")

    @staticmethod
    def get_batch_axis(layout):
        """The batch axis of ``layout`` (0 when it is None)."""
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        """DataDescs from ``[(name, shape)]`` and ``[(name, dtype)]`` (or
        None: float32)."""
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One batch (reference: io.py DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be a list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be a list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [l.shape for l in self.label] if self.label else None
        return (f"{self.__class__.__name__}: data shapes: {data_shapes} "
                f"label shapes: {label_shapes}")


class DataIter:
    """Iterator protocol (reference: io.py DataIter)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


def _as_numpy(v):
    if isinstance(v, NDArray):
        return v.asnumpy()
    arr = np.asarray(v)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def _init_data(data, allow_empty, default_name):
    """{name: numpy array} in order (reference: io.py _init_data)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data must not be empty")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data must not be empty")
        if len(data) == 1:
            data = OrderedDict([(default_name, data[0])])
        else:
            data = OrderedDict([("_%d_%s" % (i, default_name), d)
                                for i, d in enumerate(data)])
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return [(k, _as_numpy(v)) for k, v in data.items()]


class NDArrayIter(DataIter):
    """In-memory iterator (reference: io.py NDArrayIter).

    ``shuffle`` permutes the rows once, with numpy's global generator
    (``np.random.shuffle``), so under the same ``np.random.seed`` the
    order is the JAX package's.  ``last_batch_handle``: ``pad`` (the
    last batch wraps around to the start and ``pad`` says how many rows
    are filler), ``discard`` (the incomplete batch is dropped) or
    ``roll_over`` (the last batch wraps around without filler count, and
    ``reset`` carries the overflow into the next epoch)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        if last_batch_handle not in ("pad", "discard", "roll_over"):
            raise ValueError("last_batch_handle must be pad|discard|"
                             f"roll_over, got {last_batch_handle!r}")
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            n = self.data[0][1].shape[0]
            n -= n % batch_size
            self.data = [(k, v[:n]) for k, v in self.data]
            self.label = [(k, v[:n]) for k, v in self.label]
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    def _descs(self, source):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in source]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def hard_reset(self):
        """Back to the first batch, ignoring ``roll_over``."""
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + \
                (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None,
                             provide_data=self.provide_data,
                             provide_label=self.provide_label)
        raise StopIteration

    def _getdata(self, source):
        if self.cursor >= self.num_data:
            raise RuntimeError("DataIter needs reset.")
        out = []
        for _, x in source:
            if self.cursor + self.batch_size <= self.num_data:
                sl = x[self.cursor:self.cursor + self.batch_size]
            else:
                pad = self.batch_size - self.num_data + self.cursor
                sl = np.concatenate([x[self.cursor:], x[:pad]], axis=0)
            out.append(NDArray(sl, ctx=cpu()))
        return out

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0



class ResizeIter(DataIter):
    """``size`` batches an epoch of ``data_iter``, which restarts when it
    runs out (reference: io.py ResizeIter)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class _ProducerError:
    """An exception of a prefetch worker, re-raised by the consumer's
    next ``next()``: a dead worker fails the epoch, never shortens it."""

    def __init__(self, exc):
        self.exc = exc


class PrefetchingIter(DataIter):
    """One worker thread an inner iterator fetches batch t+1 while the
    consumer works on batch t (reference: io.py PrefetchingIter).

    ``device_put=True`` adds the copy to the device to the worker: it
    stages each array of the batch in pinned host memory and copies it
    to ``device`` (default: the current context, ``gpu(0)``) on a side
    stream, without waiting, and records an event; the consumer's
    ``next()`` makes its current stream wait for that event (the host
    does not wait) and marks the arrays as used on that stream
    (``record_stream``), so the caching allocator does not hand their
    memory to a later copy while the consumer's work still reads it.  A
    failed copy, like any other exception of a worker, is raised by the
    consumer.  ``waits_ms`` holds the time the consumer blocked on the
    worker at each ``next()``."""

    def __init__(self, iters, rename_data=None, rename_label=None,
                 device_put=False, device=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        if self.n_iter == 0:
            raise MXNetError("PrefetchingIter: no iterator")
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self._device_put = device_put
        self._device = as_device(device) if device_put else None
        self._stream = (torch.cuda.Stream(self._device)
                        if device_put and self._device.type == "cuda"
                        else None)
        self.batch_size = getattr(iters[0], "batch_size", 0) or \
            self.provide_data[0][1][0]
        self.waits_ms = []
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = None
        self.next_batch = [None for _ in range(self.n_iter)]
        self.prefetch_threads = [
            threading.Thread(target=self._prefetch, args=(i,), daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def _prefetch(self, i):
        while True:
            self.data_taken[i].wait()
            if not self.started:
                break
            try:
                batch = self.iters[i].next()
                if self._device_put:
                    batch = self._transfer(batch)
                self.next_batch[i] = batch
            except StopIteration:
                self.next_batch[i] = None
            except BaseException as e:  # noqa: BLE001  crosses a thread
                self.next_batch[i] = _ProducerError(e)
            self.data_taken[i].clear()
            self.data_ready[i].set()

    def _transfer(self, batch):
        """The batch's arrays on the target device (runs in the worker):
        pinned staging and a copy on the side stream, with an event the
        consumer waits on."""
        dev, stream = self._device, self._stream

        def put(arrs):
            if arrs is None:
                return None
            out = []
            for a in arrs:
                t = a._data if isinstance(a, NDArray) else torch.as_tensor(a)
                if stream is not None and t.device.type == "cpu":
                    t = t.pin_memory()
                out.append(NDArray(t.to(dev, non_blocking=True)))
            return out

        if stream is None:
            return DataBatch(put(batch.data), put(batch.label),
                             pad=batch.pad, index=batch.index,
                             provide_data=batch.provide_data,
                             provide_label=batch.provide_label)
        with torch.cuda.stream(stream):
            out = DataBatch(put(batch.data), put(batch.label),
                            pad=batch.pad, index=batch.index,
                            provide_data=batch.provide_data,
                            provide_label=batch.provide_label)
            out._copied = torch.cuda.Event()
            out._copied.record(stream)
        return out

    def _take(self, batch):
        """Order the consumer's stream after the batch's copy."""
        ev = getattr(batch, "_copied", None)
        if ev is None:
            return
        cur = torch.cuda.current_stream(self._device)
        cur.wait_event(ev)
        for a in (batch.data or []) + (batch.label or []):
            a._data.record_stream(cur)

    def close(self):
        """Stop the worker threads."""
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=1.0)

    def __del__(self):
        if getattr(self, "prefetch_threads", None):
            self.close()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_data]
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[DataDesc(r[x.name], x.shape, x.dtype)
                     if isinstance(x, DataDesc) else DataDesc(*x)
                     for x in i.provide_label]
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        t0 = time.perf_counter()
        for e in self.data_ready:
            e.wait()
        self.waits_ms.append((time.perf_counter() - t0) * 1e3)
        for batch in self.next_batch:
            if isinstance(batch, _ProducerError):
                # left parked: every later next() raises again
                raise MXNetError("PrefetchingIter: prefetch worker failed: "
                                 f"{batch.exc!r}") from batch.exc
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise MXNetError("PrefetchingIter: the iterators differ "
                                 "in length")
            return False
        for batch in self.next_batch:
            if batch.pad != self.next_batch[0].pad:
                raise MXNetError("PrefetchingIter: different pad sizes in "
                                 "the data batches")
            self._take(batch)
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], [])
            if self.next_batch[0].label is not None else None,
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data,
            provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class KBatchIter(DataIter):
    """K consecutive batches of an inner iterator stacked into one batch
    with a leading step axis, ``(k, batch, ...)``: the input of
    ``Module.run_steps`` (reference: the JAX package's KBatchIter).  A
    last group of fewer than K batches is dropped (``last_group=
    'discard'``) or yielded short (``'keep'``)."""

    def __init__(self, data_iter, k, last_group="discard"):
        super().__init__()
        if k < 1:
            raise MXNetError(f"KBatchIter: k must be >= 1, got {k}")
        if last_group not in ("discard", "keep"):
            raise MXNetError("KBatchIter: last_group must be 'discard' "
                             "or 'keep'")
        self.data_iter = data_iter
        self.k = k
        self.last_group = last_group
        self.batch_size = data_iter.batch_size

    def _k_provide(self, descs, k=None):
        k = self.k if k is None else k
        return [DataDesc(d.name, (k,) + tuple(d.shape),
                         getattr(d, "dtype", np.float32)) for d in descs]

    @property
    def provide_data(self):
        return self._k_provide(self.data_iter.provide_data)

    @property
    def provide_label(self):
        return self._k_provide(self.data_iter.provide_label)

    def reset(self):
        self.data_iter.reset()

    def next(self):
        batches = []
        for _ in range(self.k):
            try:
                batches.append(self.data_iter.next())
            except StopIteration:
                break
        if not batches or (len(batches) < self.k
                           and self.last_group == "discard"):
            raise StopIteration

        def stack(get):
            return [NDArray(np.stack([get(b)[i].asnumpy() for b in batches]),
                            ctx=cpu())
                    for i in range(len(get(batches[0])))]

        data = stack(lambda b: b.data)
        label = stack(lambda b: b.label) if batches[0].label else None
        kk = len(batches)
        return DataBatch(
            data, label, pad=batches[-1].pad,
            provide_data=self._k_provide(self.data_iter.provide_data, kk),
            provide_label=self._k_provide(self.data_iter.provide_label, kk))


class _InnerIter(DataIter):
    """An iterator that serves the batches of an inner NDArrayIter."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()

    def iter_next(self):
        return self._inner.iter_next()

    def getdata(self):
        return self._inner.getdata()

    def getlabel(self):
        return self._inner.getlabel()

    def getpad(self):
        return self._inner.getpad()


class CSVIter(_InnerIter):
    """Rows of a CSV file, reshaped to ``data_shape``, with the labels
    of ``label_csv`` (zeros without one); ``round_batch`` wraps the last
    batch around, else it is dropped (reference: src/io/io.cc CSVIter)."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=dtype, ndmin=2)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype,
                               ndmin=2)
            label = label.reshape((-1,) + tuple(label_shape))
            if tuple(label_shape) == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros((data.shape[0],), dtype=dtype)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="roll_over" if round_batch else "discard",
            data_name="data", label_name="label")


def _read_idx(path):
    """An IDX file (MNIST's container; gzip when it ends in .gz) as a
    numpy array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read()
    zero, dtype_code, ndim = struct.unpack(">HBB", raw[:4])
    if zero != 0:
        raise MXNetError(f"{path}: not an IDX file")
    dims = struct.unpack(">" + "I" * ndim, raw[4:4 + 4 * ndim])
    dtypes = {0x08: np.uint8, 0x09: np.int8, 0x0B: np.dtype(">i2"),
              0x0C: np.dtype(">i4"), 0x0D: np.dtype(">f4"),
              0x0E: np.dtype(">f8")}
    return np.frombuffer(raw, dtypes[dtype_code],
                         offset=4 + 4 * ndim).reshape(dims)


class MNISTIter(_InnerIter):
    """MNIST's IDX files: images scaled to [0, 1], (1, 28, 28) or flat,
    optionally shuffled by ``seed`` and cut to part ``part_index`` of
    ``num_parts`` (reference: src/io/iter_mnist.cc)."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, silent=False, seed=0,
                 part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        imgs = _read_idx(image).astype(np.float32) / 255.0
        labs = _read_idx(label).astype(np.float32)
        if num_parts > 1:
            n = len(imgs) // num_parts
            imgs = imgs[part_index * n:(part_index + 1) * n]
            labs = labs[part_index * n:(part_index + 1) * n]
        if shuffle:
            order = np.random.RandomState(seed).permutation(len(imgs))
            imgs, labs = imgs[order], labs[order]
        imgs = imgs.reshape(len(imgs), -1) if flat else \
            imgs.reshape(len(imgs), 1, imgs.shape[1], imgs.shape[2])
        if not silent:
            logging.info("MNISTIter: loaded %d images shape %s", len(imgs),
                         imgs.shape[1:])
        self._inner = NDArrayIter(imgs, labs, batch_size=batch_size,
                                  shuffle=False)


class LibSVMIter(DataIter):
    """A LibSVM text file (``label index:value ...``; a separate
    ``label_libsvm`` gives the labels by its first column), in batches
    of ``data_shape`` features; ``round_batch`` wraps the last batch
    around (reference: src/io/iter_libsvm.cc).  The features come as a
    CSRNDArray on the CPU, O(nnz), with the JAX package's data, indices,
    indptr and pad (JAX ``io.py:655-737``): ``csr.dot`` reads it as it
    is, and ``as_in_context`` moves its parts to a device."""

    @staticmethod
    def _parse_libsvm(path):
        labels, rows_data, rows_idx = [], [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                idx, vals = [], []
                for tok in parts[1:]:
                    k, v = tok.split(":")
                    idx.append(int(k))
                    vals.append(float(v))
                rows_idx.append(np.asarray(idx, np.int64))
                rows_data.append(np.asarray(vals, np.float32))
        return labels, rows_data, rows_idx

    def __init__(self, data_libsvm, data_shape, batch_size=1,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 part_index=0, num_parts=1, **kwargs):
        super().__init__(batch_size)
        ncol = int(np.prod(data_shape))
        labels, rows_data, rows_idx = self._parse_libsvm(data_libsvm)
        if label_libsvm is not None:
            labels, _, _ = self._parse_libsvm(label_libsvm)
        if num_parts > 1:
            n = len(labels) // num_parts
            sl = slice(part_index * n, (part_index + 1) * n)
            labels, rows_data, rows_idx = \
                labels[sl], rows_data[sl], rows_idx[sl]
        self._labels = np.asarray(labels, np.float32)
        self._rows_data = rows_data
        self._rows_idx = rows_idx
        self._ncol = ncol
        self.round_batch = round_batch
        self.provide_data = [DataDesc("data", (batch_size, ncol))]
        self.provide_label = [DataDesc("label", (batch_size,))]
        self._cursor = 0

    def reset(self):
        self._cursor = 0

    def next(self):
        n = len(self._labels)
        if self._cursor >= n:
            raise StopIteration
        take = list(range(self._cursor,
                          min(self._cursor + self.batch_size, n)))
        short = self.batch_size - len(take)
        if short:
            if not self.round_batch:
                raise StopIteration
            take += list(range(short))
        self._cursor += self.batch_size
        rdat = [self._rows_data[i] for i in take]
        ridx = [self._rows_idx[i] for i in take]
        data = np.concatenate(rdat) if any(len(r) for r in rdat) else \
            np.zeros((0,), np.float32)
        indices = np.concatenate(ridx) if any(len(r) for r in ridx) else \
            np.zeros((0,), np.int64)
        indptr = np.zeros(self.batch_size + 1, np.int64)
        np.cumsum([len(r) for r in ridx], out=indptr[1:])
        csr = CSRNDArray(data, indices, indptr,
                         (self.batch_size, self._ncol), ctx=cpu())
        return DataBatch([csr],
                         [NDArray(self._labels[take], ctx=cpu())],
                         pad=short, provide_data=self.provide_data,
                         provide_label=self.provide_label)


class MXDataIter(DataIter):
    """The reference's iterators of the C++ engine: not a class of this
    package (as in the JAX package); use NDArrayIter or the file
    iterators above."""

    def __init__(self, *a, **kw):
        raise MXNetError("MXDataIter: use NDArrayIter, CSVIter, MNISTIter "
                         "or LibSVMIter")
