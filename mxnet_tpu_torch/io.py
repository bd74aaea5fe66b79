"""Data iterators (subset).

PyTorch counterpart of the part of ``mxnet_tpu/io.py`` that training
through ``Module`` runs: ``DataDesc``, ``DataBatch``, ``DataIter`` and the
in-memory ``NDArrayIter``.  Iterators are host-side: ``NDArrayIter``
slices numpy masters and yields NDArrays on the CPU in the dtype it was
given (int32 token ids stay int32); ``Module.forward`` copies a batch to
its device.
"""
from __future__ import annotations

from collections import OrderedDict, namedtuple

import numpy as np

from .context import cpu
from .ndarray import NDArray


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
