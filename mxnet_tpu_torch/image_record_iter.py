"""ImageRecordIter and ImageRecordUInt8Iter: image-record iterators.

PyTorch counterpart of ``mxnet_tpu/image_record_iter.py`` (reference:
src/io/iter_image_recordio_2.cc, registered in src/io/io.cc:337), with
the JAX package's arguments, batches and random draws: a
``np.random.RandomState(seed)`` shuffles the order at each ``reset()``
and, batch by batch, draws the crop offsets (vectorized, only where a
crop happens) and then the mirror flips.  A producer thread, bounded by
``prefetch_buffer``, prepares the batches; an exception there is raised
by the consumer's next ``next()``.

Where the batches are made follows ``device`` (default: the current
context, ``gpu(0)``):

- on the card, the records are read from the memory-mapped file, their
  JPEGs decoded by nvJPEG (the H100's JPEG engines where they take the
  image, ``image/nvjpeg.py``) into card memory at their own sizes, and
  resized, cropped, mirrored and normalized by the hand-written kernel
  I1 (``ops/image_augment.py``, ``csrc/image_augment.cu``), all on the
  iterator's side stream; ``next()`` orders the caller's stream after
  the batch by an event and marks its memory as used there
  (``record_stream``);
- with ``device=cpu()``, through the host library
  (``native/jpeg_io.cc``, libjpeg), the same code as the JAX package's,
  so the batches equal its batches.

Nothing falls back from one to the other: a decoder or kernel that does
not build or launch raises.  Decoded at full size on the card, an image
at least twice the decode size in both dimensions is reduced in the DCT
domain on the host first (``jpeg_io.cc decode_one``), so there the two
paths' pixels differ by more than the decoders' few levels.
"""
from __future__ import annotations

import logging
import os
import queue
import threading
import time

import numpy as np
import torch

from .base import MXNetError, env
from .context import as_device
from .io import DataBatch, DataDesc, DataIter, _ProducerError
from .ndarray import NDArray
from . import native
from . import recordio


class ImageRecordIter(DataIter):
    """reference: the parameters of src/io/image_rec_parser and the
    augmenters' (image_aug_default.cc).  ``decode_failures`` counts the
    images that did not decode (zero-filled); on the card,
    ``decoder.backend_counts`` says which nvJPEG backend decoded how many
    images and ``wait_ms`` holds the consumer's wait at each batch."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_width=1, shuffle=False, mean_r=0.0, mean_g=0.0,
                 mean_b=0.0, std_r=1.0, std_g=1.0, std_b=1.0,
                 rand_mirror=False, rand_crop=False, resize=-1,
                 part_index=0, num_parts=1, round_batch=True,
                 preprocess_threads=None, prefetch_buffer=2, seed=0,
                 data_name='data', label_name='softmax_label',
                 device_prefetch=False, device=None, **kwargs):
        super().__init__(batch_size)
        # device_prefetch: hold one batch in flight, so that next()
        # returns batch t with batch t+1 already under way, and a failure
        # of t+1 is raised at the call after (as the JAX package does)
        self._device_prefetch = device_prefetch
        self._dev = as_device(device)
        self._dev_next = None
        self._dev_err = None
        if not os.path.exists(path_imgrec):
            raise MXNetError(f"record file not found: {path_imgrec}")
        self.path = path_imgrec
        self.data_shape = tuple(data_shape)
        assert len(self.data_shape) == 3, "data_shape must be (C, H, W)"
        self.batch_size = batch_size
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_mirror = rand_mirror
        self.rand_crop = rand_crop
        self.resize = resize
        self.round_batch = round_batch
        self._rng = np.random.RandomState(seed)
        self.mean = np.array([mean_r, mean_g, mean_b],
                             np.float32).reshape(3, 1, 1)
        self.std = np.array([std_r, std_g, std_b],
                            np.float32).reshape(3, 1, 1)
        self.nthreads = preprocess_threads or \
            env("MXNET_CPU_WORKER_NTHREADS", os.cpu_count() or 4)
        self.decode_failures = 0
        self.wait_ms = []
        self._card = self._dev.type == "cuda"
        self._stream = None
        self.decoder = None
        if self._card:
            self._stream = torch.cuda.Stream(self._dev)
            self.decoder = self._make_decoder()
        offsets = native.index_rec_file(path_imgrec)
        # shard for this worker (reference: dmlc InputSplit partitioning)
        if num_parts > 1:
            n = len(offsets)
            c = n // num_parts
            offsets = offsets[part_index * c:(part_index + 1) * c]
        self._offsets = np.asarray(offsets, dtype=np.int64)
        self._order = np.arange(len(self._offsets))

        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(
            label_name, (batch_size, label_width) if label_width > 1
            else (batch_size,))]

        self._prefetch_n = prefetch_buffer
        self._queue = None
        self._worker = None
        self._stop = threading.Event()
        self.reset()

    def _make_decoder(self):
        from .image import nvjpeg
        return nvjpeg.Decoder(self._dev)

    # -- pipeline ----------------------------------------------------------
    def _read(self, idxs):
        """The records at ``idxs``: (label rows (n, label_width) float32,
        payloads)."""
        raws = native.read_records(self.path, self._offsets[idxs])
        labels = np.zeros((len(raws), self.label_width), np.float32)
        payloads = []
        for i, raw in enumerate(raws):
            header, img = recordio.unpack(raw)
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            labels[i, :min(self.label_width, lab.size)] = \
                lab[:self.label_width]
            payloads.append(img)
        return labels, payloads

    def _crops(self, nimg, dec_h, dec_w, h, w):
        """Crop offsets and flips, drawn as the JAX package draws them:
        offsets first, and only where a crop happens, then the flips."""
        if (dec_h != h or dec_w != w) and self.rand_crop:
            y0 = self._rng.randint(0, dec_h - h + 1, nimg)
            x0 = self._rng.randint(0, dec_w - w + 1, nimg)
        else:
            y0 = np.full(nimg, (dec_h - h) // 2, np.int32)
            x0 = np.full(nimg, (dec_w - w) // 2, np.int32)
        flips = (self._rng.rand(nimg) < 0.5 if self.rand_mirror
                 else np.zeros(nimg, bool))
        return y0, x0, flips

    def _decode(self, jpegs, c):
        """The JPEGs decoded on the card (on the current stream)."""
        images, fails = self.decoder.decode(jpegs, c)
        if fails:
            logging.debug("%d corrupt images zero-filled", fails)
        self.decode_failures += fails
        return images

    def _load_batch(self, idxs):
        labels, jpegs = self._read(idxs)
        c, h, w = self.data_shape
        # decode size covers the crop: with resize set, (>= resize, aspect
        # not kept, as in the JAX package) but never below (h, w)
        dec_h = max(h, self.resize) if self.resize > 0 else h
        dec_w = max(w, self.resize) if self.resize > 0 else w
        y0, x0, flips = self._crops(len(jpegs), dec_h, dec_w, h, w)
        labels = labels[:, 0] if self.label_width == 1 else labels
        mean, std = self.mean.ravel()[:c], self.std.ravel()[:c]
        if not self._card:
            arr, fails = native.decode_augment_batch(
                jpegs, dec_h, dec_w, h, w, y0, x0, flips, mean, std, c,
                self.nthreads)
            if fails:
                logging.debug("%d corrupt images zero-filled", fails)
            self.decode_failures += fails
            return arr, labels
        from .ops.image_augment import augment
        images = self._decode(jpegs, c)
        # normalized as the fused host path normalizes: (v - mean) * 1/std
        arr = augment(images, y0, x0, flips, (dec_h, dec_w), (h, w), mean,
                      std)
        return arr, labels

    def _produce(self, idxs):
        """One batch: on the card made on the side stream, with an event
        recorded after it."""
        if not self._card:
            return self._load_batch(idxs) + (None,)
        with torch.cuda.device(self._dev), torch.cuda.stream(self._stream):
            arr, labels = self._load_batch(idxs)
            labels = torch.from_numpy(np.ascontiguousarray(labels)) \
                .pin_memory().to(self._dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        return arr, labels, done

    def _producer(self, order, out_queue, stop):
        # queue and stop passed by value: a worker outliving reset() talks
        # to its own epoch's queue, never the next one's
        try:
            n = len(order)
            for start in range(0, n - self.batch_size + 1,
                               self.batch_size):
                if stop.is_set():
                    return
                idxs = order[start:start + self.batch_size]
                out_queue.put(self._produce(idxs) + (0,))
            rem = n % self.batch_size
            if rem and self.round_batch:
                # wrap around to fill the last batch (reference:
                # round_batch pads from the epoch's start); a file smaller
                # than a batch tiles cyclically
                idxs = np.concatenate([order[n - rem:],
                                       order[np.arange(
                                           self.batch_size - rem) % n]])
                out_queue.put(self._produce(idxs) +
                              (self.batch_size - rem,))
        except BaseException as e:  # noqa: BLE001  crosses a thread
            # raised by the consumer: a bad record fails the epoch, it
            # does not shorten it
            out_queue.put(_ProducerError(e))
        finally:
            out_queue.put(None)

    def reset(self):
        self._stop.set()
        if self._worker is not None:
            try:
                while self._queue.get_nowait() is not None:
                    pass
            except queue.Empty:
                pass
            self._worker.join(timeout=5)
            if self._worker.is_alive():
                logging.warning(
                    "ImageRecordIter.reset: previous prefetch worker did "
                    "not stop within 5s (stuck in decode or IO?); "
                    "leaking the daemon thread")
        self._stop = threading.Event()
        self._done = False
        self._dev_next = None
        self._dev_err = None
        order = self._order.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        self._queue = queue.Queue(maxsize=self._prefetch_n)
        self._worker = threading.Thread(
            target=self._producer, args=(order, self._queue, self._stop),
            daemon=True)
        self._worker.start()

    def _next_item(self):
        if self._done:
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=1.0)
                break
            except queue.Empty:
                # the producer posts its sentinel even when it fails: an
                # empty queue with a dead worker means it was killed
                if self._worker is not None and not self._worker.is_alive():
                    self._done = True
                    raise MXNetError(
                        "ImageRecordIter: prefetch worker died without "
                        "reporting a result; cannot continue the epoch")
        if item is None:
            self._done = True
            raise StopIteration
        if isinstance(item, _ProducerError):
            self._done = True
            raise MXNetError(
                "ImageRecordIter pipeline failed in the prefetch thread: "
                "%r" % (item.exc,)) from item.exc
        return item

    def next_raw(self):
        """The next batch as (data, label, pad), without an NDArray wrap:
        numpy arrays from the host path, tensors on the card (the caller's
        current stream already ordered after them)."""
        t0 = time.perf_counter()
        data, label, done, pad = self._next_item()
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        if done is not None:
            cur = torch.cuda.current_stream(self._dev)
            cur.wait_event(done)
            data.record_stream(cur)
            label.record_stream(cur)
        return data, label, pad

    def _batch(self):
        data, label, pad = self.next_raw()
        return DataBatch([NDArray(data)], [NDArray(label)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self):
        if self._device_prefetch:
            if self._dev_err is not None:
                err, self._dev_err = self._dev_err, None
                raise err
            cur = self._dev_next
            if cur is None:
                cur = self._batch()
            try:
                self._dev_next = self._batch()
            except StopIteration:
                self._dev_next = None
            except Exception as e:  # noqa: BLE001  batch t is good: give
                # it, and raise t+1's failure at the next call
                self._dev_next = None
                self._dev_err = e
            return cur
        return self._batch()


class ImageRecordUInt8Iter(ImageRecordIter):
    """Raw HWC uint8 records, no JPEG decode (reference:
    ImageRecordUInt8Iter, src/io/io.cc:337-758): crop, mirror and NCHW
    (or NHWC) uint8 batches.  Normalization belongs to the network (its
    input BatchNorm), so mean and std other than the identity raise, as
    in the JAX package.  On the card the records are copied to card
    memory once a batch and I1 crops and mirrors them; with
    ``device=cpu()`` the host library does."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 stored_shape=None, output_layout="NCHW", **kwargs):
        identity = {"mean_r": 0.0, "mean_g": 0.0, "mean_b": 0.0,
                    "std_r": 1.0, "std_g": 1.0, "std_b": 1.0}
        for k, ident in identity.items():
            v = kwargs.pop(k, None)
            if v is not None and float(v) != ident:
                raise MXNetError(
                    "ImageRecordUInt8Iter outputs raw uint8; apply "
                    "mean/std on device (it fuses into the step)")
        if output_layout not in ("NCHW", "NHWC"):
            raise MXNetError(
                f"output_layout must be NCHW or NHWC, got {output_layout}")
        self._output_layout = output_layout
        self._stored_shape = tuple(stored_shape) if stored_shape else None
        super().__init__(path_imgrec, data_shape, batch_size, **kwargs)
        if output_layout == "NHWC":
            c, h, w = self.data_shape
            self.provide_data = [DataDesc(self.provide_data[0].name,
                                          (batch_size, h, w, c),
                                          dtype=np.uint8, layout="NHWC")]

    def _make_decoder(self):
        return None

    def _infer_stored_shape(self, payload_len):
        c = self.data_shape[0]
        if payload_len % c:
            raise MXNetError(
                f"raw record payload {payload_len} not divisible by "
                f"channels {c}")
        side = int(round((payload_len // c) ** 0.5))
        if side * side * c != payload_len:
            raise MXNetError(
                f"raw record payload {payload_len} is not square; pass "
                f"stored_shape=(H, W)")
        return (side, side)

    def _load_batch(self, idxs):
        labels, payloads = self._read(idxs)
        c, h, w = self.data_shape
        if self._stored_shape is None:
            self._stored_shape = self._infer_stored_shape(len(payloads[0]))
        dh, dw = self._stored_shape
        y0, x0, flips = self._crops(len(payloads), dh, dw, h, w)
        labels = labels[:, 0] if self.label_width == 1 else labels
        nhwc = self._output_layout == "NHWC"
        if not self._card:
            fn = native.crop_flip_u8_nhwc_batch if nhwc \
                else native.crop_flip_u8_batch
            return fn(payloads, dh, dw, h, w, y0, x0, flips, c,
                      self.nthreads), labels
        from .ops.image_augment import DecodedImages, augment
        arrs = native.check_raw(payloads, dh, dw, c)
        host = torch.from_numpy(np.concatenate(arrs)).pin_memory()
        flat = host.to(self._dev, non_blocking=True)
        n = len(arrs)
        images = DecodedImages(flat, np.arange(n) * (dh * dw * c),
                               np.full(n, dh), np.full(n, dw), c)
        arr = augment(images, y0, x0, flips, (dh, dw), (h, w), out="uint8",
                      layout="NHWC" if nhwc else "NCHW")
        return arr, labels
