"""Seeded record files for the data-IO tests of the port (not collected;
imported by ``tests/test_torch_recordio.py``, ``test_torch_image*.py``
and ``test_torch_image_record_iter.py``).

Images are a smooth field plus noise, as photographs are neither flat nor
white noise, so their JPEGs exercise the decoders' smoothing and rounding;
every file is written by the JAX package's writer unless a test says
otherwise, so that both packages read the same bytes."""
import fcntl
import os
import tempfile
import time

import numpy as np

import mxnet_tpu as mx
from mxnet_tpu import native as jnative


def jax_native():
    """Load the JAX package's native library, which its first use builds
    with ``make`` in place: under a lock shared by the xdist workers of
    a run, and again where a build running at once in a JAX-package test
    left a file that did not load (``get_lib`` then caches None, and the
    JAX iterators would take their PIL path)."""
    lock = os.path.join(tempfile.gettempdir(), "mxnet_tpu_native.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for _ in range(5):
            if jnative.get_lib() is not None:
                return
            jnative._tried, jnative._lib = False, None
            time.sleep(2)
    raise RuntimeError("the JAX package's native library does not load")


def images(n, shape=(48, 40), seed=0, channels=3, vary=True):
    """``n`` uint8 HWC images; with ``vary`` the sizes step around
    ``shape`` (heights and widths up to 7 pixels more)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        h = shape[0] + (i * 3) % 8 if vary else shape[0]
        w = shape[1] + (i * 5) % 8 if vary else shape[1]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        field = np.stack([np.sin(yy / (3 + c) + i) * np.cos(xx / (4 + c))
                          for c in range(channels)], -1)
        img = 128 + 80 * field + rng.randn(h, w, channels) * 20
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def write_jpeg(path, imgs, labels=None, quality=90, idx=True,
               corrupt=()):
    """A JPEG record file (and its .idx) of ``imgs``, label i % 7 or
    ``labels[i]``; the records at ``corrupt`` hold bytes no decoder
    reads."""
    rec = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w") \
        if idx else mx.recordio.MXRecordIO(path, "w")
    for i, img in enumerate(imgs):
        label = float(i % 7) if labels is None else labels[i]
        header = mx.recordio.IRHeader(0, label, i, 0)
        if i in corrupt:
            payload = mx.recordio.pack(header, b"\xff\xd8not a jpeg" * 9)
        else:
            arr = img[:, :, 0] if img.shape[2] == 1 else img
            payload = mx.recordio.pack_img(header, arr, quality=quality)
        if idx:
            rec.write_idx(i, payload)
        else:
            rec.write(payload)
    rec.close()
    return path


def write_raw(path, n, shape=(40, 40), channels=3, seed=5):
    """A record file of raw HWC uint8 payloads; returns the images."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (n,) + tuple(shape) + (channels,),
                       dtype=np.uint8)
    rec = mx.recordio.MXIndexedRecordIO(path[:-4] + ".idx", path, "w")
    for i in range(n):
        rec.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i), i, 0), imgs[i].tobytes()))
    rec.close()
    return imgs


def batches(it, epochs=1):
    """Every batch of ``epochs`` passes: (data, label, pad) as numpy."""
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out
