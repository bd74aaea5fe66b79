"""Gluon utilities (reference: python/mxnet/gluon/utils.py).

PyTorch counterpart of ``mxnet_tpu/gluon/utils.py``; ``download`` reads
only a file that is already there, as the JAX package's does.
"""
from __future__ import annotations

import math

import numpy as np

from ..base import MXNetError
from ..ndarray import NDArray
from ..ndarray.ndarray import array as nd_array


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split along batch_axis into num_slice chunks
    (reference: utils.py:28)."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            f"Too many slices ({num_slice}) for data with shape "
            f"{data.shape}")
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}. "
            f"Use a batch size that's a multiple of {num_slice} or set "
            f"even_split=False")
    step = size // num_slice
    slices = []
    for i in range(num_slice):
        lo = i * step
        hi = (i + 1) * step if i < num_slice - 1 else size
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(lo, hi)
        slices.append(data[tuple(idx)])
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """Split data into len(ctx_list) slices and load one per context
    (reference: utils.py:81)."""
    if not isinstance(data, NDArray):
        data = nd_array(data)
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale arrays so the global L2 norm <= max_norm
    (reference: utils.py:117)."""
    assert len(arrays) > 0
    total = 0.0
    for arr in arrays:
        n = arr.norm().asscalar()
        total += float(n) ** 2
    total = math.sqrt(total)
    if not np.isfinite(total):
        import warnings
        warnings.warn(UserWarning('nan or inf is detected. Clipping '
                                  'results will be undefined.'),
                      stacklevel=2)
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total


def check_sha1(filename, sha1_hash):
    """reference: utils.py check_sha1."""
    import hashlib
    sha1 = hashlib.sha1()
    with open(filename, 'rb') as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """reference: utils.py download — kept for API parity; it fetches
    nothing, so a missing local file is an error."""
    import os
    fname = path if path and not os.path.isdir(path) else \
        os.path.join(path or '.', url.split('/')[-1])
    if os.path.exists(fname) and not overwrite and (
            not sha1_hash or check_sha1(fname, sha1_hash)):
        return fname
    raise MXNetError(
        f"download({url!r}): this package fetches nothing and "
        f"{fname!r} does not exist locally. Place the file there manually.")
