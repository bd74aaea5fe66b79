"""NDArray files (reference: NDArray::Save/Load, ndarray.cc:826,939).

PyTorch counterpart of ``mxnet_tpu/serialization.py``, byte for byte the
same format, so a file written by either package loads in the other.
Format ``MXTPU001``: 8-byte magic, uint64 little-endian header length, a
JSON header (a list of {name, dtype, shape, offset, nbytes}), then the
raw buffers in the host's byte order (little-endian on every host either
package runs on).  A list is saved with empty names, a dict
with its keys.  bfloat16, which numpy lacks, is stored raw under the
dtype name ``bfloat16``.  ``.params`` files of ``model.save_checkpoint``
use the same container with ``arg:`` / ``aux:`` name prefixes.  A file
in the reference MXNet's own format (``NDArray::Save``'s container) is
read by :mod:`compat_serialization`, as the JAX package's
``serialization.py:75-76`` routes it.
"""
from __future__ import annotations

import json
import struct
from typing import Dict, List, Union

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

_MAGIC = b"MXTPU001"


def _raw(t: torch.Tensor):
    """(dtype name, raw bytes) of a tensor."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return "bfloat16", t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return str(a.dtype), a.tobytes()


def _tensor(blob: bytes, dtype: str, shape, offset: int) -> torch.Tensor:
    count = int(np.prod(shape)) if shape else 1
    if dtype == "bfloat16":
        a = np.frombuffer(blob, dtype=np.int16, count=count, offset=offset)
        return torch.from_numpy(a.copy()).view(torch.bfloat16).reshape(shape)
    a = np.frombuffer(blob, dtype=np.dtype(dtype), count=count, offset=offset)
    return torch.from_numpy(a.copy().reshape(shape))


def save_ndarrays(fname: str, data) -> None:
    """Write an NDArray, a list of them or a dict of them to ``fname``."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        items = list(data.items())
    elif isinstance(data, (list, tuple)):
        items = [("", v) for v in data]
    else:
        raise MXNetError("save: data must be NDArray, list, or dict")
    header: List[dict] = []
    bufs: List[bytes] = []
    offset = 0
    for name, arr in items:
        if not isinstance(arr, NDArray):
            raise MXNetError(f"save: value for {name!r} is not an NDArray")
        dtype, raw = _raw(arr._data)
        header.append({"name": name, "dtype": dtype,
                       "shape": list(arr.shape), "offset": offset,
                       "nbytes": len(raw)})
        bufs.append(raw)
        offset += len(raw)
    hjson = json.dumps(header).encode()
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for raw in bufs:
            f.write(raw)


def load_ndarrays(fname: str) -> Union[List[NDArray], Dict[str, NDArray]]:
    """The list or dict saved in ``fname``, as NDArrays on the CPU."""
    with open(fname, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            # a file the reference MXNet wrote (kMXAPINDArrayListMagic,
            # ndarray.cc:1022): migrating users load it as it is
            from . import compat_serialization as compat
            if compat.is_reference_format(fname):
                return compat.load_reference_params(fname)
            raise MXNetError(f"{fname}: not an mxnet_tpu NDArray file (bad "
                             f"magic {magic!r})")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        blob = f.read()
    out = [(ent["name"], NDArray(_tensor(blob, ent["dtype"], ent["shape"],
                                         ent["offset"])))
           for ent in header]
    if all(n == "" for n, _ in out):
        return [a for _, a in out]
    return {n: a for n, a in out}

