"""The reference MXNet's own ``.params`` files: read and write the
dmlc::Stream NDArray container.

PyTorch counterpart of ``mxnet_tpu/compat_serialization.py``, the same
bytes both ways: a user migrating from the reference brings checkpoints
written by its ``mx.nd.save`` / ``save_checkpoint``; this module loads
them (``nd.load``, ``model.load_checkpoint`` and ``Module.load`` route
here when a file is in this format) and writes them back, so the
original implementation loads what the port saves.  Proven against the
reference's own fixture ``tests/golden/legacy_ndarray.v0``.

Layout (little-endian; reference: src/ndarray/ndarray.cc:1022-1050
``NDArray::Save(fo, data, names)``):

  uint64 0x112 (kMXAPINDArrayListMagic), uint64 reserved=0,
  uint64 n_arrays, n x <NDArray>, uint64 n_names, n x (uint64 len, bytes)

Per NDArray (ndarray.cc:826-1010):
  V2 (magic 0xF993FAC9): int32 stype (0 dense / 1 row_sparse / 2 csr);
      [sparse: storage TShape]; TShape shape (uint32 ndim + int64 dims);
      Context (int32 dev_type, int32 dev_id); int32 type_flag (mshadow:
      0 f32, 1 f64, 2 f16, 3 u8, 4 i32, 5 i8, 6 i64); [sparse: per-aux
      int32 type + TShape]; raw data; [sparse: aux arrays].
  V1 (magic 0xF993FAC8): shape (uint32 ndim + int64 dims), Context,
      type_flag, raw data (ndarray.cc:892-931 LegacyLoad).
  V0: the leading uint32 IS ndim, dims are uint32, then Context, type,
      data.

Arrays load on the CPU (as :func:`serialization.load_ndarrays` does);
row-sparse and CSR entries load into the port's
``RowSparseNDArray`` / ``CSRNDArray``.  bfloat16, which the 2017 format
lacks, is widened to float32 on save (exact for every bf16 value).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Union

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

# mshadow TypeFlag (mshadow/base.h) <-> numpy
_TYPE_FLAGS = {0: np.float32, 1: np.float64, 2: np.float16,
               3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_FLAG_OF = {np.dtype(v): k for k, v in _TYPE_FLAGS.items()}


class _Reader:
    def __init__(self, buf):
        self.b = buf
        self.o = 0

    def take(self, n):
        if self.o + n > len(self.b):
            raise MXNetError("reference .params: truncated file")
        out = self.b[self.o:self.o + n]
        self.o += n
        return out

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]


def _read_tshape(r, ndim=None, dim64=True):
    if ndim is None:
        ndim = r.u32()
    fmt, sz = ("<q", 8) if dim64 else ("<I", 4)
    return tuple(struct.unpack(fmt, r.take(sz))[0] for _ in range(ndim))


def _read_context(r):
    r.i32()  # dev_type: every array loads on the CPU
    r.i32()  # dev_id


def _read_array_data(r, shape, flag):
    if flag not in _TYPE_FLAGS:
        raise MXNetError(f"reference .params: unknown type flag {flag}")
    dt = np.dtype(_TYPE_FLAGS[flag])
    n = int(np.prod(shape)) if shape else 1
    raw = r.take(n * dt.itemsize)
    return torch.from_numpy(np.frombuffer(raw, dtype=dt).reshape(shape)
                            .copy())


def _empty():
    return NDArray(torch.zeros((), dtype=torch.float32))


def _read_one(r):
    magic = r.u32()
    if magic == _V2_MAGIC:
        stype = r.i32()
        nad = {0: 0, 1: 1, 2: 2}.get(stype)
        if nad is None:
            raise MXNetError(
                f"reference .params: unknown storage type {stype}")
        sshape = _read_tshape(r) if nad else None
        shape = _read_tshape(r)
        if len(shape) == 0:
            return _empty()
        _read_context(r)
        flag = r.i32()
        aux = [(r.i32(), _read_tshape(r)) for _ in range(nad)]
        data = _read_array_data(r, sshape if nad else shape, flag)
        aux_arrays = [_read_array_data(r, ashape, aflag)
                      for aflag, ashape in aux]
        if nad == 0:
            return NDArray(data)
        return _to_sparse(stype, shape, data, aux_arrays)
    if magic == _V1_MAGIC:
        shape = _read_tshape(r)
    else:
        # V0: the magic just read IS ndim; uint32 dims
        shape = _read_tshape(r, ndim=magic, dim64=False)
    if len(shape) == 0:
        return _empty()
    _read_context(r)
    flag = r.i32()
    return NDArray(_read_array_data(r, shape, flag))


def _to_sparse(stype, shape, data, aux_arrays):
    from .ndarray import sparse as sp
    if stype == 1:   # row_sparse: aux = [indices] (ndarray.h RowSparseAux)
        return sp.RowSparseNDArray(data, aux_arrays[0], shape)
    # csr: aux order in the file is [indptr, indices] (ndarray.h CSRAux)
    return sp.CSRNDArray(data, aux_arrays[1], aux_arrays[0], shape)


def is_reference_format(fname: str) -> bool:
    with open(fname, "rb") as f:
        head = f.read(8)
    return len(head) == 8 and \
        struct.unpack("<Q", head)[0] == _LIST_MAGIC


def load_reference_params(fname: str) \
        -> Union[List[NDArray], Dict[str, NDArray]]:
    """Load a reference-written ``.params`` / ``mx.nd.save`` file: a
    list, or a dict where the file names its arrays."""
    with open(fname, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != _LIST_MAGIC:
        raise MXNetError(f"{fname}: not a reference NDArray file")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_one(r) for _ in range(n)]
    n_names = r.u64()
    if n_names == 0:
        return arrays
    if n_names != n:
        raise MXNetError(f"{fname}: {n_names} names for {n} arrays")
    names = [r.take(r.u64()).decode() for _ in range(n_names)]
    return dict(zip(names, arrays))


def _host_array(arr) -> np.ndarray:
    """The values of an NDArray, tensor or array as numpy on the host;
    bfloat16 widened to float32."""
    t = getattr(arr, "_data", arr)
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(t)


def save_reference_params(fname: str, data) -> None:
    """Write dense NDArrays in the reference's V2 container so that the
    original implementation loads them.  bfloat16 is widened to float32
    (no bf16 in the 2017 format; exact for every bf16 value); a 0-d
    array cannot be written (every reader takes ndim 0 as empty)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = []
        arrays = list(data)
    chunks = [struct.pack("<QQQ", _LIST_MAGIC, 0, len(arrays))]
    for i, arr in enumerate(arrays):
        a = _host_array(arr)
        if a.ndim == 0:
            raise MXNetError(
                "save_reference_params: 0-d arrays cannot be represented "
                "in the reference format (entry %s); reshape to (1,)"
                % (names[i] if names else i))
        if a.dtype not in _FLAG_OF:
            raise MXNetError(
                "save_reference_params: dtype %s has no reference "
                "type flag (entry %s)" % (a.dtype, names[i] if names else i))
        chunks.append(struct.pack("<Ii", _V2_MAGIC, 0))        # dense
        chunks.append(struct.pack("<I", a.ndim))
        chunks.append(struct.pack("<%dq" % a.ndim, *a.shape))
        chunks.append(struct.pack("<ii", 1, 0))                # cpu(0)
        chunks.append(struct.pack("<i", _FLAG_OF[np.dtype(a.dtype)]))
        chunks.append(np.ascontiguousarray(a).tobytes())
    chunks.append(struct.pack("<Q", len(names)))
    for nm in names:
        b = nm.encode()
        chunks.append(struct.pack("<Q", len(b)) + b)
    with open(fname, "wb") as f:
        f.write(b"".join(chunks))
