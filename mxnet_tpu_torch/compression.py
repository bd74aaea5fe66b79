"""On-the-wire gradient compression for the distributed kvstore's pushes.

PyTorch counterpart of ``mxnet_tpu/compression.py`` (reference: MXNet
0.12's ``kvstore.set_gradient_compression``, src/kvstore/
gradient_compression.cc).  The 2-bit scheme quantizes each element of
``gradient + residual`` to one of {-t, 0, +t}, four codes to a byte, and
keeps what did not fire as the worker's residual for the next push
(error feedback); ``fp16`` is a plain half-precision cast.  Pull stays
full precision.

On the card the quantizer is the hand-written kernel Q1
(``csrc/grad_compress.cu``, :func:`quantize_2bit_cuda`): the gradient
and its residual stay on the device and only the packed codes (a
sixteenth of the fp32 bytes) are copied to the host.  A CPU tensor, or a
numpy array, takes the plain version :func:`quantize_2bit_plain`, which
equals the JAX package's numpy ``quantize_2bit`` bit for bit.  The
server's side, :func:`decompress`, is numpy, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError

_TYPES = ("2bit", "fp16", "none")


class WirePayload:
    """A compressed push payload: (kind, logical shape, threshold, raw
    data array).  The transport's frame replaces ``data`` with a raw
    buffer, so the bytes never pass through pickle."""

    __slots__ = ("kind", "shape", "threshold", "data")

    def __init__(self, kind, shape, threshold, data):
        self.kind = kind
        self.shape = tuple(shape)
        self.threshold = float(threshold)
        self.data = data

    def __reduce__(self):
        return (WirePayload,
                (self.kind, self.shape, self.threshold, self.data))


class RowSparsePayload:
    """A row-sparse value on the wire: sorted unique int64 row ids, the
    destination's logical row count, and one value row per id (raw, or
    a :class:`WirePayload` compressing the block)."""

    __slots__ = ("indices", "nrows", "data")

    def __init__(self, indices, nrows, data):
        self.indices = indices
        self.nrows = int(nrows)
        self.data = data

    def __reduce__(self):
        return (RowSparsePayload, (self.indices, self.nrows, self.data))


def validate_rowsparse(p):
    """Raise ValueError unless ``p`` holds 1-D non-negative strictly
    increasing int64 ids below ``nrows`` and one value row per id (the
    gate the codec's decoder and the server's pickle path share)."""
    idx = p.indices
    if not isinstance(idx, np.ndarray) or idx.dtype != np.int64 \
            or idx.ndim != 1:
        raise ValueError("row-sparse indices must be a 1-D int64 array")
    nrows = p.nrows
    if not isinstance(nrows, int) or isinstance(nrows, bool) \
            or nrows < 0:
        raise ValueError(
            f"row-sparse nrows must be a non-negative int, got {nrows!r}")
    if idx.size:
        if int(idx[0]) < 0:
            raise ValueError(
                f"row-sparse index out of range: {int(idx[0])}")
        if int(idx[-1]) >= nrows:
            raise ValueError(
                f"row-sparse index {int(idx[-1])} out of range for "
                f"{nrows} rows")
        if idx.size > 1 and not bool(np.all(idx[1:] > idx[:-1])):
            raise ValueError(
                "row-sparse indices must be strictly increasing "
                "(sorted, no duplicates)")
    data = p.data
    if isinstance(data, WirePayload):
        if not data.shape:
            raise ValueError(
                "row-sparse compressed values must keep a row shape")
        got = int(data.shape[0])
    elif isinstance(data, np.ndarray) and data.ndim >= 1:
        got = int(data.shape[0])
    else:
        raise ValueError(
            "row-sparse values must be an ndarray of rows or a "
            "WirePayload")
    if got != idx.size:
        raise ValueError(
            f"row-sparse index/value mismatch: {idx.size} ids vs "
            f"{got} value rows")
    return p


def _to_host(t):
    """A card tensor's bytes as a numpy array in pinned host memory (the
    copy is queued on the current stream: the caller synchronizes before
    the bytes are read); a CPU tensor's own numpy view."""
    if not t.is_cuda:
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host.numpy()


class GradientCompression:
    """The validated compression setting and the worker's compressor."""

    def __init__(self, params):
        params = dict(params or {})
        ctype = params.pop("type", "2bit")
        if ctype not in _TYPES:
            raise MXNetError(
                f"gradient compression type must be one of {_TYPES}, "
                f"got {ctype!r}")
        threshold = float(params.pop("threshold", 0.5))
        if ctype == "2bit" and threshold <= 0:
            raise MXNetError(
                f"gradient compression threshold must be > 0, "
                f"got {threshold}")
        if params:
            raise MXNetError(
                "unknown gradient compression parameter(s): "
                f"{sorted(params)}")
        self.type = ctype
        self.threshold = threshold

    @property
    def active(self) -> bool:
        return self.type != "none"

    def compress(self, wire_key, arr, residuals):
        """Compress one push payload (a torch tensor or a numpy array).
        ``residuals`` maps wire key -> the error-feedback residual, an
        fp32 tensor on the payload's device, updated in place by Q1.
        Payloads other than float32 / float64 come back as they are;
        float64 is cast to float32 first.  A card tensor's result holds
        pinned host bytes whose copy is still queued (see
        :func:`_to_host`)."""
        if isinstance(arr, np.ndarray):
            if not self.active or arr.dtype not in (np.float32, np.float64):
                return arr
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        elif not self.active or arr.dtype not in (torch.float32,
                                                  torch.float64):
            return arr
        g = arr.to(torch.float32)
        if self.type == "fp16":
            return WirePayload("fp16", g.shape, 0.0,
                               _to_host(g.to(torch.float16)))
        payload, residuals[wire_key] = quantize_2bit(
            g, residuals.get(wire_key), self.threshold)
        return payload

    def compress_rows(self, global_ids, rows, row_residuals):
        """Compress a row-sparse value block (numpy, one row per entry of
        ``global_ids``); ``row_residuals`` maps GLOBAL row id -> fp32
        residual row, kept on the host as in the JAX package (a restripe
        drops exactly the rows that moved)."""
        if not self.active or rows.dtype not in (np.float32, np.float64):
            return rows
        rows = np.asarray(rows, dtype=np.float32)
        if self.type == "fp16":
            return WirePayload("fp16", rows.shape, 0.0,
                               rows.astype(np.float16))
        res = np.zeros(rows.shape, np.float32)
        for j, rid in enumerate(global_ids):
            prev = row_residuals.get(int(rid))
            if prev is not None:
                res[j] = prev
        payload, work = quantize_2bit(rows + res, None, self.threshold)
        for j, rid in enumerate(global_ids):
            row_residuals[int(rid)] = work[j]
        return payload


def quantize_2bit(arr, residual, threshold):
    """``(WirePayload, new_residual)`` for ``arr + residual`` (JAX
    package: ``compression.py quantize_2bit``): Q1 for a card tensor, the
    plain version for a CPU tensor, and numpy in, numpy out."""
    is_np = isinstance(arr, np.ndarray)
    g = torch.from_numpy(np.asarray(arr, np.float32)) if is_np else arr
    if is_np and residual is not None:
        residual = torch.from_numpy(np.asarray(residual, np.float32))
    quantize = quantize_2bit_cuda if g.is_cuda else quantize_2bit_plain
    codes, work = quantize(g, residual, threshold)
    payload = WirePayload("2bit", g.shape, threshold, _to_host(codes))
    return payload, (work.numpy() if is_np else work)


def quantize_2bit_plain(g, residual, threshold):
    """Q1's plain version: ``(codes, new_residual)`` for ``work = g +
    residual`` in float32 (``g`` alone when ``residual`` is None): an
    element fires +t where ``work >= float32(t)`` and -t where ``work <=
    -float32(t)`` (both masks taken first; NaN fires nowhere), the
    residual keeps ``work`` minus what fired, and the codes (1 positive,
    2 negative, 0 else) pack four to a byte, element ``4j+i`` at bits
    ``2i`` of byte ``j``, the padding codes 0 (JAX package:
    ``compression.py quantize_2bit``)."""
    work = g.to(torch.float32, copy=True)
    if residual is not None:
        work += residual
    t = torch.tensor(threshold, dtype=torch.float32)
    pos = work >= t
    neg = work <= -t
    work = torch.where(pos, work - t, torch.where(neg, work + t, work))
    codes = (pos.to(torch.uint8) | (neg.to(torch.uint8) << 1)).reshape(-1)
    pad = (-codes.numel()) % 4
    if pad:
        codes = torch.cat([codes, codes.new_zeros(pad)])
    c = codes.reshape(-1, 4)
    packed = c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4) | (c[:, 3] << 6)
    return packed, work


def quantize_2bit_cuda(g, residual, threshold):
    """:func:`quantize_2bit_plain` on the card: launch Q1
    (``csrc/grad_compress.cu``) on the current stream of ``g``'s device.
    ``g`` is an fp32 card tensor (a contiguous stripe of a larger one
    may start anywhere); ``residual`` is None (the first push) or an
    fp32 tensor of as many values on the same device, which Q1 updates
    in place.  Returns ``(codes, residual)``, both on the card.  Raises
    on anything else.  ``quantize_2bit_cuda.launches`` counts successful
    launches."""
    import ctypes
    from . import cuda_lib
    if not g.is_cuda or g.dtype != torch.float32 or (
            residual is not None and (
                residual.dtype != torch.float32
                or residual.numel() != g.numel()
                or residual.device != g.device
                or not residual.is_contiguous())):
        raise MXNetError(
            f"quantize_2bit_cuda: g {g.dtype} {tuple(g.shape)} on "
            f"{g.device}, residual "
            f"{None if residual is None else (residual.dtype, tuple(residual.shape), residual.device)}"
            ": the kernel takes an fp32 card tensor and an fp32 residual "
            "of as many values on its device")
    g = g.contiguous()
    n = g.numel()
    out = residual if residual is not None else torch.empty_like(g)
    codes = torch.empty((n + 3) // 4, dtype=torch.uint8, device=g.device)
    lib = cuda_lib.library("grad_compress.cu")
    fn = lib.mxtt_quantize_2bit
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    err = fn(g.data_ptr(),
             None if residual is None else residual.data_ptr(),
             out.data_ptr(), codes.data_ptr(), n, float(threshold),
             g.device.index or 0,
             torch.cuda.current_stream(g.device).cuda_stream)
    if err != 0:
        raise MXNetError("quantize_2bit_cuda: launch failed: "
                         f"{lib.mxtt_error_string(err).decode()} ({err})")
    quantize_2bit_cuda.launches += 1
    return codes, out.view(g.shape)


quantize_2bit_cuda.launches = 0


def decompress(payload):
    """WirePayload -> the fp32 numpy array the server applies as the
    gradient."""
    if payload.kind == "fp16":
        return np.asarray(payload.data, np.float16).astype(np.float32)
    if payload.kind != "2bit":
        raise MXNetError(
            f"unknown compressed payload kind {payload.kind!r}")
    packed = np.asarray(payload.data, np.uint8)
    n = int(np.prod(payload.shape, dtype=np.int64)) if payload.shape \
        else 1
    codes = np.empty(packed.size * 4, np.uint8)
    codes[0::4] = packed & 3
    codes[1::4] = (packed >> 2) & 3
    codes[2::4] = (packed >> 4) & 3
    codes[3::4] = (packed >> 6) & 3
    codes = codes[:n]
    out = np.zeros(n, np.float32)
    out[codes == 1] = np.float32(payload.threshold)
    out[codes == 2] = np.float32(-payload.threshold)
    return out.reshape(payload.shape)
