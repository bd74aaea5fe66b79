"""I1: the record iterators' resize -> crop -> mirror -> normalize pass.

A batch of decoded images, each at its own size in one flat uint8 buffer
(:class:`DecodedImages`), becomes one batch of the network's input: for
image n and output pixel (y, x), the pixel (y0 + y, x0 + x') of image n
resized to (dh, dw) by the JAX package's ``resize_bilinear``
(``mxnet_tpu/native/io_native.cc:127``), x' mirrored where the image is
flipped, rounded to uint8 as that code rounds; then ``(v - mean) *
(1 / std)`` as float32 NCHW (the fused host path
``jpeg_decode_augment_batch`` multiplies by the reciprocal, ``:264``,
where the JAX package's split path divides, ``image_record_iter.py:203``:
the port follows the fused path, the one the JAX package takes wherever
its library builds), or the uint8 value NCHW or NHWC (the raw-record
passes ``crop_flip_u8_batch`` and ``_nhwc``).  A failed decode
(``valid`` False) reads as zeros.

A CUDA buffer launches the hand-written kernel ``csrc/image_augment.cu``
(:func:`augment_cuda`); a CPU buffer takes the plain version
(:func:`augment_plain`), which the kernel equals bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError

OUT_KINDS = {("float32", "NCHW"): 0, ("uint8", "NCHW"): 1,
             ("uint8", "NHWC"): 2}


class DecodedImages:
    """Images decoded into one flat uint8 tensor: image i is
    ``flat[offsets[i]: offsets[i] + heights[i] * widths[i] * channels]``,
    HWC, unless ``valid[i]`` is False (a failed decode, read as
    zeros)."""

    def __init__(self, flat, offsets, heights, widths, channels, valid=None):
        self.flat = flat
        self.offsets = np.asarray(offsets, np.int64)
        self.heights = np.asarray(heights, np.int64)
        self.widths = np.asarray(widths, np.int64)
        self.channels = int(channels)
        self.valid = np.ones(len(self.offsets), bool) if valid is None \
            else np.asarray(valid, bool)

    def __len__(self):
        return len(self.offsets)

    def image(self, i):
        """Image i as an (h, w, c) uint8 view, or None for a failed
        decode."""
        if not self.valid[i]:
            return None
        h, w, c = int(self.heights[i]), int(self.widths[i]), self.channels
        o = int(self.offsets[i])
        return self.flat[o:o + h * w * c].view(h, w, c)

    @classmethod
    def from_arrays(cls, arrays, device="cpu", channels=None):
        """One flat buffer from (h, w, c) uint8 numpy arrays (None: a
        failed decode), copied to ``device``."""
        c = channels or next(a.shape[2] for a in arrays if a is not None)
        sizes = [a.size if a is not None else 0 for a in arrays]
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64)
        flat = np.concatenate([a.reshape(-1) for a in arrays
                               if a is not None] or [np.zeros(0, np.uint8)])
        hs = [a.shape[0] if a is not None else 0 for a in arrays]
        ws = [a.shape[1] if a is not None else 0 for a in arrays]
        return cls(torch.from_numpy(flat).to(device), offsets, hs, ws, c,
                   [a is not None for a in arrays])


def _clamped(y0s, x0s, dh, dw, oh, ow):
    """Crop offsets clamped as io_native.cc:285-289 clamps them: high
    first, then low."""
    y0 = np.maximum(np.minimum(np.asarray(y0s, np.int64), dh - oh), 0)
    x0 = np.maximum(np.minimum(np.asarray(x0s, np.int64), dw - ow), 0)
    return y0, x0


def _taps(r, size_in, size_out):
    """resize_bilinear's two source indices and weight for output
    coordinates ``r`` (a float32 tensor), each operation rounded to
    float32 as the C code rounds."""
    s = torch.tensor(np.float32(size_in) / np.float32(size_out),
                     device=r.device)
    f = (r + 0.5) * s - 0.5
    i0 = f.to(torch.int64).clamp(min=0)
    i1 = torch.where(i0 + 1 < size_in, i0 + 1, size_in - 1)
    w = f - i0.to(torch.float32)
    w = torch.where(w < 0, torch.zeros_like(w), w)
    return i0, i1, w


def _pixels(img, h, w, c, dh, dw, ry, rx):
    """uint8 (len(ry), len(rx), c): ``img`` resized to (dh, dw) as
    resize_bilinear resizes it, at rows ``ry`` and columns ``rx``."""
    dev = ry.device
    if img is None:
        return torch.zeros((len(ry), len(rx), c), dtype=torch.uint8,
                           device=dev)
    if h == dh and w == dw:
        return img[ry][:, rx]
    y0, y1, wy = _taps(ry.to(torch.float32), h, dh)
    x0, x1, wx = _taps(rx.to(torch.float32), w, dw)
    f = img.to(torch.float32)
    wx = wx[None, :, None]
    wy = wy[:, None, None]
    r0, r1 = f[y0], f[y1]
    v0 = r0[:, x0] + (r0[:, x1] - r0[:, x0]) * wx
    v1 = r1[:, x0] + (r1[:, x1] - r1[:, x0]) * wx
    v = v0 + (v1 - v0) * wy + 0.5
    return v.to(torch.int32).to(torch.uint8)


def augment_plain(images, y0s, x0s, flips, dec_hw, out_hw, mean=None,
                  std=None, out="float32", layout="NCHW"):
    """:func:`augment` in PyTorch's ops, on the buffer's device, image by
    image (the card checks its kernel against this)."""
    dh, dw = dec_hw
    oh, ow = out_hw
    c = images.channels
    dev = images.flat.device
    y0, x0 = _clamped(y0s, x0s, dh, dw, oh, ow)
    mean_t, inv_t = (torch.from_numpy(np.array(a, np.float32))
                     for a in _norm(mean, std, c))
    outs = []
    for i in range(len(images)):
        ry = torch.arange(int(y0[i]), int(y0[i]) + oh, device=dev)
        rx = torch.arange(int(x0[i]), int(x0[i]) + ow, device=dev)
        if flips[i]:
            rx = rx.flip(0)
        p = _pixels(images.image(i), int(images.heights[i]),
                    int(images.widths[i]), c, dh, dw, ry, rx)
        if out == "float32":
            p = (p.to(torch.float32) - mean_t.to(dev)) * inv_t.to(dev)
        outs.append(p if layout == "NHWC" else p.permute(2, 0, 1))
    if not outs:
        shape = (0, oh, ow, c) if layout == "NHWC" else (0, c, oh, ow)
        return torch.empty(shape, dtype=getattr(torch, out), device=dev)
    return torch.stack(outs).contiguous()


def _norm(mean, std, c):
    """float32 mean and 1 / std per channel (the reciprocal rounded to
    float32, as the host code computes ``1.0f / stdv[k]``)."""
    m = np.zeros(c, np.float32) if mean is None else np.broadcast_to(
        np.asarray(mean, np.float32).ravel(), (c,))
    s = np.ones(c, np.float32) if std is None else np.broadcast_to(
        np.asarray(std, np.float32).ravel(), (c,))
    return m, np.float32(1.0) / s


def augment(images, y0s, x0s, flips, dec_hw, out_hw, mean=None, std=None,
            out="float32", layout="NCHW"):
    """The batch (n, c, oh, ow) float32 (or uint8 NCHW or NHWC with
    ``out="uint8"``) of ``images`` resized to ``dec_hw``, cropped at
    (y0s[i], x0s[i]) to ``out_hw``, mirrored where ``flips[i]``, and
    normalized by ``mean`` and ``std`` (float output only).  A CUDA
    buffer launches I1 (:func:`augment_cuda`); a CPU one takes
    :func:`augment_plain`."""
    if images.flat.is_cuda:
        return augment_cuda(images, y0s, x0s, flips, dec_hw, out_hw, mean,
                            std, out, layout)
    return augment_plain(images, y0s, x0s, flips, dec_hw, out_hw, mean,
                         std, out, layout)


def _meta(images, y0s, x0s, flips, mean=None, std=None):
    """The kernel's table, int64 (6 n + 4): pointer (0 for a failed
    decode), h, w, y0, x0, flip of each image, row by row, then the mean
    and 1 / std of channels 0 .. 3 as 8 float32 (zero padded), so that
    one copy takes it to the card."""
    n = len(images)
    t = np.empty(6 * n + 4, np.int64)
    t[:n] = images.offsets
    t[:n] += images.flat.data_ptr()
    t[:n][~images.valid] = 0
    t[n:2 * n] = images.heights
    t[2 * n:3 * n] = images.widths
    t[3 * n:4 * n] = y0s
    t[4 * n:5 * n] = x0s
    t[5 * n:6 * n] = np.asarray(flips, bool)
    norm = t[6 * n:].view(np.float32)
    norm[:] = 0
    m, inv = _norm(mean, std, images.channels)
    norm[:len(m)], norm[4:4 + len(inv)] = m, inv
    return t


def augment_cuda(images, y0s, x0s, flips, dec_hw, out_hw, mean=None,
                 std=None, out="float32", layout="NCHW"):
    """Launch I1 (``csrc/image_augment.cu``) on the current stream of the
    buffer's device.  Raises on what the kernel does not take (a CPU
    buffer, more than 4 channels, a crop larger than the decode size, an
    output kind other than float32 NCHW and uint8 NCHW or NHWC, more than
    65535 images).
    ``augment_cuda.launches`` counts successful launches."""
    import ctypes
    from .. import cuda_lib
    kind = OUT_KINDS.get((out, layout))
    if kind is None:
        raise MXNetError(f"augment_cuda: no {out} {layout} output")
    flat = images.flat
    if not flat.is_cuda or flat.dtype != torch.uint8:
        raise MXNetError("augment_cuda: the images must be uint8 on the "
                         "card")
    dh, dw = dec_hw
    oh, ow = out_hw
    n, c = len(images), images.channels
    if not 1 <= c <= 4 or oh > dh or ow > dw or n > 65535:
        raise MXNetError(f"augment_cuda: {n} images of {c} channels, crop "
                         f"{out_hw} of {dec_hw}: the kernel takes at most "
                         "65535 images of 1-4 channels and a crop inside "
                         "the decode size")
    dev = flat.device
    shape = (n, oh, ow, c) if layout == "NHWC" else (n, c, oh, ow)
    res = torch.empty(shape, dtype=getattr(torch, out), device=dev)
    if n == 0:
        return res
    meta = torch.from_numpy(_meta(images, y0s, x0s, flips, mean, std)) \
        .pin_memory().to(dev, non_blocking=True)
    lib = cuda_lib.library("image_augment.cu")
    fn = lib.mxtt_image_augment
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    err = fn(meta.data_ptr(), res.data_ptr(), n, c, dh, dw, oh, ow, kind,
             dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise MXNetError("augment_cuda: launch failed: "
                         f"{lib.mxtt_error_string(err).decode()} ({err})")
    augment_cuda.launches += 1
    return res


augment_cuda.launches = 0


def bound_bytes(images, y0s, x0s, flips, dec_hw, out_hw, out_itemsize):
    """The bytes the pass must move on these inputs: each source pixel
    its crop window's taps reach, read once, and the output written
    once (the ``bound_ms`` of ``chip_smoke.py``)."""
    dh, dw = dec_hw
    oh, ow = out_hw
    y0, x0 = _clamped(y0s, x0s, dh, dw, oh, ow)
    c = images.channels
    read = 0
    for i in range(len(images)):
        if not images.valid[i]:
            continue
        h, w = int(images.heights[i]), int(images.widths[i])
        ry = np.arange(y0[i], y0[i] + oh)
        rx = np.arange(x0[i], x0[i] + ow)
        if h == dh and w == dw:
            read += oh * ow * c
            continue
        rows = _tap_set(ry, h, dh)
        cols = _tap_set(rx, w, dw)
        read += len(rows) * len(cols) * c
    return read + len(images) * oh * ow * c * out_itemsize


def _tap_set(r, size_in, size_out):
    s = np.float32(size_in) / np.float32(size_out)
    f = (r.astype(np.float32) + np.float32(0.5)) * s - np.float32(0.5)
    i0 = np.maximum(f.astype(np.int64), 0)
    i1 = np.where(i0 + 1 < size_in, i0 + 1, size_in - 1)
    return np.union1d(i0, i1)
