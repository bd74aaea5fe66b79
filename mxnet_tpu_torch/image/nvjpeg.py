"""JPEG decode and encode on the card through nvJPEG.

ctypes bindings of ``csrc/nvjpeg_decode.cu`` (built by ``cuda_lib`` at
first use, linked with the toolkit's ``libnvjpeg``).  A
:class:`Decoder` decodes a batch of JPEG buffers into card memory, each
image at its own size in one flat buffer (an
``ops.image_augment.DecodedImages``), through the H100's hardware JPEG
engines where nvJPEG's hardware backend takes the image, and its
GPU-hybrid backend otherwise (Huffman decode on the GPU for a batch of
more than 50); ``backend_counts`` says how many images each decoded.  An
image that no backend decodes is zero-filled and counted.
:func:`encode` writes a baseline 4:2:0 JPEG of an RGB image in card
memory.  Nothing falls back to the host: a shim that does not build or a
decoder that cannot be created raises.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from ..base import MXNetError
from ..native import _as_u8
from ..ops.image_augment import DecodedImages

SOURCE = "nvjpeg_decode.cu"
# what decoded an image (the shim's `used` codes)
BACKENDS = {1: "hardware", 2: "gpu_hybrid", 3: "gpu_hybrid_one_by_one"}
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
           4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE",
           6: "EXECUTION_FAILED", 7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR",
           9: "IMPLEMENTATION_NOT_SUPPORTED", 10: "INCOMPLETE_BITSTREAM"}


def status_name(rc):
    if rc >= 1000:
        return f"CUDA error {rc - 1000}"
    return "NVJPEG_STATUS_" + _STATUS.get(rc, str(rc))


def _lib():
    from .. import cuda_lib
    lib = cuda_lib.library(SOURCE)
    if lib.mxtt_jpeg_create.argtypes is None:
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.mxtt_jpeg_create.argtypes = [ctypes.c_int, ctypes.POINTER(vp),
                                         ip]
        lib.mxtt_jpeg_destroy.argtypes = [vp]
        lib.mxtt_jpeg_info.argtypes = [vp, vp, ctypes.c_size_t, ip, ip, ip,
                                       ip]
        lib.mxtt_jpeg_decode.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp,
                                         vp, vp, ctypes.c_int, vp, vp]
        lib.mxtt_jpeg_encode.argtypes = [vp, vp, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, vp, vp,
                                         ctypes.POINTER(ctypes.c_size_t)]
        lib.mxtt_jpeg_hw_info.argtypes = [vp] + [
            ctypes.POINTER(ctypes.c_uint)] * 2
        lib.mxtt_jpeg_version.argtypes = [ip] * 3
        for fn in ("mxtt_jpeg_create", "mxtt_jpeg_destroy", "mxtt_jpeg_info",
                   "mxtt_jpeg_decode", "mxtt_jpeg_encode",
                   "mxtt_jpeg_hw_info", "mxtt_jpeg_version"):
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def version():
    """nvJPEG's version, "major.minor.patch"."""
    v = [ctypes.c_int() for _ in range(3)]
    _lib().mxtt_jpeg_version(*[ctypes.byref(x) for x in v])
    return ".".join(str(x.value) for x in v)


class Decoder:
    """nvJPEG decoder on a CUDA ``device``: its hardware backend where the
    card has JPEG engines and nvJPEG drives them (``hardware``; else
    ``hw_status`` holds nvJPEG's refusal), its GPU-hybrid backend always.
    One thread uses a decoder at a time."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise MXNetError(f"nvjpeg.Decoder: {self.device} is not a CUDA "
                             "device")
        self._lib = _lib()
        ctx, hw = ctypes.c_void_p(), ctypes.c_int()
        rc = self._lib.mxtt_jpeg_create(self.device.index or 0,
                                        ctypes.byref(ctx), ctypes.byref(hw))
        if rc != 0:
            raise MXNetError(f"nvjpeg.Decoder: {status_name(rc)}")
        self._ctx = ctx
        self.hw_status = hw.value
        eng, cores = ctypes.c_uint(), ctypes.c_uint()
        self._lib.mxtt_jpeg_hw_info(ctx, ctypes.byref(eng),
                                    ctypes.byref(cores))
        self.hardware = hw.value == 0
        self.hw_engines, self.hw_cores = eng.value, cores.value
        self.backend_counts = {name: 0 for name in BACKENDS.values()}
        self.failures = 0

    def close(self):
        if self._ctx:
            self._lib.mxtt_jpeg_destroy(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001  interpreter teardown
            pass

    def info(self, buf):
        """(height, width, components, hardware batch takes it) of a JPEG,
        or None where nvJPEG cannot read its header."""
        a = _as_u8(buf)
        h, w, c, hw = (ctypes.c_int() for _ in range(4))
        rc = self._lib.mxtt_jpeg_info(self._ctx, a.ctypes.data, a.size,
                                      ctypes.byref(h), ctypes.byref(w),
                                      ctypes.byref(c), ctypes.byref(hw))
        if rc != 0:
            return None
        return h.value, w.value, c.value, bool(hw.value)

    def decode(self, buffers, channels=3):
        """Decode JPEG ``buffers`` (host bytes or uint8 arrays) as RGB (or
        luma, ``channels=1``) into one flat buffer on the card, on the
        current stream.  Returns (``DecodedImages``, failed decodes: their
        images read as zeros)."""
        arrs = [_as_u8(b) for b in buffers]
        n = len(arrs)
        hs = np.zeros(n, np.int32)
        ws = np.zeros(n, np.int32)
        hw = np.zeros(n, np.int32)
        valid = np.zeros(n, bool)
        for i, a in enumerate(arrs):
            got = self.info(a)
            if got is not None and got[0] > 0 and got[1] > 0:
                hs[i], ws[i] = got[0], got[1]
                hw[i] = int(got[3])
                valid[i] = True
        sizes = hs.astype(np.int64) * ws * channels * valid
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(
            np.int64)
        flat = torch.empty(int(sizes.sum()), dtype=torch.uint8,
                           device=self.device)
        base = flat.data_ptr()
        outs = np.where(valid, base + offsets, 0).astype(np.uint64)
        data = np.array([a.ctypes.data for a in arrs], np.uint64)
        lens = np.array([a.size for a in arrs], np.uint64)
        used = np.zeros(n, np.int32)
        stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._lib.mxtt_jpeg_decode(
            self._ctx, n, data.ctypes.data, lens.ctypes.data,
            outs.ctypes.data, hs.ctypes.data, ws.ctypes.data, hw.ctypes.data,
            channels, stream, used.ctypes.data)
        if rc != 0:
            raise MXNetError(f"nvjpeg.Decoder.decode: {status_name(rc)}")
        for code, name in BACKENDS.items():
            self.backend_counts[name] += int((used == code).sum())
        ok = valid & (used != 0)
        fails = int(n - ok.sum())
        self.failures += fails
        return DecodedImages(flat, offsets, hs, ws, channels, ok), fails

    def encode(self, img, quality=95):
        """A baseline JPEG (4:2:0, ``quality``) of ``img``, an (h, w, 3)
        uint8 tensor on the card, as bytes."""
        if not img.is_cuda or img.dtype != torch.uint8 or img.dim() != 3 \
                or img.shape[2] != 3:
            raise MXNetError("nvjpeg.encode: the card encodes (h, w, 3) "
                             f"uint8 CUDA tensors, not {tuple(img.shape)} "
                             f"{img.dtype} on {img.device}")
        img = img.contiguous()
        h, w = int(img.shape[0]), int(img.shape[1])
        stream = torch.cuda.current_stream(img.device).cuda_stream
        cap = h * w * 3 + 65536
        for _ in range(2):
            buf = np.empty(cap, np.uint8)
            ln = ctypes.c_size_t(cap)
            rc = self._lib.mxtt_jpeg_encode(
                self._ctx, img.data_ptr(), h, w, int(quality), stream,
                buf.ctypes.data, ctypes.byref(ln))
            if rc != -1:
                break
            cap = ln.value
        if rc != 0:
            raise MXNetError(f"nvjpeg.encode: {status_name(rc)}")
        return buf[:ln.value].tobytes()


# one decoder a device for single images (unpack_img, pack_img),
# used under a lock
_shared = {}
_shared_lock = threading.Lock()


def _shared_decoder(device):
    dev = torch.device(device)
    d = _shared.get(dev)
    if d is None:
        d = _shared[dev] = Decoder(dev)
    return d


def encode(img, quality=95):
    """A baseline 4:2:0 JPEG of an (h, w, 3) uint8 CUDA tensor, encoded
    on its card (``recordio.pack_img`` of a CUDA tensor)."""
    with _shared_lock:
        return _shared_decoder(img.device).encode(img, quality)


def decode_one(buf, channels, device):
    """One JPEG decoded on ``device``: an (h, w, channels) uint8 tensor;
    raises where nvJPEG cannot decode it."""
    with _shared_lock:
        images, fails = _shared_decoder(device).decode([buf], channels)
    if fails:
        raise MXNetError("nvjpeg: cannot decode the image")
    return images.image(0)
