"""ctypes bindings for the port's host data-path libraries.

PyTorch counterpart of ``mxnet_tpu/native/__init__.py`` (the bindings of
``io_native.cc``), split in two sources so that the card path needs no
JPEG library:

- ``rec_io.cc``: the record index and batched reader, and the two
  ``crop_flip_u8`` passes over raw records;
- ``jpeg_io.cc``: libjpeg decode with the DCT-domain downscale,
  ``resize_bilinear``, ``jpeg_decode_resize_batch`` and the fused
  ``jpeg_decode_augment_batch``, the port's CPU path (``device=cpu()``).

Each is compiled by the host C++ compiler at first use into
``build/native/<stem>-<hash>/`` beside the package (the hash covers the
source and the flags), never at import.  A library that does not build
raises ``MXNetError`` with the compiler's output: no caller falls back
to another decoder.  ``available(stem)`` says whether a library builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..base import MXNetError

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
# sources, each with its flags and libraries
SOURCES = {
    "rec_io": (["-O3", "-fPIC", "-shared", "-fopenmp", "-Wall",
                "-ffp-contract=off"], []),
    "jpeg_io": (["-O3", "-fPIC", "-shared", "-fopenmp", "-Wall",
                 "-ffp-contract=off"], ["-ljpeg"]),
}

_lock = threading.Lock()
_libs = {}
_errors = {}

P_U8 = ctypes.POINTER(ctypes.c_uint8)
P_I32 = ctypes.POINTER(ctypes.c_int32)
P_I64 = ctypes.POINTER(ctypes.c_int64)
P_F32 = ctypes.POINTER(ctypes.c_float)


def _lib_path(stem):
    flags, libs = SOURCES[stem]
    h = hashlib.sha256(" ".join(flags + libs).encode())
    with open(os.path.join(_DIR, stem + ".cc"), "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}",
                        f"lib{stem}.so")


def _build(stem):
    path = _lib_path(stem)
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise MXNetError(f"native.{stem}: no host C++ compiler (g++ or c++) "
                         "to build the host data path")
    flags, libs = SOURCES[stem]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}.{threading.get_ident()}"
    res = subprocess.run(
        [cxx, *flags, "-o", tmp, os.path.join(_DIR, stem + ".cc"), *libs],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise MXNetError(f"native.{stem}: the build failed:\n"
                         f"{res.stderr[-3000:]}")
    os.replace(tmp, path)
    return path


def _bind(lib, stem):
    if stem == "rec_io":
        lib.rec_index_file.restype = ctypes.c_long
        lib.rec_index_file.argtypes = [ctypes.c_char_p, P_I64, ctypes.c_long]
        lib.rec_read_batch.restype = ctypes.c_int
        lib.rec_read_batch.argtypes = [ctypes.c_char_p, P_I64, ctypes.c_long,
                                       ctypes.POINTER(P_U8), P_I64]
        for fname in ("crop_flip_u8_batch", "crop_flip_u8_nhwc_batch"):
            fn = getattr(lib, fname)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.POINTER(P_U8), ctypes.c_long, P_U8] + \
                [ctypes.c_int] * 5 + [P_I32, P_I32, P_U8, ctypes.c_int]
        return
    lib.jpeg_decode_resize_batch.restype = ctypes.c_int
    lib.jpeg_decode_resize_batch.argtypes = [
        ctypes.POINTER(P_U8), P_I64, ctypes.c_long, P_U8] + \
        [ctypes.c_int] * 4
    lib.jpeg_decode_augment_batch.restype = ctypes.c_int
    lib.jpeg_decode_augment_batch.argtypes = [
        ctypes.POINTER(P_U8), P_I64, ctypes.c_long, P_F32] + \
        [ctypes.c_int] * 5 + [P_I32, P_I32, P_U8, P_F32, P_F32, ctypes.c_int]
    lib.jpeg_probe.restype = ctypes.c_int
    lib.jpeg_probe.argtypes = [P_U8, ctypes.c_int64] + \
        [ctypes.POINTER(ctypes.c_int)] * 3


def get_lib(stem):
    """The loaded library ``stem`` ("rec_io" or "jpeg_io"), built on
    first use; raises ``MXNetError`` when it does not build or load."""
    with _lock:
        lib = _libs.get(stem)
        if lib is not None:
            return lib
        if stem in _errors:
            raise MXNetError(_errors[stem])
        try:
            lib = ctypes.CDLL(_build(stem))
        except (MXNetError, OSError, subprocess.SubprocessError) as e:
            _errors[stem] = str(e)
            raise MXNetError(str(e)) from e
        _bind(lib, stem)
        _libs[stem] = lib
        return lib


def available(stem="jpeg_io") -> bool:
    """Whether library ``stem`` builds and loads here."""
    try:
        get_lib(stem)
        return True
    except MXNetError:
        return False


def _ptrs(arrs):
    return (P_U8 * len(arrs))(*[a.ctypes.data_as(P_U8) for a in arrs])


def _as_u8(b):
    return b.reshape(-1) if isinstance(b, np.ndarray) \
        else np.frombuffer(b, dtype=np.uint8)


def index_rec_file(path):
    """Offsets of every logical record of a .rec file."""
    lib = get_lib("rec_io")
    # every record costs at least 8 bytes of framing
    cap = os.path.getsize(path) // 8 + 1
    offsets = np.zeros(cap, dtype=np.int64)
    n = lib.rec_index_file(path.encode(), offsets.ctypes.data_as(P_I64), cap)
    if n < 0:
        raise IOError(f"rec_index_file failed for {path}")
    return offsets[:n].copy()


# path -> (file size, np.memmap): an appended file maps again; guarded,
# since the producer threads of several iterators read at once
_mmap_cache = {}
_mmap_lock = threading.Lock()


def read_records(path, offsets, file_offsets=None):
    """The logical records at ``offsets`` as uint8 numpy arrays: each
    single-chunk record (cflag 0, all that a writer makes of a payload
    without an embedded magic) a view of the memory-mapped file, the rest
    assembled by ``rec_read_batch``.  ``file_offsets``, the file's whole
    sorted offsets, sizes the assembled records' buffers exactly."""
    fsize_now = os.path.getsize(path)
    with _mmap_lock:
        entry = _mmap_cache.get(path)
        if entry is not None and entry[0] == fsize_now:
            mm = entry[1]
        else:
            mm = np.memmap(path, dtype=np.uint8, mode="r")
            _mmap_cache[path] = (fsize_now, mm)
    views = [None] * len(offsets)
    slow = []
    for i, o in enumerate(offsets):
        o = int(o)
        if o + 8 > mm.size:
            slow.append(i)
            continue
        head = mm[o:o + 8].view(np.uint32)
        cflag = int(head[1]) >> 29
        ln = int(head[1]) & ((1 << 29) - 1)
        if head[0] == 0xced7230a and cflag == 0 and o + 8 + ln <= mm.size:
            views[i] = mm[o + 8:o + 8 + ln]
        else:
            slow.append(i)
    if slow:
        assembled = _read_records_copy(path, [offsets[i] for i in slow],
                                       file_offsets)
        for i, rec in zip(slow, assembled):
            views[i] = rec
    return views


def _read_records_copy(path, offsets, file_offsets=None):
    """The assembling C read (split and continued records)."""
    lib = get_lib("rec_io")
    n = len(offsets)
    offs = np.ascontiguousarray(offsets, dtype=np.int64)
    fsize = os.path.getsize(path)
    if file_offsets is None:
        file_offsets = offs
    bounds = np.concatenate([np.unique(np.asarray(file_offsets, np.int64)),
                             [fsize]])
    pos = np.searchsorted(bounds, offs)
    caps = bounds[pos + 1] - offs
    bufs = [np.empty(int(c), dtype=np.uint8) for c in caps]
    lens = caps.astype(np.int64)
    rc = lib.rec_read_batch(path.encode(), offs.ctypes.data_as(P_I64), n,
                            _ptrs(bufs), lens.ctypes.data_as(P_I64))
    if rc != 0:
        raise IOError(f"rec_read_batch failed ({rc}) for {path}")
    if (lens < 0).any():
        raise IOError(f"rec_read_batch: record larger than its on-disk "
                      f"extent in {path} (corrupt index?)")
    return [bufs[i][:lens[i]] for i in range(n)]


def decode_jpeg_batch(jpeg_buffers, height, width, channels=3, nthreads=0):
    """Decode and resize JPEG buffers into one NHWC uint8 array; returns
    (array, failed decodes, zero-filled)."""
    lib = get_lib("jpeg_io")
    arrs = [_as_u8(b) for b in jpeg_buffers]
    n = len(arrs)
    lens = np.array([a.size for a in arrs], dtype=np.int64)
    out = np.empty((n, height, width, channels), dtype=np.uint8)
    failures = lib.jpeg_decode_resize_batch(
        _ptrs(arrs), lens.ctypes.data_as(P_I64), n,
        out.ctypes.data_as(P_U8), height, width, channels, nthreads)
    return out, failures


def decode_augment_batch(jpeg_buffers, dec_h, dec_w, out_h, out_w, y0s,
                         x0s, flips, mean, std, channels=3, nthreads=0):
    """Fused decode -> crop -> mirror -> normalize -> NCHW float32 (one
    OpenMP pass).  The caller draws the crop offsets and flips; ``mean``
    and ``std`` are per channel.  Returns (float32[n, channels, out_h,
    out_w], failed decodes)."""
    lib = get_lib("jpeg_io")
    arrs = [_as_u8(b) for b in jpeg_buffers]
    n = len(arrs)
    lens = np.array([a.size for a in arrs], dtype=np.int64)
    y0s = np.ascontiguousarray(y0s, dtype=np.int32)
    x0s = np.ascontiguousarray(x0s, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    mean = np.ascontiguousarray(
        np.broadcast_to(np.asarray(mean, np.float32).ravel(), (channels,)))
    std = np.ascontiguousarray(
        np.broadcast_to(np.asarray(std, np.float32).ravel(), (channels,)))
    out = np.empty((n, channels, out_h, out_w), dtype=np.float32)
    failures = lib.jpeg_decode_augment_batch(
        _ptrs(arrs), lens.ctypes.data_as(P_I64), n,
        out.ctypes.data_as(P_F32), dec_h, dec_w, out_h, out_w, channels,
        y0s.ctypes.data_as(P_I32), x0s.ctypes.data_as(P_I32),
        flips.ctypes.data_as(P_U8), mean.ctypes.data_as(P_F32),
        std.ctypes.data_as(P_F32), nthreads)
    if failures < 0:
        raise ValueError(
            f"jpeg_decode_augment_batch rejected arguments (code "
            f"{failures}): channels must be 1..8 and crop "
            f"({out_h}x{out_w}) must fit in decode size ({dec_h}x{dec_w})")
    return out, failures


def check_raw(raw_buffers, dec_h, dec_w, channels):
    """The raw records as flat uint8 arrays, each ``dec_h * dec_w *
    channels`` bytes; raises on any other size."""
    arrs = [_as_u8(b) for b in raw_buffers]
    want = dec_h * dec_w * channels
    for a in arrs:
        if a.size != want:
            raise ValueError(
                f"raw record payload {a.size} != {dec_h}x{dec_w}x"
                f"{channels}={want}; repack or fix stored_shape")
    return arrs


def _crop_flip_common(fname, out_shape, raw_buffers, dec_h, dec_w, out_h,
                      out_w, y0s, x0s, flips, channels, nthreads):
    lib = get_lib("rec_io")
    arrs = check_raw(raw_buffers, dec_h, dec_w, channels)
    y0s = np.ascontiguousarray(y0s, dtype=np.int32)
    x0s = np.ascontiguousarray(x0s, dtype=np.int32)
    flips = np.ascontiguousarray(flips, dtype=np.uint8)
    out = np.empty(out_shape, dtype=np.uint8)
    rc = getattr(lib, fname)(
        _ptrs(arrs), len(arrs), out.ctypes.data_as(P_U8), dec_h, dec_w,
        out_h, out_w, channels, y0s.ctypes.data_as(P_I32),
        x0s.ctypes.data_as(P_I32), flips.ctypes.data_as(P_U8), nthreads)
    if rc != 0:
        raise ValueError(f"{fname} rejected arguments ({rc})")
    return out


def crop_flip_u8_batch(raw_buffers, dec_h, dec_w, out_h, out_w, y0s, x0s,
                       flips, channels=3, nthreads=0):
    """Crop, mirror and NCHW over raw HWC uint8 records (the raw-record
    path of ``ImageRecordUInt8Iter``); uint8[n, channels, out_h, out_w]."""
    return _crop_flip_common(
        "crop_flip_u8_batch", (len(raw_buffers), channels, out_h, out_w),
        raw_buffers, dec_h, dec_w, out_h, out_w, y0s, x0s, flips, channels,
        nthreads)


def crop_flip_u8_nhwc_batch(raw_buffers, dec_h, dec_w, out_h, out_w, y0s,
                            x0s, flips, channels=3, nthreads=0):
    """As :func:`crop_flip_u8_batch`, NHWC: uint8[n, out_h, out_w,
    channels]."""
    return _crop_flip_common(
        "crop_flip_u8_nhwc_batch", (len(raw_buffers), out_h, out_w, channels),
        raw_buffers, dec_h, dec_w, out_h, out_w, y0s, x0s, flips, channels,
        nthreads)
