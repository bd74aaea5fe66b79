"""Runtime kernel compilation (``mx.rtc``): user CUDA kernels on NDArrays.

PyTorch counterpart of ``mxnet_tpu/rtc.py`` (reference:
python/mxnet/rtc.py, src/common/rtc.cc).  The capability is the JAX
package's: "write a custom kernel at runtime and call it on NDArrays".
On the card a user's kernel is CUDA source, as in the reference:

    mod = rtc.CudaModule(source, options=(), exports=())
    k = mod.get_kernel("doubler", "const float* x, float* y, int n")
    k.launch([x, y, n], mt.gpu(0), grid_dims, block_dims, shared_mem=0)

``get_kernel`` compiles the source with ``nvcc`` for ``sm_90a`` at its
first use, together with a generated ``extern "C"`` launcher that calls
``cudaLaunchKernel`` on the kernel's address (so templated or C++-named
kernels work too: ``get_kernel("axpy<float>", ...)``), into
``build/rtc/<hash>/`` beside the package, keyed by the source, the
options and the kernel; the library is loaded with ``ctypes``.
``launch`` runs on PyTorch's current stream and writes the output arrays
(the non-const pointer arguments) in place.  Nothing here runs without
CUDA: ``CudaModule`` raises, and ``launch`` raises on a CPU context or a
CPU array; no plain version stands in for a user's kernel.  Importing
this module builds nothing and creates no CUDA context.

:class:`CudaFunction` is the counterpart of the JAX package's
``PallasKernel``: it wraps ``fn(*tensors, **attrs)`` (typically a
closure that launches a :class:`CudaKernel`) as an NDArray op through
the dispatcher, so it records on the autograd tape like any op.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading

import numpy as np

from .base import MXNetError
from .ndarray import NDArray
from .ndarray.ndarray import array as nd_array

# C++ argument types a kernel signature may name (reference: rtc.py
# _DTYPE_CPP_TO_NP), and the ctypes type of each scalar
_DTYPE_CPP_TO_NP = {
    "float": np.float32, "double": np.float64, "__half": np.float16,
    "uint8_t": np.uint8, "int": np.int32, "int32_t": np.int32,
    "int8_t": np.int8, "char": np.int8, "int64_t": np.int64,
}
_CTYPE = {np.float32: ctypes.c_float, np.float64: ctypes.c_double,
          np.float16: ctypes.c_uint16, np.uint8: ctypes.c_uint8,
          np.int32: ctypes.c_int32, np.int8: ctypes.c_int8,
          np.int64: ctypes.c_int64}
_ARG = re.compile(r"^\s*(const)?\s*([\w_]+)\s*(\*)?\s*([\w_]+)?\s*$")

_lock = threading.Lock()


def parse_signature(signature):
    """``[(is_const, numpy dtype, is_pointer)]`` of a C prototype's
    argument list, e.g. ``"const float* x, float* y, int n"`` (reference:
    rtc.py get_kernel).  Raises on an argument that is not
    ``[const] type [*] [name]`` or on a type outside the table."""
    out = []
    for arg in re.sub(r"\s+", " ", signature).split(","):
        m = _ARG.match(arg)
        if not m or m.group(2) == "const":
            raise ValueError(f'Invalid function prototype "{arg}". Must be '
                             'in the form of "(const) type (*) (name)"')
        if m.group(2) not in _DTYPE_CPP_TO_NP:
            raise TypeError(f"Unsupported kernel argument type "
                            f"{m.group(2)!r}; supported: "
                            f"{sorted(_DTYPE_CPP_TO_NP)}")
        out.append((bool(m.group(1)), np.dtype(_DTYPE_CPP_TO_NP[m.group(2)]),
                    bool(m.group(3))))
    return out


def _launcher_source(source, name):
    return f"""{source}

#include <cuda_runtime.h>
extern "C" int mxrtc_launch(void** args, unsigned gx, unsigned gy,
                            unsigned gz, unsigned bx, unsigned by,
                            unsigned bz, unsigned shared_mem, void* stream,
                            int device) {{
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaLaunchKernel((const void*)&{name}, dim3(gx, gy, gz),
                               dim3(bx, by, bz), args, shared_mem,
                               (cudaStream_t)stream);
}}
extern "C" const char* mxrtc_error_string(int err) {{
  return cudaGetErrorString((cudaError_t)err);
}}
"""


def _build(source, options):
    """Compile ``source`` into a shared library (once per source and
    options) and load it."""
    from . import cuda_lib
    flags = [*cuda_lib.NVCC_FLAGS, *options]
    key = hashlib.sha256("\0".join([source, *flags]).encode()).hexdigest()
    out_dir = os.path.join(os.path.dirname(cuda_lib.BUILD_DIR), "rtc",
                           key[:16])
    path = os.path.join(out_dir, "librtc.so")
    with _lock:
        if not os.path.exists(path):
            os.makedirs(out_dir, exist_ok=True)
            src = os.path.join(out_dir, "kernel.cu")
            with open(src, "w") as f:
                f.write(source)
            tmp = f"{path}.tmp{os.getpid()}"
            res = subprocess.run([cuda_lib.find_nvcc(), *flags, "-o", tmp,
                                  src], capture_output=True, text=True)
            if res.returncode != 0:
                raise MXNetError(f"rtc: nvcc exited {res.returncode}:\n"
                                 f"{res.stdout}{res.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
    lib.mxrtc_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_uint] * 7 \
        + [ctypes.c_void_p, ctypes.c_int]
    lib.mxrtc_launch.restype = ctypes.c_int
    lib.mxrtc_error_string.argtypes = [ctypes.c_int]
    lib.mxrtc_error_string.restype = ctypes.c_char_p
    return lib, path


class CudaModule:
    """CUDA source compiled at runtime (reference: rtc.py CudaModule).
    ``options`` are extra ``nvcc`` flags; ``exports`` names kernels the
    module offers (any kernel of the source may be asked for)."""

    def __init__(self, source, options=(), exports=()):
        import torch
        if not torch.cuda.is_available():
            raise MXNetError("rtc.CudaModule: CUDA is not available; a "
                             "CUDA kernel runs only on the card")
        if isinstance(options, str):
            options = (options,)
        if isinstance(exports, str):
            exports = (exports,)
        self._source = source
        self._options = tuple(options)
        self._exports = tuple(exports)

    def get_kernel(self, name, signature):
        """The kernel ``name`` with the C prototype ``signature`` (its
        argument list), compiled now if it is not built yet."""
        if self._exports and name not in self._exports:
            raise MXNetError(f"rtc: {name!r} is not among the module's "
                             f"exports {list(self._exports)}")
        args = parse_signature(signature)
        lib, path = _build(_launcher_source(self._source, name),
                           self._options)
        return CudaKernel(lib, name, args, path)


class CudaKernel:
    """One compiled kernel (reference: rtc.py CudaKernel).  ``launches``
    counts its launches."""

    def __init__(self, lib, name, args, path):
        self._lib = lib
        self._name = name
        self._args = args
        self.path = path
        self.launches = 0

    def launch(self, args, ctx, grid_dims, block_dims, shared_mem=0):
        """Launch on ``ctx`` (a GPU context) with ``args`` in the
        signature's order: NDArrays (or CUDA tensors) of the declared
        dtype, contiguous, on ctx's device, for pointers; numbers for
        scalars."""
        import torch
        from .context import as_device
        device = as_device(ctx)
        if device.type != "cuda":
            raise MXNetError(f"rtc: kernel {self._name!r} launches on a GPU "
                             f"context, got {ctx}")
        if len(args) != len(self._args):
            raise MXNetError(f"rtc: {self._name!r} takes {len(self._args)} "
                             f"arguments, got {len(args)}")
        vals = []
        for i, (arg, (_, dtype, is_ptr)) in enumerate(zip(args,
                                                           self._args)):
            if is_ptr:
                t = arg._data if isinstance(arg, NDArray) else arg
                if not isinstance(t, torch.Tensor) or t.device != device:
                    raise MXNetError(f"rtc: argument {i} of {self._name!r} "
                                     f"must be an array on {device}")
                if str(t.dtype).split(".")[-1] != dtype.name:
                    raise MXNetError(f"rtc: argument {i} of {self._name!r} "
                                     f"is {t.dtype}, the signature says "
                                     f"{dtype.name}")
                if not t.is_contiguous():
                    raise MXNetError(f"rtc: argument {i} of {self._name!r} "
                                     "is not contiguous")
                vals.append(ctypes.c_void_p(t.data_ptr()))
            elif dtype == np.float16:
                vals.append(ctypes.c_uint16(
                    int(np.float16(arg).view(np.uint16))))
            else:
                vals.append(_CTYPE[dtype.type](dtype.type(arg).item()))
        ptrs = (ctypes.c_void_p * len(vals))(
            *[ctypes.cast(ctypes.pointer(v), ctypes.c_void_p) for v in vals])
        grid = (tuple(grid_dims) + (1, 1, 1))[:3]
        block = (tuple(block_dims) + (1, 1, 1))[:3]
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._lib.mxrtc_launch(ptrs, *grid, *block, int(shared_mem),
                                     stream, device.index or 0)
        if err != 0:
            raise MXNetError(
                f"rtc: launch of {self._name!r} failed: "
                f"{self._lib.mxrtc_error_string(err).decode()} ({err})")
        self.launches += 1


class CudaFunction:
    """Wrap ``fn(*tensors, **attrs) -> tensor`` as an NDArray op
    (the counterpart of the JAX package's ``PallasKernel``).  ``fn`` is
    typically a closure that allocates its output and launches a
    :class:`CudaKernel`; the wrapper converts NDArrays to tensors and
    back and, like every op, records under ``autograd.record()``."""

    def __init__(self, fn, name=None):
        if not callable(fn):
            raise MXNetError("CudaFunction: fn must be callable")
        self._fn = fn
        self.name = name or getattr(fn, "__name__", "cuda_function")

    def __call__(self, *args, **attrs):
        from .ndarray.ndarray import _invoke_fn
        inputs = [a if isinstance(a, NDArray) else nd_array(a)
                  for a in args]
        return _invoke_fn(lambda *vals: self._fn(*vals, **attrs), inputs)
