"""NDArray: a tensor on a device.

PyTorch counterpart of the part of ``mxnet_tpu/ndarray/ndarray.py`` that
``Module``, the executor and ``io.NDArrayIter`` hand to users, with
``save`` / ``load`` of NDArray files.  An
``NDArray`` wraps one ``torch.Tensor``; ``_set_data`` swaps the tensor
(the executor and optimizers update through it).  PyTorch runs eagerly,
so there is no lazy payload; ``wait_to_read`` synchronises the device.
A basic slice along axis 0 (``a[lo:hi]``) gives a view,
``copy()`` a copy, and :func:`take` gathers along an axis on the
array's device.  Other slicing, operator overloads, autograd recording
and the sparse types are not ported yet.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_device, cpu, gpu


def torch_dtype(dtype) -> torch.dtype:
    """numpy dtype / name / torch dtype -> torch dtype (``bfloat16`` by
    name, since numpy has none)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return dt


def numpy_dtype(dtype: torch.dtype):
    """torch dtype -> numpy dtype; bfloat16 has none and maps to the
    name ``"bfloat16"``."""
    if dtype == torch.bfloat16:
        return "bfloat16"
    return torch.empty((), dtype=dtype).numpy().dtype


class NDArray:
    """A tensor on a device (reference: python/mxnet/ndarray/ndarray.py)."""
    __slots__ = ("_data",)
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            arr = np.asarray(data)
            if dtype is None and arr.dtype == np.float64:
                dtype = np.float32
            data = torch.from_numpy(np.ascontiguousarray(arr))
        if dtype is not None:
            data = data.to(torch_dtype(dtype))
        if ctx is not None:
            data = data.to(as_device(ctx))
        self._data = data

    def _set_data(self, value: torch.Tensor):
        self._data = value

    def as_torch(self) -> torch.Tensor:
        """The wrapped tensor (no copy)."""
        return self._data

    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def ndim(self):
        return self._data.dim()

    def __getitem__(self, key):
        """A basic slice along axis 0 (step 1), as a view that shares the
        tensor."""
        if isinstance(key, slice) and key.step in (None, 1):
            return NDArray(self._data[key])
        raise MXNetError(f"NDArray indexing by {key!r}: only a slice "
                         "along axis 0 is ported")

    def copy(self) -> "NDArray":
        """A copy on the same device."""
        return NDArray(self._data.detach().clone())

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        dev = self._data.device
        return gpu(dev.index or 0) if dev.type == "cuda" else cpu()

    def asnumpy(self) -> np.ndarray:
        """A host copy (bf16 comes back as float32: numpy has no bf16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)

    def __repr__(self):
        return (f"<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context} {self.dtype}>")


def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray on ``ctx`` (default: the current context, ``gpu(0)``).
    Python lists and scalars default to float32; arrays keep their dtype
    (float64 becomes float32), as in the JAX package."""
    if dtype is None and not hasattr(source_array, "dtype"):
        dtype = np.float32
    if ctx is None:
        from ..context import current_context
        ctx = current_context()
    return NDArray(source_array, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    if isinstance(shape, numbers.Integral):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(shape),
                               dtype=torch_dtype(dtype or np.float32),
                               device=as_device(ctx)))


def take(a, indices, axis=0, mode="clip") -> NDArray:
    """The ``take`` op run imperatively on ``a``'s device (``indices`` is
    moved there), without autograd: rows of ``a`` along ``axis`` at the
    (truncated) ``indices``, clipped or wrapped per ``mode``."""
    from ..ops import registry as _reg
    idx = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(np.asarray(indices))
    with torch.no_grad():
        return NDArray(_reg.get("take").fn(
            a._data, idx.to(a._data.device), axis=axis, mode=mode))


def save(fname, data):
    """Write an NDArray, a list or a dict of NDArrays to ``fname`` in the
    format both packages read (:mod:`mxnet_tpu_torch.serialization`)."""
    from ..serialization import save_ndarrays
    save_ndarrays(fname, data)


def load(fname):
    """The list or dict of NDArrays in ``fname``, on the CPU."""
    from ..serialization import load_ndarrays
    return load_ndarrays(fname)
