"""NDArray: the imperative tensor, and the imperative dispatcher.

PyTorch counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  An ``NDArray``
is a mutable handle over one ``torch.Tensor``: "mutation" rebinds the
handle to a new tensor (``_set_data``), never writes a tensor in place,
so a tensor autograd saved (or a caller holds) keeps its value.  PyTorch
runs eagerly, so there is no lazy payload; ``wait_to_read`` synchronises
the device.

Every operator overload and method goes through :func:`_invoke`, which
runs a registry op on the arrays' tensors: under ``autograd.record()``
with grad mode on (marked arrays become torch leaves, see
:mod:`mxnet_tpu_torch.autograd`), otherwise under ``torch.no_grad``.  It
passes ``is_train`` from ``autograd.is_training()``, the device's
generator to ops that draw random numbers, and writes an op's trailing
auxiliary outputs (BatchNorm's moving statistics) back into its
auxiliary inputs, without autograd, in the inputs' dtype.  Sparse
storage types are not ported (ROADMAP C2).
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, as_device, cpu, current_context, gpu
from .. import autograd as _ag
from .. import random as _random
from ..ops import registry as _reg


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


def dtype_name(dtype) -> str:
    """A dtype (numpy, torch or a name) as its name."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    if isinstance(dtype, str):
        return dtype
    return np.dtype(dtype).name


_SPARSE = ("sparse storage types (row_sparse, csr) are not ported to "
           "mxnet_tpu_torch yet (ROADMAP C2)")


class NDArray:
    """A tensor on a device (reference: python/mxnet/ndarray/ndarray.py)."""
    __slots__ = ("_data", "_grad", "_grad_req", "__weakref__")
    # make NumPy defer to the reflected operators (np_array + nd works)
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
        self._grad = None
        self._grad_req = "null"

    def _set_data(self, value: torch.Tensor):
        self._data = value

    def as_torch(self) -> torch.Tensor:
        """The wrapped tensor (no copy)."""
        return self._data

    # -- properties ------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def size(self):
        return int(self._data.numel())

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def dtype(self):
        return numpy_dtype(self._data.dtype)

    @property
    def context(self) -> Context:
        dev = self._data.device
        return gpu(dev.index or 0) if dev.type == "cuda" else cpu()

    ctx = context

    @property
    def stype(self):
        return "default"

    @property
    def T(self):
        return self.transpose()

    @property
    def grad(self):
        return self._grad

    # -- conversions -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        """A host copy (bf16 comes back as float32: numpy has no bf16)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def astype(self, dtype, copy=True):
        return _invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def copy(self) -> "NDArray":
        """A copy on the same device (differentiable under record)."""
        return _invoke_fn(lambda d: d.clone(), [self])

    def copyto(self, other):
        """Copy into ``other`` (an NDArray, keeping its device) or onto a
        Context (reference: NDArray::CopyFromTo)."""
        if isinstance(other, NDArray):
            other._set_data(self._data.detach().to(other._data.device,
                                                   copy=True))
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device(),
                                                  copy=True))
        raise TypeError(type(other))

    def as_in_context(self, context: Context):
        if context == self.context:
            return self
        return NDArray(self._data.detach().to(as_device(context)))

    def tostype(self, stype):
        if stype == "default":
            return self
        raise MXNetError(_SPARSE)

    def detach(self):
        return NDArray(self._data.detach())

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    wait_to_write = wait_to_read

    # -- autograd --------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Mark this array as a variable with a zeroed gradient buffer
        (reference: ndarray.py attach_grad)."""
        if stype not in (None, "default"):
            raise MXNetError(f"attach_grad(stype={stype!r}): {_SPARSE}")
        self._data = self._data.detach()
        self._grad = NDArray(torch.zeros_like(self._data))
        self._grad_req = grad_req

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        _ag.backward([self], [out_grad] if out_grad is not None else None,
                     retain_graph=retain_graph, train_mode=train_mode)

    # -- indexing --------------------------------------------------------
    def __getitem__(self, key):
        key = _index_key(key, self._data.device)
        if isinstance(key, tuple) and all(isinstance(k, slice) for k in key) \
                or isinstance(key, slice):
            from ..ops.matrix import _basic_slice
            full = key if isinstance(key, tuple) else (key,)
            return _invoke_fn(lambda d: _basic_slice(d, full), [self])
        return _invoke_fn(lambda d: d[key], [self])

    def __setitem__(self, key, value):
        """Rebind to a copy with ``key`` set (not recorded, as in the JAX
        package: the new value is a constant to autograd)."""
        if isinstance(value, NDArray):
            value = value._data
        t = self._data.detach()
        with torch.no_grad():
            v = torch.as_tensor(value, dtype=t.dtype, device=t.device)
            if key is Ellipsis or (isinstance(key, slice)
                                   and key == slice(None)):
                self._set_data(v.expand(t.shape).clone())
                return
            new = t.clone()
            new[_index_key(key, t.device)] = v
        self._set_data(new)

    # -- python protocol -------------------------------------------------
    def __len__(self):
        return self.shape[0] if self.ndim else 0

    def __bool__(self):
        if self.size != 1:
            raise ValueError("ambiguous truth value of multi-element "
                             "NDArray")
        return bool(self.asscalar())

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return (f"<NDArray {'x'.join(map(str, self.shape))} "
                f"@{self.context} {self.dtype}>")

    def __hash__(self):
        return id(self)

    # -- arithmetic (through the registry, so autograd sees it) ----------
    def _binop(self, other, op, scalar_op, rop=False):
        if isinstance(other, numbers.Number) and not isinstance(other, bool):
            return _invoke(scalar_op, [self], {"scalar": float(other)})
        if isinstance(other, (NDArray, np.ndarray, torch.Tensor)):
            a, b = (other, self) if rop else (self, other)
            return _invoke(op, [a, b], {})
        return NotImplemented

    def __add__(self, o): return self._binop(o, "broadcast_add", "_plus_scalar")
    __radd__ = __add__
    def __sub__(self, o): return self._binop(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binop(o, "broadcast_sub", "_rminus_scalar", rop=True)
    def __mul__(self, o): return self._binop(o, "broadcast_mul", "_mul_scalar")
    __rmul__ = __mul__
    def __truediv__(self, o): return self._binop(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binop(o, "broadcast_div", "_rdiv_scalar", rop=True)
    __div__ = __truediv__
    __rdiv__ = __rtruediv__
    def __mod__(self, o): return self._binop(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binop(o, "broadcast_mod", "_rmod_scalar", rop=True)
    def __pow__(self, o): return self._binop(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binop(o, "broadcast_power", "_rpower_scalar", rop=True)
    def __neg__(self): return _invoke("negative", [self], {})
    def __abs__(self): return _invoke("abs", [self], {})
    def __matmul__(self, o): return _invoke("dot", [self, o], {})

    def __eq__(self, o): return self._binop(o, "broadcast_equal", "_equal_scalar")
    def __ne__(self, o): return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")
    def __gt__(self, o): return self._binop(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binop(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binop(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binop(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    # in place: rebind to the result (the recorded tensor stays intact)
    def __iadd__(self, o):
        self._set_data(self.__add__(o)._data)
        return self

    def __isub__(self, o):
        self._set_data(self.__sub__(o)._data)
        return self

    def __imul__(self, o):
        self._set_data(self.__mul__(o)._data)
        return self

    def __itruediv__(self, o):
        self._set_data(self.__truediv__(o)._data)
        return self

    __idiv__ = __itruediv__

    def __imod__(self, o):
        self._set_data(self.__mod__(o)._data)
        return self

    def __ipow__(self, o):
        self._set_data(self.__pow__(o)._data)
        return self

    # -- method versions of ops ------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        return _invoke("Reshape", [self], {"shape": shape, **kwargs})

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _invoke("transpose", [self], {"axes": axes})

    def flatten(self):
        return _invoke("Flatten", [self], {})

    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def squeeze(self, axis=None):
        return _invoke("squeeze", [self], {"axis": axis})

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": shape})

    def slice(self, begin, end, step=()):
        return _invoke("slice", [self], {"begin": begin, "end": end,
                                         "step": step})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self], {"axis": axis, "begin": begin,
                                              "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return take(self, indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return _invoke("pick", [self, index], {"axis": axis,
                                               "keepdims": keepdims})

    def one_hot(self, depth, **kw):
        return _invoke("one_hot", [self], {"depth": depth, **kw})

    def clip(self, a_min, a_max):
        return _invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def abs(self): return _invoke("abs", [self], {})
    def sign(self): return _invoke("sign", [self], {})
    def sqrt(self): return _invoke("sqrt", [self], {})
    def square(self): return _invoke("square", [self], {})
    def exp(self): return _invoke("exp", [self], {})
    def log(self): return _invoke("log", [self], {})
    def tanh(self): return _invoke("tanh", [self], {})
    def sigmoid(self): return _invoke("sigmoid", [self], {})
    def relu(self): return _invoke("relu", [self], {})
    def softmax(self, axis=-1): return _invoke("softmax", [self], {"axis": axis})
    def log_softmax(self, axis=-1): return _invoke("log_softmax", [self], {"axis": axis})

    def _reduce(self, name, axis=None, keepdims=False, **kw):
        return _invoke(name, [self], {"axis": axis, "keepdims": keepdims,
                                      **kw})

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return _invoke("norm", [self], {"ord": ord, "axis": axis,
                                        "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    def argsort(self, axis=-1, is_ascend=True):
        return _invoke("argsort", [self], {"axis": axis,
                                           "is_ascend": is_ascend})

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        return _invoke("topk", [self], {"axis": axis, "k": k,
                                        "ret_typ": ret_typ,
                                        "is_ascend": is_ascend})

    def sort(self, axis=-1, is_ascend=True):
        return _invoke("sort", [self], {"axis": axis, "is_ascend": is_ascend})

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def flip(self, axis):
        return _invoke("flip", [self], {"axis": axis})

    def tile(self, reps):
        return _invoke("tile", [self], {"reps": reps})

    def repeat(self, repeats, axis=None):
        return _invoke("repeat", [self], {"repeats": repeats, "axis": axis})

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return _invoke("SliceChannel", [self],
                       {"num_outputs": num_outputs, "axis": axis,
                        "squeeze_axis": squeeze_axis})

    def dot(self, other, **kw):
        return _invoke("dot", [self, other], kw)


def _index_key(key, device):
    """An indexing key with NDArrays (and integer arrays) as int64
    tensors on ``device``."""
    if isinstance(key, tuple):
        return tuple(_index_key(k, device) for k in key)
    if isinstance(key, NDArray):
        return key._data.to(device=device, dtype=torch.int64)
    if isinstance(key, (np.ndarray, list)):
        return torch.as_tensor(np.asarray(key), device=device)
    return key


# ===========================================================================
# The imperative dispatcher (reference: Imperative::Invoke)
# ===========================================================================
def _as_inputs(inputs):
    """NDArrays as they are; tensors, numpy arrays and scalars as NDArrays
    on the device of the first NDArray input."""
    dev = next((x._data.device for x in inputs if isinstance(x, NDArray)),
               None)
    out = []
    for x in inputs:
        if not isinstance(x, NDArray):
            x = NDArray(x)
            if dev is not None:
                x._data = x._data.to(dev)
        out.append(x)
    return out


def _outputs(outs, out):
    if out is None:
        return [NDArray(v) for v in outs]
    arrays = [out] if isinstance(out, NDArray) else list(out)
    for a, v in zip(arrays, outs):
        a._set_data(v)
    return arrays


def _invoke_fn(fn, inputs):
    """Run a plain function of the inputs' tensors, recorded like an op
    (indexing, ``copy``)."""
    recording = _ag.is_recording()
    vals = [_ag.variable_tensor(x) if recording else x._data
            for x in inputs]
    with torch.set_grad_enabled(recording):
        return NDArray(fn(*vals))


def _invoke(op_name: str, inputs, attrs, out=None, ctx=None):
    """Run a registered op imperatively (``is_train``, the random
    generator and the aux write-back as the module docstring says)."""
    opdef = _reg.get(op_name)
    _reg.record_execution(op_name)
    inputs = _as_inputs(inputs)
    kwargs = {k: v for k, v in attrs.items()
              if v is not None or k == "axis"}
    is_train = _ag.is_training()
    if opdef.takes_is_train:
        kwargs["is_train"] = is_train
    device = inputs[0]._data.device if inputs else as_device(ctx)
    if not inputs:
        kwargs["device"] = device
    if opdef.needs_rng:
        kwargs["generator"] = _random.device_generator(device)
    recording = _ag.is_recording()
    vals = [_ag.variable_tensor(x) if recording else x._data
            for x in inputs]
    with torch.set_grad_enabled(recording):
        outs = opdef.fn(*vals, **kwargs)
    if not isinstance(outs, (tuple, list)):
        outs = (outs,)
    if opdef.num_aux and opdef.takes_is_train and is_train:
        # trailing outputs: new aux values, into the aux inputs
        for aux, v in zip(inputs[-opdef.num_aux:], outs[-opdef.num_aux:]):
            aux._set_data(v.detach().to(aux._data.dtype))
        outs = outs[:-opdef.num_aux]
    nvis = opdef.num_visible
    if callable(nvis):  # attr-dependent (reference NumVisibleOutputs)
        nvis = nvis(attrs)
    if nvis is not None and nvis > 0:
        outs = outs[:nvis]
    arrays = _outputs(outs, out)
    return arrays[0] if len(arrays) == 1 else arrays


# ===========================================================================
# creation / free functions
# ===========================================================================
def array(source_array, ctx=None, dtype=None) -> NDArray:
    """An NDArray on ``ctx`` (default: the current context, ``gpu(0)``).
    Python lists and scalars default to float32; arrays keep their dtype
    (float64 becomes float32), as in the JAX package."""
    if dtype is None and not hasattr(source_array, "dtype"):
        dtype = np.float32
    return NDArray(source_array, ctx=ctx or current_context(), dtype=dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, numbers.Integral) else tuple(shape)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx=ctx, dtype=dtype)


def zeros(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.zeros(_shape(shape),
                               dtype=torch_dtype(dtype or np.float32),
                               device=as_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.ones(_shape(shape),
                              dtype=torch_dtype(dtype or np.float32),
                              device=as_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kw) -> NDArray:
    return NDArray(torch.full(_shape(shape), float(val),
                              dtype=torch_dtype(dtype or np.float32),
                              device=as_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None):
    return _invoke("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "dtype": dtype_name(dtype or "float32")},
                   ctx=ctx)


def concatenate(arrays, axis=0, always_copy=True):
    return _invoke("Concat", list(arrays), {"dim": axis})


def stack_arrays(arrays, axis=0):
    return _invoke("stack", list(arrays), {"axis": axis})


def onehot_encode(indices, out):
    res = _invoke("one_hot", [indices], {"depth": out.shape[1]})
    out._set_data(res._data.to(out._data.dtype))
    return out


def moveaxis(tensor, source, destination):
    return _invoke_fn(lambda d: d.movedim(source, destination), [tensor])


def waitall():
    """reference: Engine::WaitForAll — wait for the card's queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def take(a, indices, axis=0, mode="clip") -> NDArray:
    """The ``take`` op on ``a``'s device (``indices`` is moved there):
    rows of ``a`` along ``axis`` at the (truncated) ``indices``, clipped
    or wrapped per ``mode``; recorded like any op."""
    idx = indices._data if isinstance(indices, NDArray) \
        else torch.as_tensor(np.asarray(indices))
    return _invoke("take", [a, NDArray(idx.to(a._data.device))],
                   {"axis": axis, "mode": mode})


def save(fname, data):
    """Write an NDArray, a list or a dict of NDArrays to ``fname`` in the
    format both packages read (:mod:`mxnet_tpu_torch.serialization`)."""
    from ..serialization import save_ndarrays
    save_ndarrays(fname, data)


def load(fname):
    """The list or dict of NDArrays in ``fname``, on the CPU."""
    from ..serialization import load_ndarrays
    return load_ndarrays(fname)
