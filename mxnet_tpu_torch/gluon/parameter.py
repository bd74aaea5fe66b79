"""Gluon Parameter / ParameterDict.

PyTorch counterpart of ``mxnet_tpu/gluon/parameter.py`` (reference:
python/mxnet/gluon/parameter.py, Parameter :43, ParameterDict :416).  A
parameter owns one NDArray on one device (its context) and, unless its
``grad_req`` is ``null``, one gradient NDArray marked for autograd
(:func:`mxnet_tpu_torch.autograd.mark_variables`); the optimizer rebinds
the data NDArray's tensor, so the objects ``Trainer`` holds stay valid.
Deferred initialization is kept: shape entries of 0 are unknown until
the first forward's input shapes arrive.  Files are the NDArray-map
format both packages read and write (:mod:`mxnet_tpu_torch.serialization`).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..base import MXNetError
from ..context import Context, current_context
from ..ndarray import NDArray
from ..ndarray.ndarray import zeros as nd_zeros, array as nd_array, \
    torch_dtype, dtype_name
from .. import initializer as init_mod
from .. import autograd


class DeferredInitializationError(MXNetError):
    """Parameter used before its shape is known (parameter.py:35)."""


class Parameter:
    """A weight or bias with a lazily known shape and an initializer
    (reference: gluon/parameter.py:43)."""

    def __init__(self, name, grad_req='write', shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype='default', grad_stype='default'):
        if stype != 'default' or grad_stype != 'default':
            raise MXNetError(f"Parameter {name!r}: sparse storage "
                             f"(stype={stype!r}, grad_stype={grad_stype!r}) "
                             "is not ported yet (ROADMAP C2)")
        self.name = name
        self._grad_req = grad_req if differentiable else 'null'
        if isinstance(shape, int):
            shape = (shape,)
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._data: Optional[NDArray] = None
        self._grad: Optional[NDArray] = None
        self._deferred_init = None   # (init, ctx, default_init)
        self._trainer = None

    def __repr__(self):
        dt = dtype_name(self.dtype) if self.dtype is not None else None
        return f"Parameter {self.name} (shape={self.shape}, dtype={dt})"

    # -- grad_req --------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        assert req in ('write', 'add', 'null')
        if not self._differentiable:
            req = 'null'
        if self._grad_req == req:
            return
        self._grad_req = req
        if req == 'null':
            self._grad = None
            if self._data is not None:
                autograd.mark_variables([self._data], [None], ['null'])
        elif self._data is not None:
            self._init_grad()

    # -- init ------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """reference: parameter.py:303 initialize.  ``ctx`` (default: the
        current context, ``gpu(0)``) may be one Context or a list of one."""
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._data is not None and not force_reinit:
            return
        if ctx is None:
            ctx = current_context()
        if isinstance(ctx, Context):
            ctx = [ctx]
        if len(ctx) != 1:
            raise MXNetError(f"Parameter {self.name!r}: one context per "
                             "parameter (data parallelism over several "
                             "devices is ROADMAP D1)")
        if self.shape is None or any(s == 0 for s in self.shape):
            if self.allow_deferred_init:
                self._deferred_init = (init, ctx, default_init)
                return
            raise MXNetError(
                f"Cannot initialize Parameter {self.name!r}: unknown shape "
                f"{self.shape} and allow_deferred_init=False")
        self._finish_init(init, ctx, default_init)

    def _finish_init(self, init, ctx, default_init):
        data = nd_zeros(self.shape, dtype=torch_dtype(self.dtype),
                        ctx=ctx[0])
        explicit = init or self.init
        if isinstance(explicit, str):
            explicit = init_mod.create(explicit)
        if explicit is not None:
            # a per-parameter initializer applies whatever the name
            explicit._init_weight(init_mod.InitDesc(self.name), data)
        else:
            initializer = default_init
            if isinstance(initializer, str):
                initializer = init_mod.create(initializer)
            initializer(init_mod.InitDesc(self.name), data)
        self._data = data
        self._deferred_init = None
        if self._grad_req != 'null':
            self._init_grad()

    def _load_init(self, data, ctx=None):
        """Initialize from a file's value: shape and value both come from
        it (the model-zoo ``pretrained=True`` flow)."""
        shape = tuple(data.shape)
        if self.shape is not None:
            if len(self.shape) != len(shape) or any(
                    s not in (0, t) for s, t in zip(self.shape, shape)):
                raise MXNetError(
                    f"loading {self.name!r}: file shape {shape} "
                    f"incompatible with declared {self.shape}")
        self.shape = shape
        if ctx is None:
            ctx = self._deferred_init[1][0] if self._deferred_init \
                else current_context()
        t = data._data if isinstance(data, NDArray) \
            else torch.from_numpy(np.array(data))
        self._data = NDArray(t.detach().to(
            device=ctx.torch_device(),
            dtype=torch_dtype(self.dtype), copy=True))
        self._deferred_init = None
        if self._grad_req != 'null':
            self._init_grad()

    def _finish_deferred_init(self, shape):
        """Complete deferred init once the input-driven shape is known
        (reference: parameter.py:585)."""
        if self._deferred_init is None:
            raise DeferredInitializationError(self.name)
        if self.shape is not None and len(self.shape) == len(shape):
            merged = tuple(s if s != 0 else t
                           for s, t in zip(self.shape, shape))
        else:
            merged = tuple(shape)
        if any(s == 0 for s in merged):
            raise MXNetError(f"deferred init of {self.name!r}: shape "
                             f"{merged} still has unknown dims")
        self.shape = merged
        init, ctx, default_init = self._deferred_init
        self._finish_init(init, ctx, default_init)

    def _init_grad(self):
        self._grad = NDArray(torch.zeros_like(self._data._data.detach()))
        autograd.mark_variables([self._data], [self._grad],
                                [self._grad_req])

    # -- access ----------------------------------------------------------
    def _check_initialized(self):
        if self._data is not None:
            return
        if self._deferred_init is not None:
            raise DeferredInitializationError(
                f"Parameter {self.name!r} has not been initialized yet "
                f"because initialization was deferred (unknown shape). "
                f"Run a forward pass first")
        raise MXNetError(
            f"Parameter {self.name!r} has not been initialized. "
            f"You should initialize parameters (e.g. net.initialize()) "
            f"before use")

    def data(self, ctx=None) -> NDArray:
        self._check_initialized()
        return self._data

    def list_data(self):
        self._check_initialized()
        return [self._data]

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized()
        if self._grad is None:
            raise MXNetError(
                f"Cannot get gradient of Parameter {self.name!r}: "
                f"grad_req='null'")
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def list_ctx(self):
        self._check_initialized()
        return [self._data.context]

    def zero_grad(self):
        if self._grad is not None:
            self._grad[:] = 0

    def set_data(self, data):
        """Rebind the value (on the parameter's device, in its dtype)."""
        if self._data is None:
            if self._deferred_init is not None:
                self.shape = tuple(data.shape)
                init, ctx, default_init = self._deferred_init
                self._finish_init(init, ctx, default_init)
            else:
                self._check_initialized()
        t = data._data if isinstance(data, NDArray) \
            else nd_array(data, ctx=self._data.context)._data
        cur = self._data._data
        self._data._set_data(t.detach().to(device=cur.device,
                                           dtype=cur.dtype, copy=True))

    def reset_ctx(self, ctx):
        """Move the data (and gradient) to ``ctx``: one Context, or a list
        of one."""
        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise MXNetError("reset_ctx: one context per parameter "
                                 "(ROADMAP D1)")
            ctx = ctx[0]
        if self._data is None:
            if self._deferred_init is not None:
                init, _, default_init = self._deferred_init
                self._deferred_init = (init, [ctx], default_init)
            return
        dev = ctx.torch_device()
        self._data._set_data(self._data._data.detach().to(dev))
        if self._grad is not None:
            self._grad._set_data(self._grad._data.to(dev))

    def cast(self, dtype):
        """Cast the data and gradient to ``dtype`` (new NDArrays, marked
        again for autograd)."""
        self.dtype = dtype
        if self._data is not None:
            self._data = NDArray(self._data._data.detach().to(
                torch_dtype(dtype)))
            if self._grad is not None:
                self._grad = NDArray(self._grad._data.to(torch_dtype(dtype)))
                autograd.mark_variables([self._data], [self._grad],
                                        [self._grad_req])

    def place(self, mesh, rules=None):
        raise MXNetError("Parameter.place: mesh placement is not ported to "
                         "mxnet_tpu_torch yet (ROADMAP D1)")

    # -- symbol bridge ---------------------------------------------------
    def var(self):
        from .. import symbol as sym
        shape = self.shape
        if shape is not None and any(s == 0 for s in shape):
            shape = None   # unknown dims: graph inference fills them
        return sym.Variable(self.name, shape=shape, dtype=self.dtype)


class Constant(Parameter):
    """A non-differentiable parameter with a fixed value (reference:
    gluon/parameter.py Constant)."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = NDArray(np.asarray(value, dtype=np.float32)
                            if not hasattr(value, "dtype") else value)
        self.value = value

        class _CInit(init_mod.Initializer):
            def _init_weight(_self, _name, arr):
                arr[:] = value

        super().__init__(name, grad_req='null', shape=value.shape,
                         dtype=value.dtype, init=_CInit(),
                         differentiable=False)


class ParameterDict:
    """Prefix-scoped dict of Parameters (reference: parameter.py:416)."""

    def __init__(self, prefix='', shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    def __repr__(self):
        s = '\n'.join(f'  {v}' for v in self._params.values())
        return f"ParameterDict {self._prefix!r} (\n{s}\n)"

    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        if name in self._params:
            return self._params[name]
        if self._shared is not None and name in self._shared._params:
            self._params[name] = self._shared._params[name]
            return self._params[name]
        return None

    def get(self, name, **kwargs):
        """Get or create the Parameter named prefix + name (reference:
        parameter.py:472)."""
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for k, v in kwargs.items():
            existing = getattr(param, k, None)
            if existing is None:
                if v is not None:
                    setattr(param, k, v)
                continue
            if k == 'shape' and v is not None:
                v = tuple(v)
                if len(existing) == len(v):
                    param.shape = tuple(a if a != 0 else b
                                        for a, b in zip(existing, v))
                    continue
            if k == 'dtype' and v is not None and existing != v:
                raise AssertionError(f"Parameter {name!r} {k} mismatch: "
                                     f"{existing} vs {v}")
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._get_impl(name)
        if param is None:
            if value is None:
                raise MXNetError(f"no constant {name!r} and no value given")
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k!r}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """reference: parameter.py:800."""
        if init is None:
            init = init_mod.Uniform()
        for v in self._params.values():
            v.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for v in self._params.values():
            v.zero_grad()

    def reset_ctx(self, ctx):
        for v in self._params.values():
            v.reset_ctx(ctx)

    def place(self, mesh, rules=None):
        raise MXNetError("ParameterDict.place: mesh placement is not ported "
                         "to mxnet_tpu_torch yet (ROADMAP D1)")

    def setattr(self, name, value):
        for v in self._params.values():
            setattr(v, name, value)

    def save(self, filename, strip_prefix=''):
        """Write every parameter to ``filename`` (NDArray-map format)."""
        from .. import serialization
        arg = {}
        for p in self._params.values():
            if p._data is None:
                raise MXNetError(f"cannot save uninitialized param "
                                 f"{p.name!r}")
            nm = p.name
            if strip_prefix and nm.startswith(strip_prefix):
                nm = nm[len(strip_prefix):]
            arg[nm] = p._data
        serialization.save_ndarrays(filename, arg)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=''):
        """Load a file written by either package's ``save``."""
        from .. import serialization
        loaded = serialization.load_ndarrays(filename)
        loaded = {restore_prefix + k.split(':', 1)[-1]: v
                  for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError(f"param {name!r} missing in "
                                     f"{filename}")
        for name, v in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(
                    f"param {name!r} in file not in ParameterDict; "
                    f"set ignore_extra=True to skip")
            p = self._params[name]
            if p._data is None and p._deferred_init is None:
                p._load_init(v, ctx[0] if isinstance(ctx, (list, tuple))
                             else ctx)
            else:
                p.set_data(v)
