"""Optimizers (subset).

PyTorch counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base
class (lr/wd multipliers, ``rescale_grad``, ``clip_gradient``, update
counts, multi-precision master copies), ``SGD`` (momentum, wd) and
``Adam`` (bias correction by update count), with the JAX package's
formulas.  Each optimizer's ``_update_impl(weight, grad, states, lr, wd)
-> (new_weight, new_states)`` is a function of torch tensors; it runs
under ``torch.no_grad`` and returns new tensors, which ``update`` binds
into the weight's and the states' NDArrays (not an in-place update: the
old tensors are freed, and a tensor a caller still holds keeps its
value).  The JAX package runs no Pallas kernel here, so plain torch ops
are the port.
"""
from __future__ import annotations

import copyreg
import io
import pickle
from typing import Tuple

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

_OPT_REGISTRY = {}

_LOW_PRECISION = (torch.float16, torch.bfloat16)


class Optimizer:
    """Base optimizer (reference: optimizer.py Optimizer)."""

    needs_t = False   # _update_impl takes the update count

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise ValueError("param_idx2name should be a dict of param "
                             "indexes to names.")
        self.idx2name = param_idx2name.copy()
        self.sym = sym
        self.param_dict = param_dict or {}
        self.set_lr_mult({})
        self.set_wd_mult({})

    # -- registry --------------------------------------------------------------
    @staticmethod
    def register(klass):
        _OPT_REGISTRY[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        try:
            klass = _OPT_REGISTRY[name.lower()]
        except KeyError:
            raise MXNetError(f"unknown optimizer {name!r}; registered: "
                             f"{sorted(_OPT_REGISTRY)}")
        return klass(**kwargs)

    # -- state -------------------------------------------------------------------
    def create_state(self, index, weight) -> Tuple:
        """The (possibly empty) tuple of state arrays for a weight."""
        return ()

    def create_state_multi_precision(self, index, weight):
        """With ``multi_precision``, a float16/bfloat16 weight gets an
        fp32 master copy prepended to its states; the update runs on the
        master and recasts the weight from it."""
        if self.multi_precision and weight._data.dtype in _LOW_PRECISION:
            w32 = NDArray(weight._data.float())
            return (w32,) + tuple(self.create_state(index, w32))
        return tuple(self.create_state(index, weight))

    def mp_states_active(self, weight, states):
        """True when ``states`` carry an fp32 master copy of a
        low-precision ``weight``."""
        return (self.multi_precision
                and weight._data.dtype in _LOW_PRECISION
                and bool(states) and states[0] is not None
                and tuple(states[0].shape) == tuple(weight.shape))

    # -- the update ------------------------------------------------------------
    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        raise NotImplementedError

    def apply_fused(self, ws, gs, states, lrs, wds, use_mp, ts=None):
        """``_update_impl`` over lists of tensors, with the
        multi-precision contract: where ``use_mp``, the update runs on
        ``states[0]`` (the fp32 master) and the weight is recast from it.
        ``ts`` are per-weight update counts for optimizers that need them.
        Returns ``(new_weights, new_states)``."""
        new_ws, new_sts = [], []
        with torch.no_grad():
            for i, (w, g, st, lr, wd, mp) in enumerate(
                    zip(ws, gs, states, lrs, wds, use_mp)):
                kw = {"t": ts[i]} if ts is not None else {}
                if mp:
                    nw32, ns = self._update_impl(st[0], g.float(),
                                                 tuple(st[1:]), lr, wd, **kw)
                    new_ws.append(nw32.to(w.dtype))
                    new_sts.append((nw32,) + tuple(ns))
                else:
                    nw, ns = self._update_impl(w, g, tuple(st), lr, wd, **kw)
                    new_ws.append(nw)
                    new_sts.append(tuple(ns))
        return tuple(new_ws), tuple(new_sts)

    def update(self, index, weight, grad, state):
        """Update one weight (NDArrays) in its NDArray; ``state`` as
        :meth:`create_state_multi_precision` made it."""
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        states = self._state_tuple(state)
        ts = ((self._index_update_count[index],) if self.needs_t else None)
        use_mp = self.mp_states_active(weight, states)
        (new_w,), (new_st,) = self.apply_fused(
            (weight._data,), (grad._data,), (tuple(s._data for s in states),),
            (lr,), (wd,), (use_mp,), ts)
        weight._set_data(new_w)
        for s, v in zip(states, new_st):
            s._set_data(v)

    def update_multi_precision(self, index, weight, grad, state):
        self.update(index, weight, grad, state)

    @staticmethod
    def _state_tuple(state):
        if state is None:
            return ()
        if isinstance(state, (list, tuple)):
            return tuple(state)
        return (state,)

    # -- lr / wd ---------------------------------------------------------------
    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """No weight decay on parameters other than ``*_weight`` and
        ``*_gamma`` (biases, betas), unless a ``__wd_mult__`` attribute
        or ``args_wd_mult`` says otherwise."""
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym is not None:
            attr = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register
create = Optimizer.create_optimizer


def _clip(g, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return g.clamp(-clip_gradient, clip_gradient)
    return g


@register
class SGD(Optimizer):
    """SGD with momentum and weight decay (reference: optimizer.py SGD):
    ``mom = momentum * mom - lr * (g + wd * w); w += mom`` with
    ``g = clip(grad * rescale_grad)``; plain ``w -= lr * (g + wd * w)``
    without momentum."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (NDArray(torch.zeros_like(weight._data)),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        if self.momentum == 0.0 or not states:
            return weight - lr * (g + wd * weight), ()
        new_mom = self.momentum * states[0] - lr * (g + wd * weight)
        return weight + new_mom, (new_mom,)


@register
class Adam(Optimizer):
    """reference: optimizer.py Adam — bias correction by the weight's
    update count t: ``lr_t = lr * sqrt(1 - beta2**t) / (1 - beta1**t)``
    (in float32, as the JAX package takes it)."""

    needs_t = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (NDArray(torch.zeros_like(weight._data)),
                NDArray(torch.zeros_like(weight._data)))

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        mean, var = states
        if t is None:
            t = max(self.num_update, 1)
        one = np.float32(1.0)
        coef1 = one - np.float32(self.beta1) ** t
        coef2 = one - np.float32(self.beta2) ** t
        lr = float(np.float32(lr) * np.sqrt(coef2) / coef1)
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        m = self.beta1 * mean + (1. - self.beta1) * g
        v = self.beta2 * var + (1. - self.beta2) * g * g
        return weight - lr * m / (v.sqrt() + self.epsilon), (m, v)


class Updater:
    """Applies an optimizer per keyed weight, creating each key's state at
    its first update (reference: optimizer.py get_updater/Updater).

    ``get_states`` / ``set_states`` read and write the JAX package's
    ``Updater`` blob: a pickle of ``{index: tuple of NDArray}`` whose
    arrays are the JAX package's NDArray class over a numpy value, so
    either package's Gluon ``Trainer`` loads the other's file.  The port
    writes that class by name without importing it, and reads it (and a
    JAX array inside it) through an unpickler that admits only those
    names, numpy's and a few builtins; bfloat16 states are written as
    float32, since numpy has no bfloat16."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        elif not self.states_synced.get(index, True):
            dev = weight._data.device
            self.states[index] = tuple(
                NDArray(st._data.to(dev)) for st in
                self.optimizer._state_tuple(self.states[index]))
        self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def get_states(self, dump_optimizer=False):
        if dump_optimizer:
            raise MXNetError("get_states(dump_optimizer=True): the "
                             "optimizer object does not cross packages")
        states = {k: tuple(_JaxNDArray(_numpy_state(st)) for st in
                           self.optimizer._state_tuple(v))
                  for k, v in self.states.items()}
        buf = io.BytesIO()
        _StatePickler(buf, protocol=2).dump(states)
        return buf.getvalue()

    def set_states(self, states):
        """``states``: a blob of :meth:`get_states` of either package
        (unpickled: load only files this program or the JAX package
        wrote)."""
        if isinstance(states, (bytes, bytearray)):
            states = _StateUnpickler(io.BytesIO(states)).load()
        if isinstance(states, tuple) and len(states) == 2:
            states = states[0]
        self.states = {
            k: tuple(NDArray(np.ascontiguousarray(_state_value(st)))
                     for st in self.optimizer._state_tuple(v))
            for k, v in states.items()}
        self.states_synced = dict.fromkeys(self.states, False)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)


# --------------------------------------------------------------------------
# the JAX package's Updater blob
# --------------------------------------------------------------------------
_JAX_NDARRAY = ("mxnet_tpu.ndarray.ndarray", "NDArray")
_JAX_ARRAY = ("jax._src.array", "_reconstruct_array")
_SAFE_BUILTINS = {"tuple", "list", "dict", "set", "frozenset", "int",
                  "float", "bool", "complex", "bytes", "str", "object"}


class _JaxNDArray:
    """The JAX package's NDArray class in a pickle: written by its name
    with a numpy payload (its other slots empty), read back as this
    class with the payload in ``value``."""

    def __init__(self, value=None):
        self.value = value

    def __reduce_ex__(self, protocol):
        return (copyreg.__newobj__, (_JaxNDArray,), (None, {
            "_payload": self.value, "_thunk": None, "_handle": None,
            "_ctx": None, "_grad": None, "_grad_req": "null",
            "_deferred_init": None}))

    def __setstate__(self, state):
        slots = state[1] if isinstance(state, tuple) else state
        self.value = slots.get("_payload")


def _numpy_state(arr):
    """An optimizer state as numpy (bfloat16 as float32)."""
    t = arr._data.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class _StatePickler(pickle._Pickler):
    def save_global(self, obj, name=None):
        if obj is _JaxNDArray:
            self.write(pickle.GLOBAL + ("%s\n%s\n" % _JAX_NDARRAY).encode())
            self.memoize(obj)
            return
        super().save_global(obj, name)


def _reconstruct_array(fun, args, arr_state, aval_state):
    """A JAX array's pickle, as the numpy array it carries."""
    arr = fun(*args)
    arr.__setstate__(arr_state)
    return arr


class _StateUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_NDARRAY:
            return _JaxNDArray
        if (module, name) == _JAX_ARRAY:
            return _reconstruct_array
        if module.split(".")[0] == "numpy" or (
                module == "builtins" and name in _SAFE_BUILTINS) or (
                module == "copyreg" and name == "_reconstructor"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"optimizer states: {module}.{name} "
                                     "is not a state array")


def _state_value(st):
    return np.asarray(st.value if isinstance(st, _JaxNDArray) else st)
