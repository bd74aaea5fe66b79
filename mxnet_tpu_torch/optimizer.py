"""Optimizers.

PyTorch counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base
class (lr/wd multipliers, from ``__lr_mult__`` / ``__wd_mult__`` symbol
attributes too, ``rescale_grad``, ``clip_gradient``, update counts,
multi-precision master copies) and every optimizer of the JAX package
with its formulas: SGD (``ccsgd``), NAG, SGLD, DCASGD, Adam, AdaGrad,
RMSProp, AdaDelta, Ftrl, Adamax, Nadam, Signum, LARS, LAMB and Test.
Each optimizer's ``_update_impl(weight, grad, states, lr, wd[, t]) ->
(new_weight, new_states)`` is a function of torch tensors; it runs under
``torch.no_grad`` and returns new tensors, which ``update`` binds into
the weight's and the states' NDArrays (not an in-place update: the old
tensors are freed, and a tensor a caller still holds keeps its value).
A state slot may be None (DCASGD without momentum).  LARS's and LAMB's
layer-wise trust ratios are ``torch.where`` on the device, so an update
never waits for the card.  The JAX package runs no Pallas kernel here,
so plain torch ops are the port.

A row-sparse gradient (:mod:`mxnet_tpu_torch.ndarray.sparse`) takes the
lazy route of SGD (with or without momentum) and Adam (JAX package:
``optimizer.py:155-201,340-356,470-489``): only the rows it touches
change, in the weight and in its states; an empty one changes nothing;
every other optimizer densifies it (counted in ``DENSIFY_COUNT``).  The
lazy route has static shapes and never waits for the card.
"""
from __future__ import annotations

import copyreg
import io
import math
import pickle
from typing import Tuple

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray
from . import random as _rnd
from .ops.elemwise import _sign

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

    def __getstate__(self):
        """A pickled optimizer (``set_optimizer`` ships it to the
        dist_async servers) drops ``param_dict``: its Gluon Parameters
        reach the trainer and the store's sockets, and per-parameter
        multipliers are the worker's concern (JAX package
        ``optimizer.py:62``, the reference's ``__getstate__``)."""
        state = self.__dict__.copy()
        state["param_dict"] = {}
        return state

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
        if getattr(grad, "stype", "default") == "row_sparse":
            impl = getattr(self, "_update_impl_rsp", None)
            if impl is not None and grad.indices.shape[0] > 0:
                self._update_rows(impl, index, weight, grad, states, lr, wd,
                                  use_mp)
                return
            if grad.indices.shape[0] == 0:
                return  # nothing touched
            grad = NDArray(grad._data)  # the dense fallback (densifies)
        (new_w,), (new_st,) = self.apply_fused(
            (weight._data,), (grad._data,),
            (tuple(None if s is None else s._data for s in states),),
            (lr,), (wd,), (use_mp,), ts)
        weight._set_data(new_w)
        for s, v in zip(states, new_st):
            if s is not None:
                s._set_data(v)

    def _update_rows(self, impl, index, weight, grad, states, lr, wd,
                     use_mp):
        """The lazy update of the rows ``grad`` touches; multi-precision:
        on the fp32 master (``states[0]``), the weight recast from it."""
        vals, rows = grad.data._data, grad.indices._data
        with torch.no_grad():
            if use_mp:
                new_w32, new_sub = impl(
                    states[0]._data, vals.float(), rows,
                    tuple(s._data for s in states[1:]), lr, wd, index)
                states[0]._set_data(new_w32)
                weight._set_data(new_w32.to(weight._data.dtype))
                for s, v in zip(states[1:], new_sub):
                    s._set_data(v)
                return
            new_w, new_states = impl(weight._data, vals, rows,
                                     tuple(s._data for s in states), lr, wd,
                                     index)
        weight._set_data(new_w)
        for s, v in zip(states, new_states):
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
    def set_learning_rate(self, lr):
        """Set the base learning rate; refused, as in the JAX package,
        when an LRScheduler owns it."""
        if self.lr_scheduler is not None:
            raise UserWarning("LRScheduler of the optimizer has already been "
                              "defined.")
        self.lr = lr

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

    @staticmethod
    def _mult_index(index):
        """The multiplier key of ``index``: a dist_async big-array stripe
        arrives as ``<key>@s<i>``; its state keeps the full key, its
        lr / wd multipliers belong to the parameter (JAX package
        ``optimizer.py:258``)."""
        if isinstance(index, str) and "@s" in index:
            base = index.rsplit("@s", 1)[0]
            try:
                return int(base)
            except ValueError:
                return base
        return index

    def _get_lr(self, index):
        lr = (self.lr_scheduler(self.num_update)
              if self.lr_scheduler is not None else self.lr)
        index = self._mult_index(index)
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        index = self._mult_index(index)
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


class _Rows:
    """The rows a row-sparse gradient touches, for a lazy update without
    a wait on the card: ``dedup_rows`` sums the values of repeated ids
    and pads the rest of its slots with the row count n, where the JAX
    package's ``mode="drop"`` scatters and ``mode="fill"`` gathers
    discard them.  Clamping that id to n - 1 would overwrite a real
    row's state, so a padded slot points at the first slot's row (always
    real) instead: it adds -0.0 there, the identity of IEEE addition,
    and sets the first slot's own new value again."""

    def __init__(self, values, indices, n):
        from .ndarray.sparse import dedup_rows
        self.values, idx = dedup_rows(values, indices, n)
        real = idx != n
        self.ids = torch.where(real, idx, idx[0])
        self.real = real.reshape((-1,) + (1,) * (values.dim() - 1))

    def take(self, t):
        return t.index_select(0, self.ids)

    def add(self, t, upd):
        """``t`` with ``upd`` added at the real slots' rows."""
        upd = torch.where(self.real, upd, -0.0)
        return t.clone().index_add_(0, self.ids, upd)

    def set(self, t, new):
        """``t`` with the real slots' rows set to ``new``."""
        out = t.clone()
        out[self.ids] = torch.where(self.real, new, new[:1])
        return out


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

    def _update_impl_rsp(self, weight, values, indices, states, lr, wd,
                         index=0):
        """Lazy SGD: momentum and weight decay apply to the touched rows
        alone, their repeats summed first (reference: optimizer_op.cc
        SGDMomLazyUpdate; JAX package ``optimizer.py:340-356``)."""
        r = _Rows(values, indices, weight.shape[0])
        g = _clip(r.values * self.rescale_grad, self.clip_gradient)
        rows = r.take(weight)
        if self.momentum == 0.0 or not states:
            return r.add(weight, -lr * (g + wd * rows)), ()
        new_mom_rows = (self.momentum * r.take(states[0])
                        - lr * (g + wd * rows))
        return (r.add(weight, new_mom_rows),
                (r.set(states[0], new_mom_rows),))


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

    def _update_impl_rsp(self, weight, values, indices, states, lr, wd,
                         index=0):
        """Lazy Adam: the moments decay on the touched rows alone
        (reference: optimizer_op.cc AdamUpdateRspRspImpl; JAX package
        ``optimizer.py:470-489``), bias-corrected by the weight's update
        count."""
        mean, var = states
        t = self._index_update_count.get(index, self.num_update) or 1
        one = np.float32(1.0)
        coef1 = one - np.float32(self.beta1) ** t
        coef2 = one - np.float32(self.beta2) ** t
        lr = float(np.float32(lr) * np.sqrt(coef2) / coef1)
        r = _Rows(values, indices, weight.shape[0])
        g = (_clip(r.values * self.rescale_grad, self.clip_gradient)
             + wd * r.take(weight))
        new_m = self.beta1 * r.take(mean) + (1. - self.beta1) * g
        new_v = self.beta2 * r.take(var) + (1. - self.beta2) * g * g
        upd = -lr * new_m / (new_v.sqrt() + self.epsilon)
        return (r.add(weight, upd),
                (r.set(mean, new_m), r.set(var, new_v)))


def _l2norm(x):
    """The L2 norm of a tensor, at least in float32, as a 0-d tensor on
    its device: LARS's and LAMB's layer norms must not accumulate in
    bf16, and must not be read back."""
    return torch.linalg.vector_norm(
        x, dtype=torch.float32 if x.dtype in _LOW_PRECISION else None)


def _zeros_state(weight):
    return NDArray(torch.zeros_like(weight._data))


@register
class NAG(Optimizer):
    """Nesterov accelerated gradient (reference: optimizer.py NAG):
    ``g = clip(grad * rescale) + wd * w; mom = momentum * mom + g;
    w -= lr * (g + momentum * mom)``."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros_state(weight),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        if self.momentum == 0.0 or not states:
            return weight - lr * g, ()
        new_mom = self.momentum * states[0] + g
        return weight - lr * (g + self.momentum * new_mom), (new_mom,)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (reference: optimizer.py
    SGLD): ``w += -lr / 2 * (g + wd * w) + N(0, sqrt(lr))``.  The noise
    comes from one ``torch.Generator`` per device, seeded at its first
    use from :func:`mxnet_tpu_torch.random.generator`, so
    ``mt.random.seed`` fixes it; the draws are not the JAX package's."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._gens = {}

    def _generator(self, device):
        gen = self._gens.get(device)
        if gen is None:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=_rnd.generator()))
            gen = self._gens[device] = \
                torch.Generator(device).manual_seed(seed)
        return gen

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        noise = torch.randn(weight.shape, dtype=weight.dtype,
                            device=weight.device,
                            generator=self._generator(weight.device))
        return weight - lr / 2 * (g + wd * weight) \
            + noise * math.sqrt(lr), ()


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (reference: optimizer.py
    DCASGD): ``comp = g + wd * w + lamda * g * g * (w - w_prev)``; with
    momentum ``mom = momentum * mom - lr * comp; w += mom``, else
    ``w -= lr * comp``.  States: (momentum or None, the previous
    weight)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = NDArray(weight._data.clone())
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_state(weight), prev)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        mom, prev = states
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        comp = g + wd * weight + self.lamda * g * g * (weight - prev)
        if mom is not None:
            new_mom = self.momentum * mom - lr * comp
            return weight + new_mom, (new_mom, weight)
        return weight - lr * comp, (None, weight)


@register
class AdaGrad(Optimizer):
    """reference: optimizer.py AdaGrad: ``hist += g * g;
    w -= lr * (g / sqrt(hist + eps) + wd * w)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return (_zeros_state(weight),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        hist = states[0] + g * g
        w = weight - lr * (g / (hist + self.float_stable_eps).sqrt()
                           + wd * weight)
        return w, (hist,)


@register
class RMSProp(Optimizer):
    """reference: optimizer.py RMSProp (``centered=False``: Tieleman and
    Hinton; ``True``: Graves's variant with a mean of the gradient and a
    momentum of the step), optionally clipping the weights."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        n = 3 if self.centered else 1
        return tuple(_zeros_state(weight) for _ in range(n))

    def _clip_w(self, w):
        if self.clip_weights:
            return w.clamp(-self.clip_weights, self.clip_weights)
        return w

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        new_n = self.gamma1 * states[0] + (1 - self.gamma1) * g * g
        if not self.centered:
            w = weight - lr * g / (new_n + self.epsilon).sqrt()
            return self._clip_w(w), (new_n,)
        _, gm, delta = states
        new_g = self.gamma1 * gm + (1 - self.gamma1) * g
        new_delta = self.gamma2 * delta - lr * g / (
            new_n - new_g * new_g + self.epsilon).sqrt()
        return self._clip_w(weight + new_delta), (new_n, new_g, new_delta)


@register
class AdaDelta(Optimizer):
    """reference: optimizer.py AdaDelta (no learning rate):
    ``acc_g = rho * acc_g + (1 - rho) * g * g; delta = sqrt(acc_delta +
    eps) / sqrt(acc_g + eps) * g; acc_delta = rho * acc_delta + (1 - rho)
    * delta ** 2; w -= delta + wd * w``."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_state(weight), _zeros_state(weight))

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        acc_g, acc_delta = states
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        new_acc_g = self.rho * acc_g + (1. - self.rho) * g * g
        delta = (acc_delta + self.epsilon).sqrt() / \
            (new_acc_g + self.epsilon).sqrt() * g
        new_acc_delta = self.rho * acc_delta + (1. - self.rho) * delta * delta
        return weight - delta - wd * weight, (new_acc_g, new_acc_delta)


@register
class Ftrl(Optimizer):
    """Follow the regularized leader, proximal (reference: optimizer.py
    Ftrl): states z and n; a weight whose ``|z| <= lamda1`` is 0."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros_state(weight), _zeros_state(weight))   # z, n

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        z, n = states
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        new_n = n + g * g
        sigma = (new_n.sqrt() - n.sqrt()) / lr
        new_z = z + g - sigma * weight
        w = torch.where(
            new_z.abs() <= self.lamda1, torch.zeros_like(weight),
            -(new_z - _sign(new_z) * self.lamda1)
            / ((self.beta + new_n.sqrt()) / lr + wd))
        return w, (new_z, new_n)


@register
class Adamax(Optimizer):
    """reference: optimizer.py Adamax (Adam with the infinity norm):
    ``m = beta1 * m + (1 - beta1) * g; u = max(beta2 * u, |g|);
    w -= lr / (1 - beta1 ** t) * m / u``."""

    needs_t = True

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_state(weight), _zeros_state(weight))

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        lr = lr / (1. - self.beta1 ** t)
        m_t, u_t = states
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        new_m = self.beta1 * m_t + (1. - self.beta1) * g
        new_u = torch.maximum(self.beta2 * u_t, g.abs())
        return weight - lr * new_m / new_u, (new_m, new_u)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (reference: optimizer.py Nadam).  The
    momentum schedule's running product ``m_schedule`` is one number of
    the optimizer, advanced at every update of any weight, as in the
    reference."""

    needs_t = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.

    def create_state(self, index, weight):
        return (_zeros_state(weight), _zeros_state(weight))

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        momentum_t = self.beta1 * (1. - 0.5 * 0.96 **
                                   (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1. - 0.5 * 0.96 **
                                     ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        m_t, v_t = states
        g_prime = g / (1. - self.m_schedule)
        new_m = self.beta1 * m_t + (1. - self.beta1) * g
        new_v = self.beta2 * v_t + (1. - self.beta2) * g * g
        m_t_prime = new_m / (1. - m_schedule_next)
        v_t_prime = new_v / (1. - self.beta2 ** t)
        m_t_bar = (1. - momentum_t) * g_prime + momentum_t_1 * m_t_prime
        return weight - lr * m_t_bar / (v_t_prime.sqrt() + self.epsilon), \
            (new_m, new_v)


@register
class Signum(Optimizer):
    """Sign-based SGD (reference: the signsgd / signum update ops):
    without momentum ``w -= lr * sign(g)``; with it ``mom = momentum *
    mom - (1 - momentum) * g; w = (1 - lr * wd_lh) * w + lr *
    sign(mom)``."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return ()
        return (_zeros_state(weight),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient) + wd * weight
        if not states:
            return weight - lr * _sign(g), ()
        new_mom = self.momentum * states[0] - (1 - self.momentum) * g
        if self.wd_lh:
            w = (1 - lr * self.wd_lh) * weight + lr * _sign(new_mom)
        else:
            w = weight + lr * _sign(new_mom)
        return w, (new_mom,)


@register
class LARS(Optimizer):
    """Layer-wise adaptive rate scaling (You et al. 2017), the JAX
    package's large-batch SGD.  Per weight of two or more dims:

        trust = eta * ||w|| / (||g|| + wd * ||w|| + eps)  (1 if a norm is 0)
        mom   = momentum * mom - lr * trust * (g + wd * w)
        w    += mom

    Biases and BatchNorm's gamma and beta (one dim) take plain momentum
    SGD without weight decay.  The norms are float32 and the trust ratio
    is a ``torch.where`` on the weight's device: nothing is read back."""

    def __init__(self, learning_rate=0.1, momentum=0.9, eta=0.001,
                 epsilon=1e-9, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.eta = eta
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_state(weight),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        mom = states[0]
        if weight.dim() <= 1:
            new_mom = self.momentum * mom - lr * g
            return weight + new_mom, (new_mom,)
        w_norm = _l2norm(weight)
        g_norm = _l2norm(g)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wd * w_norm + self.epsilon),
            1.0).to(weight.dtype)
        new_mom = self.momentum * mom - lr * trust * (g + wd * weight)
        return weight + new_mom, (new_mom,)


@register
class LAMB(Optimizer):
    """Layer-wise adaptive Adam (You et al. 2019):

        m, v  = Adam's moments, bias-corrected by the update count t
        r     = m_hat / (sqrt(v_hat) + eps) + wd * w
        ratio = ||w|| / ||r||   (1 where either norm is 0)
        w    -= lr * ratio * r

    ``lower_bound`` / ``upper_bound`` clamp ``||w||``.  As in LARS the
    norms are float32 and the ratio stays on the device."""

    needs_t = True

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound

    def create_state(self, index, weight):
        return (_zeros_state(weight), _zeros_state(weight))

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        mean, var = states
        if t is None:
            t = max(self.num_update, 1)
        g = _clip(grad * self.rescale_grad, self.clip_gradient)
        m = self.beta1 * mean + (1. - self.beta1) * g
        v = self.beta2 * var + (1. - self.beta2) * g * g
        one = np.float32(1.0)
        m_hat = m / float(one - np.float32(self.beta1) ** t)
        v_hat = v / float(one - np.float32(self.beta2) ** t)
        r = m_hat / (v_hat.sqrt() + self.epsilon) + wd * weight
        w_norm = _l2norm(weight)
        if self.lower_bound is not None:
            w_norm = w_norm.clamp(min=self.lower_bound)
        if self.upper_bound is not None:
            w_norm = w_norm.clamp(max=self.upper_bound)
        r_norm = _l2norm(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            1.0).to(weight.dtype)
        return weight - lr * ratio * r, (m, v)


@register
class Test(Optimizer):
    """reference: optimizer.py Test, for unit tests:
    ``w += grad * rescale_grad``."""

    def create_state(self, index, weight):
        return (_zeros_state(weight),)

    def _update_impl(self, weight, grad, states, lr, wd, t=None):
        return weight + grad * self.rescale_grad, (states[0],)


# ccSGD is SGD in the reference's later versions
_OPT_REGISTRY["ccsgd"] = SGD


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
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
        self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def sync_state_context(self, state, context):
        """``state`` (an NDArray, or a tuple of them and None) moved to
        ``context``, as the JAX package's updater moves loaded states to
        the weight's context."""
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, (tuple, list)):
            return tuple(self.sync_state_context(i, context)
                         if i is not None else None for i in state)
        return state

    def get_states(self, dump_optimizer=False):
        if dump_optimizer:
            raise MXNetError("get_states(dump_optimizer=True): the "
                             "optimizer object does not cross packages")
        states = {k: tuple(None if st is None else
                           _JaxNDArray(_numpy_state(st))
                           for st in self.optimizer._state_tuple(v))
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
            k: tuple(None if st is None else
                     NDArray(np.ascontiguousarray(_state_value(st)))
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
                module == "copyreg" and name == "_reconstructor") or (
                (module, name) == ("_codecs", "encode")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"optimizer states: {module}.{name} "
                                     "is not a state array")


def _state_value(st):
    return np.asarray(st.value if isinstance(st, _JaxNDArray) else st)
