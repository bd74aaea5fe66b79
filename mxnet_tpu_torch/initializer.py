"""Weight initializers (subset).

PyTorch counterpart of ``mxnet_tpu/initializer.py``: the parameter's
*name* picks the rule (``*_weight`` -> the initializer's weight rule,
``*_bias`` and ``*_beta`` -> 0, ``*_gamma`` -> 1, moving statistics ->
0/1), as in the reference's ``Initializer.__call__``; an ``__init__``
attribute on a variable overrides it (``Module.init_params`` reads it).
Random values are drawn on the CPU from :func:`mxnet_tpu_torch.random.
generator` (``mt.random.seed``) in float32 and then copied to the
array's device and dtype, so one seed gives the same weights on the CPU
and on the card; they are not the JAX package's bits.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError
from . import random as _rnd

_INIT_REGISTRY = {}


class InitDesc(str):
    """Name + attrs passed to initializers (reference: initializer.py
    InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


def register(klass):
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    try:
        return _INIT_REGISTRY[name.lower()](**kwargs)
    except KeyError:
        raise MXNetError(f"unknown initializer {name!r}; registered: "
                         f"{sorted(_INIT_REGISTRY)}")


class Initializer:
    """Base initializer (reference: initializer.py Initializer)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string (InitDesc)")
        if desc.endswith("weight"):
            self._init_weight(desc, arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
        elif desc.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif desc.endswith("beta"):
            self._init_beta(desc, arr)
        elif desc.endswith("min"):
            self._init_zero(desc, arr)
        elif desc.endswith("max"):
            self._init_one(desc, arr)
        elif desc.endswith(("running_mean", "moving_mean",
                            "moving_inv_var", "moving_avg")):
            self._init_zero(desc, arr)
        elif desc.endswith(("running_var", "moving_var")):
            self._init_one(desc, arr)
        else:
            self._init_default(desc, arr)

    @staticmethod
    def _set(arr, value: torch.Tensor):
        t = arr._data
        arr._set_data(value.to(device=t.device, dtype=t.dtype))

    def _init_zero(self, name, arr):
        self._set(arr, torch.zeros(arr.shape))

    def _init_one(self, name, arr):
        self._set(arr, torch.ones(arr.shape))

    def _init_bias(self, name, arr):
        self._init_zero(name, arr)

    def _init_gamma(self, name, arr):
        self._init_one(name, arr)

    def _init_beta(self, name, arr):
        self._init_zero(name, arr)

    def _init_weight(self, name, arr):
        raise NotImplementedError("Must override it")

    def _init_default(self, name, arr):
        raise ValueError(
            f"Unknown initialization pattern for {name}. Default "
            'initialization is now limited to "weight", "bias", "gamma" '
            '(1.0), and "beta" (0.0). Please use mx.sym.Variable(init=...) '
            "to set initialization pattern")


def _uniform(shape, lo, hi):
    return torch.rand(tuple(shape), generator=_rnd.generator()) \
        * (hi - lo) + lo


def _normal(shape, sigma):
    return torch.randn(tuple(shape), generator=_rnd.generator()) * sigma


@register
class Zero(Initializer):
    def _init_weight(self, name, arr):
        self._init_zero(name, arr)


@register
class One(Initializer):
    def _init_weight(self, name, arr):
        self._init_one(name, arr)


_INIT_REGISTRY["zeros"] = Zero
_INIT_REGISTRY["ones"] = One


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr):
        self._set(arr, torch.full(arr.shape, float(self.value)))


@register
class Uniform(Initializer):
    """U(-scale, scale) (reference: initializer.py Uniform)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr):
        self._set(arr, _uniform(arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    """N(0, sigma) (reference: initializer.py Normal)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr):
        self._set(arr, _normal(arr.shape, self.sigma))


@register
class Xavier(Initializer):
    """reference: initializer.py Xavier — ``scale = sqrt(magnitude /
    factor)`` with factor the average of fan-in and fan-out (``avg``),
    fan-in (``in``) or fan-out (``out``); uniform in [-scale, scale] or
    gaussian with sigma = scale."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError(
                f"Xavier initializer cannot be applied to vector {name}. "
                "It requires at least 2D.")
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise ValueError("Incorrect factor type")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            self._set(arr, _uniform(shape, -scale, scale))
        elif self.rnd_type == "gaussian":
            self._set(arr, _normal(shape, scale))
        else:
            raise ValueError("Unknown random type")
