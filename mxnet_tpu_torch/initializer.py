"""Weight initializers.

PyTorch counterpart of ``mxnet_tpu/initializer.py`` (Zero, One,
Constant, Uniform, Normal, Orthogonal, Xavier, MSRAPrelu, Bilinear,
LSTMBias, FusedRNN, Load, Mixed): the parameter's
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

import json
import logging
import math
import re

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
    if isinstance(name, (Initializer, Load, Mixed)):
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
        self._verbose = False
        self._print_func = None

    def set_verbosity(self, verbose=False, print_func=None):
        """Log each weight, bias, gamma and beta as it is initialized,
        with ``print_func(arr)`` (default: the mean absolute value), as
        the JAX package's initializer does."""
        self._verbose = verbose
        if print_func is None:
            def asum_stat(x):
                return str((np.abs(x.asnumpy()).mean(),))
            print_func = asum_stat
        self._print_func = print_func
        return self

    def _verbose_print(self, desc, init, arr):
        if getattr(self, "_verbose", False) and self._print_func:
            logging.info('Initialized %s as %s: %s', desc, init,
                         self._print_func(arr))

    def dumps(self):
        """``[name, kwargs]`` as JSON: the form a variable's ``__init__``
        attribute holds (reference: initializer.py dumps)."""
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be a string (InitDesc)")
        if desc.endswith("weight"):
            self._init_weight(desc, arr)
            self._verbose_print(desc, 'weight', arr)
        elif desc.endswith("bias"):
            self._init_bias(desc, arr)
            self._verbose_print(desc, 'bias', arr)
        elif desc.endswith("gamma"):
            self._init_gamma(desc, arr)
            self._verbose_print(desc, 'gamma', arr)
        elif desc.endswith("beta"):
            self._init_beta(desc, arr)
            self._verbose_print(desc, 'beta', arr)
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


@register
class LSTMBias(Initializer):
    """The LSTM's forget-gate bias (reference: initializer.py LSTMBias):
    zeros, with ``forget_bias`` in the second quarter (gate order
    [i, f, c, o])."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr):
        b = torch.zeros(arr.shape)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        self._set(arr, b)

    _init_bias = _init_weight
    _init_default = _init_weight


@register
class FusedRNN(Initializer):
    """The packed parameter vector of a fused RNN (reference:
    initializer.py FusedRNN): each per-gate piece of
    ``FusedRNNCell.unpack_weights`` is filled by ``init`` (else the
    surrounding global initializer, else ``Uniform(0.1)``) under its own
    name, so ``*_weight`` pieces get the weight rule and ``*_bias``
    pieces zeros; every LSTM forget-gate bias (i2h and h2h) is then set
    to ``forget_bias``."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = create(klass, **kwargs)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def __call__(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(self._num_hidden, self._num_layers,
                                     self._mode, self._bidirectional,
                                     forget_bias=self._forget_bias,
                                     prefix='')
        args = cell.unpack_weights({'parameters': arr})
        inner = self._init or getattr(desc, 'global_init', None) \
            or Uniform(0.1)
        for name, blk in args.items():
            inner(InitDesc(name), blk)
            if self._mode == 'lstm' and name.endswith('_f_bias'):
                self._set(blk, torch.full(blk.shape, self._forget_bias))
        packed = cell.pack_weights(args)['parameters']
        self._set(arr, packed._data)


@register
class Orthogonal(Initializer):
    """A scaled orthogonal matrix (Saxe et al. 2013; reference:
    initializer.py Orthogonal): the SVD factor of a random (out, in)
    matrix, uniform in [-1, 1] or gaussian, times ``scale``, reshaped to
    the weight."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = _uniform((nout, nin), -1.0, 1.0)
        else:
            tmp = _normal((nout, nin), 1.0)
        u, _, v = torch.linalg.svd(tmp.double(), full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        self._set(arr, (self.scale * q).float().reshape(arr.shape))


@register
class MSRAPrelu(Xavier):
    """He et al.'s initialization for PReLU networks (reference:
    initializer.py MSRAPrelu): gaussian Xavier with magnitude
    ``2 / (1 + slope ** 2)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2. / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel of a Deconvolution's weight
    (reference: initializer.py Bilinear)."""

    def _init_weight(self, name, arr):
        shape = arr.shape
        f = np.ceil(shape[3] / 2.)
        c = (2 * f - 1 - f % 2) / (2. * f)
        i = np.arange(int(np.prod(shape)))
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = ((1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c)))
        self._set(arr, torch.from_numpy(
            weight.astype(np.float32).reshape(shape)))


@register
class Load:
    """Initialize from a dict of arrays (or a parameter file's name),
    with ``arg:`` / ``aux:`` prefixes dropped; a name it lacks goes to
    ``default_init`` (reference: initializer.py Load)."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .serialization import load_ndarrays
            param = load_ndarrays(param)
        self.param = {name.replace("arg:", "").replace("aux:", ""): arr
                      for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            src = self.param[name]
            if tuple(arr.shape) != tuple(src.shape):
                raise AssertionError(
                    f"Parameter {name} cannot be initialized from loading. "
                    f"Shape mismatch, target {tuple(arr.shape)} vs loaded "
                    f"{tuple(src.shape)}")
            t = src._data if hasattr(src, "_data") else \
                torch.from_numpy(np.ascontiguousarray(np.asarray(src)))
            Initializer._set(arr, t)
            if self.verbose:
                logging.info("Initialized %s by loading", name)
        else:
            if self.default_init is None:
                raise AssertionError(
                    f"Cannot Initialize {name}. Not found in loaded param "
                    "and no default Initializer is provided.")
            self.default_init(name, arr)
            if self.verbose:
                logging.info("Initialized %s by default", name)


@register
class Mixed:
    """The first initializer whose regular expression matches the
    parameter's name (reference: initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise ValueError("patterns and initializers must have the same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise ValueError(
            f"Parameter name {name} did not match any pattern. Consider "
            'adding a ".*" pattern at the end with default Initializer.')
