"""Gluon basic layers.

PyTorch counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (reference:
python/mxnet/gluon/nn/basic_layers.py): every layer is a HybridBlock whose
hybrid_forward calls registry ops, so the same definition runs eagerly
(op by op under autograd) or hybridized (a traced graph).  The code is
the JAX package's; only the ops beneath differ.
"""
from __future__ import annotations

import numpy as np

from ..block import Block, HybridBlock
from ...base import MXNetError


class Sequential(Block):
    """Stack of Blocks run in order (reference: basic_layers.py:29)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
            super(Block, self).__setattr__(
                f'_child{len(self._children)-1}', block)

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class HybridSequential(HybridBlock):
    """reference: basic_layers.py:84."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)
            super(Block, self).__setattr__(
                f'_child{len(self._children)-1}', block)

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x

    def __len__(self):
        return len(self._children)

    def __getitem__(self, i):
        return self._children[i]


class Dense(HybridBlock):
    """Fully-connected layer (reference: basic_layers.py:140)."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype=np.float32, weight_initializer=None,
                 bias_initializer='zeros', in_units=0, **kwargs):
        super().__init__(**kwargs)
        self._units = units
        self._flatten = flatten
        self._act_type = activation
        with self.name_scope():
            self.weight = self.params.get(
                'weight', shape=(units, in_units), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(units,), dtype=dtype,
                    init=bias_initializer, allow_deferred_init=True)
            else:
                self.bias = None

    def hybrid_forward(self, F, x, weight, bias=None):
        out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                               no_bias=bias is None, flatten=self._flatten)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Activation(HybridBlock):
    """reference: basic_layers.py:226."""

    def __init__(self, activation, **kwargs):
        self._act_type = activation   # before super(): _alias() needs it
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """reference: basic_layers.py:258."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes)


class BatchNorm(HybridBlock):
    """reference: basic_layers.py:300."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer='zeros',
                 gamma_initializer='ones', running_mean_initializer='zeros',
                 running_variance_initializer='ones', in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {'axis': axis, 'eps': epsilon, 'momentum': momentum,
                        'fix_gamma': not scale,
                        'use_global_stats': use_global_stats}
        with self.name_scope():
            self.gamma = self.params.get(
                'gamma', grad_req='write' if scale else 'null',
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True, differentiable=scale)
            self.beta = self.params.get(
                'beta', grad_req='write' if center else 'null',
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True, differentiable=center)
            self.running_mean = self.params.get(
                'running_mean', grad_req='null', shape=(in_channels,),
                init=running_mean_initializer, allow_deferred_init=True,
                differentiable=False)
            self.running_var = self.params.get(
                'running_var', grad_req='null', shape=(in_channels,),
                init=running_variance_initializer, allow_deferred_init=True,
                differentiable=False)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        # eager: _invoke writes the updated moving stats back into the
        # running_mean/var arrays (ndarray.py _invoke aux writeback);
        # hybridized: the cached graph returns new_aux and _call_cached
        # writes them back
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           **self._kwargs)


class InstanceNorm(HybridBlock):
    """reference: basic_layers.py InstanceNorm."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                'gamma', grad_req='write' if scale else 'null',
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                'beta', grad_req='write' if center else 'null',
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self._eps)


class LayerNorm(HybridBlock):
    """Layer normalization (post-reference addition kept for parity with
    later MXNet; normalizes the last axis)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer='zeros', gamma_initializer='ones',
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._eps = epsilon
        with self.name_scope():
            self.gamma = self.params.get(
                'gamma', grad_req='write' if scale else 'null',
                shape=(in_channels,), init=gamma_initializer,
                allow_deferred_init=True)
            self.beta = self.params.get(
                'beta', grad_req='write' if center else 'null',
                shape=(in_channels,), init=beta_initializer,
                allow_deferred_init=True)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis, eps=self._eps)


class Embedding(HybridBlock):
    """reference: basic_layers.py Embedding."""

    def __init__(self, input_dim, output_dim, dtype=np.float32,
                 weight_initializer=None, sparse_grad=False, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {'input_dim': input_dim, 'output_dim': output_dim,
                        'sparse_grad': sparse_grad}
        with self.name_scope():
            self.weight = self.params.get(
                'weight', shape=(input_dim, output_dim), dtype=dtype,
                init=weight_initializer, allow_deferred_init=True,
                grad_stype='row_sparse' if sparse_grad else 'default')

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, **self._kwargs)


class Flatten(HybridBlock):
    """reference: basic_layers.py Flatten."""

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


class Lambda(Block):
    """Wrap a function as a Block (reference: basic_layers.py Lambda)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            from ... import ndarray as nd_mod
            if not hasattr(nd_mod, function):
                raise MXNetError(f"ndarray has no function {function!r}")
            self._func = getattr(nd_mod, function)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, '__name__', 'lambda')

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """reference: basic_layers.py HybridLambda."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            self._func = function
            self._func_name = getattr(function, '__name__', 'lambda')

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)


# -- advanced activations (reference: gluon/nn/activations later versions;
#    LeakyReLU existed in basic_layers.py) ---------------------------------
class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type='leaky', slope=self._alpha)


class PReLU(HybridBlock):
    def __init__(self, alpha_initializer='zeros', **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.alpha = self.params.get('alpha', shape=(1,),
                                         init=alpha_initializer)

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, gamma=alpha, act_type='prelu')


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type='elu', slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type='selu')


class Swish(HybridBlock):
    def __init__(self, beta=1.0, **kwargs):
        super().__init__(**kwargs)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type='gelu')
