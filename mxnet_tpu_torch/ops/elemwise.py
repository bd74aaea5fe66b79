"""Elementwise binary, scalar and unary ops (subset).

PyTorch counterpart of the part of ``mxnet_tpu/ops/elemwise.py`` that
the transformer and ResNet graphs emit: the ``elemwise_*`` /
``broadcast_*`` arithmetic family, ``broadcast_greater_equal``, the
scalar ops behind the symbol's ``+ - * /`` overloads, the unaries the
gelu and rope paths use, and ``_copy`` (alias ``identity``).
"""
from __future__ import annotations

import torch

from .registry import register


def _reg_binary(stem, fn, extra=()):
    register("elemwise_" + stem, arg_names=["lhs", "rhs"],
             aliases=("_" + stem,) + tuple(extra))(
        lambda lhs, rhs, _f=fn, **kw: _f(lhs, rhs))
    register("broadcast_" + stem, arg_names=["lhs", "rhs"])(
        lambda lhs, rhs, _f=fn, **kw: _f(lhs, rhs))


_reg_binary("add", torch.add, extra=("_plus", "_grad_add"))
_reg_binary("sub", torch.sub, extra=("_minus",))
_reg_binary("mul", torch.mul)
_reg_binary("div", torch.div)

register("broadcast_greater_equal", arg_names=["lhs", "rhs"],
         aliases=("_greater_equal",))(
    lambda lhs, rhs, **kw: (lhs >= rhs).to(torch.result_type(lhs, rhs)))


def _reg_scalar(name, fn):
    register(name, arg_names=["data"], attr_defaults={"scalar": 1.0})(
        lambda data, scalar=1.0, _f=fn, **kw: _f(data, scalar))


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
}
for _n, _f in _SCALAR.items():
    _reg_scalar(_n, _f)

_UNARY = {
    "sigmoid": torch.sigmoid,
    "exp": torch.exp,
    "cos": torch.cos,
    "sin": torch.sin,
}
for _n, _f in _UNARY.items():
    register(_n, arg_names=["data"])(
        lambda data, _f=_f, **kw: _f(data))

# reference: _copy; tensors are never written in place here, so the
# identity need not copy
register("_copy", arg_names=["data"], aliases=("identity",))(
    lambda data, **kw: data)
