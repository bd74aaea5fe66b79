"""Elementwise unary, binary, scalar and logic ops.

PyTorch counterpart of ``mxnet_tpu/ops/elemwise.py``: the unary math
table, the ``elemwise_*`` / ``broadcast_*`` arithmetic, power, extrema,
comparison and logic families with their ``_``-prefixed aliases, the
scalar table behind the NDArray and Symbol operator overloads, ``clip``,
``Cast``, ``where``, ``add_n``, ``BlockGrad`` and ``make_loss``.  Each
is one torch call (the JAX package leaves them to XLA, outside any
Pallas kernel); comparisons return the operands' type, as MXNet does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register, alias


def _round_away(x):
    """MXNet ``round``: half away from zero (torch.round is half to
    even); exact, since ``x - trunc(x)`` is exact in floating point.
    Integer input is the identity."""
    if not x.is_floating_point():
        return x
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x),
                       torch.round(x))


class _Cbrt(torch.autograd.Function):
    """Cube root that keeps the sign bit, ``copysign(|x|^(1/3), x)``
    (torch has no ``cbrt``): -0.0 gives -0.0, so ``rcbrt`` gives -inf
    there, as ``jnp.cbrt`` does.  The gradient is ``jnp.cbrt``'s,
    ``g / (3 y^2)``: inf at 0, where the chain through ``abs`` would
    give NaN."""

    @staticmethod
    def forward(ctx, x):
        y = torch.copysign(x.abs().pow(1.0 / 3.0), x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        y, = ctx.saved_tensors
        return g * (1.0 / 3.0) * y.pow(-2)


def _cbrt(x):
    if not x.is_floating_point():
        x = x.float()
    return _Cbrt.apply(x)


def _sign(x):
    """``jnp.sign``: NaN stays NaN and -0.0 stays -0.0 (``torch.sign``
    gives 0.0 for both); the gradient is 0 everywhere."""
    keep = (x == 0) | torch.isnan(x)
    return torch.where(keep, x.detach(), torch.sign(x))


def _float(fn):
    """``fn`` over an integer input promoted to float32 (torch has no
    integer kernel for it; the JAX package promotes)."""
    def run(*xs):
        return fn(*[x.float() if isinstance(x, torch.Tensor)
                    and not x.is_floating_point() else x for x in xs])
    return run


# --- unary math (reference: elemwise_unary_op.cc) --------------------------
_UNARY = {
    "abs": torch.abs, "sign": _sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "relu": F.relu,
    "gamma": lambda x: torch.lgamma(x).exp(),
    "gammaln": torch.lgamma,
    "erf": torch.erf,
    "reciprocal": torch.reciprocal,
    "negative": torch.neg,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "round": _round_away,
}
for _n, _f in _UNARY.items():
    register(_n, arg_names=["data"])(lambda data, _f=_f, **kw: _f(data))

# reference: _copy; tensors are never written in place here, so the
# identity need not copy
register("_copy", arg_names=["data"], aliases=("identity",))(
    lambda data, **kw: data)
register("BlockGrad", arg_names=["data"], aliases=("stop_gradient",))(
    lambda data, **kw: data.detach())
register("zeros_like", arg_names=["data"])(
    lambda data, **kw: torch.zeros_like(data))
register("ones_like", arg_names=["data"])(
    lambda data, **kw: torch.ones_like(data))


class _HeadLoss(torch.autograd.Function):
    """Identity forward whose gradient is ones: the cotangent arriving
    from above is replaced, as the reference's ``make_loss`` head does."""

    @staticmethod
    def forward(ctx, data):
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        return torch.ones_like(g)


@register("make_loss", arg_names=["data"])
def _make_loss(data, **kw):
    """reference: elemwise_unary_op.cc make_loss."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _HeadLoss.apply(data)
    return data


@register("clip", arg_names=["data"],
          attr_defaults={"a_min": 0.0, "a_max": 1.0})
def _clip(data, a_min=0.0, a_max=1.0, **kw):
    return torch.clamp(data, a_min, a_max)


@register("Cast", arg_names=["data"], aliases=("cast",),
          attr_defaults={"dtype": "float32"})
def _cast(data, dtype="float32", **kw):
    return data.to(getattr(torch, str(dtype)))


# --- binary elementwise + broadcast (reference: elemwise_binary_op.cc,
# elemwise_binary_broadcast_op_basic.cc) ------------------------------------
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
# jnp.mod takes the divisor's sign, as torch.remainder does
_reg_binary("mod", torch.remainder)


def _like(fn):
    """A predicate as 0/1 in the operands' common type."""
    return lambda a, b: fn(a, b).to(torch.result_type(a, b))


_BROADCAST = {
    "power": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": _float(torch.hypot),
    "equal": _like(torch.eq), "not_equal": _like(torch.ne),
    "greater": _like(torch.gt), "greater_equal": _like(torch.ge),
    "lesser": _like(torch.lt), "lesser_equal": _like(torch.le),
    "logical_and": _like(lambda a, b: (a != 0) & (b != 0)),
    "logical_or": _like(lambda a, b: (a != 0) | (b != 0)),
    "logical_xor": _like(lambda a, b: (a != 0) ^ (b != 0)),
}
for _stem, _f in _BROADCAST.items():
    register("broadcast_" + _stem, arg_names=["lhs", "rhs"])(
        lambda lhs, rhs, _f=_f, **kw: _f(lhs, rhs))
for _stem in ("power", "maximum", "minimum", "hypot", "equal", "not_equal",
              "greater", "greater_equal", "lesser", "lesser_equal"):
    alias("_" + _stem, "broadcast_" + _stem)


# --- scalar ops (reference: elemwise_binary_scalar_op*.cc) -----------------
def _own(fn):
    """A predicate against a scalar as 0/1 in the array's type."""
    return lambda x, s: fn(x, s).to(x.dtype)


def _smooth_l1(x, s):
    return torch.where(x.abs() < 1.0 / (s * s), 0.5 * (s * x) ** 2,
                       x.abs() - 0.5 / (s * s))


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(torch.full_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_hypot_scalar": _float(
        lambda x, s: torch.hypot(x, torch.full_like(x, s))),
    "_maximum_scalar": lambda x, s: torch.maximum(x, torch.full_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, torch.full_like(x, s)),
    "_equal_scalar": _own(torch.eq),
    "_not_equal_scalar": _own(torch.ne),
    "_greater_scalar": _own(torch.gt),
    "_greater_equal_scalar": _own(torch.ge),
    "_lesser_scalar": _own(torch.lt),
    "_lesser_equal_scalar": _own(torch.le),
    "_logical_and_scalar": _own(lambda x, s: (x != 0) & (s != 0)),
    "_logical_or_scalar": _own(lambda x, s: (x != 0) | (s != 0)),
    "_logical_xor_scalar": _own(lambda x, s: (x != 0) ^ (s != 0)),
    "_scatter_plus_scalar": lambda x, s: x + s,
    "_scatter_minus_scalar": lambda x, s: x - s,
    "smooth_l1": _smooth_l1,
}
for _n, _f in _SCALAR.items():
    register(_n, arg_names=["data"], attr_defaults={"scalar": 1.0})(
        lambda data, scalar=1.0, _f=_f, **kw: _f(data, scalar))


@register("add_n", variadic=True, aliases=("ElementWiseSum", "_sum"))
def _add_n(*args, **kw):
    """Sum of N arrays (reference: ElementwiseSum)."""
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


register("_scatter_elemwise_div", arg_names=["lhs", "rhs"])(
    lambda lhs, rhs, **kw: torch.div(lhs, rhs))
register("_identity_with_attr_like_rhs", arg_names=["lhs", "rhs"])(
    lambda lhs, rhs, **kw: lhs)


@register("where", arg_names=["condition", "x", "y"])
def _where(condition, x, y, **kw):
    """A 1-d condition of x's first dim selects whole rows (reference
    where_batch, control_flow_op.h:53)."""
    cond = condition != 0 if condition.dtype != torch.bool else condition
    if cond.dim() == 1 and x.dim() > 1 and cond.shape[0] == x.shape[0]:
        cond = cond.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(cond, x, y)

