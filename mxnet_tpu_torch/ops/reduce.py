"""Reductions over axes, norms, arg-reductions and broadcasting.

PyTorch counterpart of ``mxnet_tpu/ops/reduce.py`` (reference:
src/operator/tensor/broadcast_reduce_op*.cc): ``sum`` (``sum_axis``),
``mean``, ``prod``, ``nansum``, ``nanprod``, ``max`` (``max_axis``) and
``min`` (``min_axis``), each with ``axis`` (None or () for every axis),
``keepdims`` and ``exclude`` (reduce every axis but the listed ones);
``norm``, ``argmax`` / ``argmin`` (float32 indices), the ``broadcast_to``
/ ``broadcast_axis`` / ``broadcast_like`` family and ``L2Normalization``.
"""
from __future__ import annotations

import torch

from .registry import register


def _axes(data, axis, exclude):
    """The axes to reduce, as a sorted tuple of non-negative ints."""
    nd = data.dim()
    if axis is None or axis == ():
        return tuple(range(nd))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(sorted({int(a) % nd for a in ax}))
    if exclude:
        ax = tuple(i for i in range(nd) if i not in ax)
    return ax


def _prod(x, dims, keepdim):
    # torch.prod takes one dim at a time; the highest first keeps the
    # lower indices valid when the dims are dropped
    for d in reversed(dims):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _same_int(fn):
    """Integer sums keep the input's integer type (torch widens to
    int64; the JAX package's int32 stays int32)."""
    def run(x, dims, keepdim):
        out = fn(x, dims, keepdim)
        if not x.is_floating_point() and x.dtype != torch.bool:
            out = out.to(x.dtype)
        return out
    return run


_REDUCE = {
    "sum": (_same_int(lambda x, d, k: torch.sum(x, dim=d, keepdim=k)),
            ("sum_axis",)),
    "mean": (lambda x, d, k: torch.mean(
        x if x.is_floating_point() else x.float(), dim=d, keepdim=k), ()),
    "prod": (_same_int(_prod), ()),
    "nansum": (lambda x, d, k: torch.nansum(x, dim=d, keepdim=k), ()),
    "nanprod": (lambda x, d, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x), d, k), ()),
    "max": (lambda x, d, k: torch.amax(x, dim=d, keepdim=k), ("max_axis",)),
    "min": (lambda x, d, k: torch.amin(x, dim=d, keepdim=k), ("min_axis",)),
}


def _reg_reduce(name, fn, aliases):
    @register(name, arg_names=["data"], aliases=aliases,
              attr_defaults={"axis": None, "keepdims": False,
                             "exclude": False})
    def _impl(data, axis=None, keepdims=False, exclude=False, **kw):
        dims = _axes(data, axis, exclude)
        if not dims:  # a 0-d array, or every axis excluded: reduce none
            return fn(data.unsqueeze(0), (0,), False)  # (torch's () is all)
        return fn(data, dims, bool(keepdims))
    return _impl


for _n, (_f, _a) in _REDUCE.items():
    _reg_reduce(_n, _f, _a)


# --- norms, arg-reductions and broadcasting (reference:
# broadcast_reduce_op_value.cc, broadcast_reduce_op_index.cc) --------------
@register("_square_sum", arg_names=["data"],
          attr_defaults={"axis": None, "keepdims": False, "exclude": False})
def _square_sum(data, axis=None, keepdims=False, exclude=False, **kw):
    return torch.sum(data.square(), dim=_axes(data, axis, exclude),
                     keepdim=bool(keepdims))


@register("norm", arg_names=["data"],
          attr_defaults={"ord": 2, "axis": None, "keepdims": False})
def _norm(data, ord=2, axis=None, keepdims=False, **kw):
    """The L1 or L2 norm over ``axis`` (every axis when None)."""
    dims = _axes(data, axis, False)
    if ord == 1:
        return torch.sum(data.abs(), dim=dims, keepdim=bool(keepdims))
    return torch.sqrt(torch.sum(data.square(), dim=dims,
                                keepdim=bool(keepdims)))


def _arg_reduce(fn, data, axis, keepdims):
    """Index of the extreme along ``axis`` (of the flattened array when
    None), as float32, as the JAX package returns it."""
    if axis is None:
        out = fn(data.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * data.dim())
    else:
        out = fn(data, dim=int(axis), keepdim=bool(keepdims))
    return out.to(torch.float32)


@register("argmax", arg_names=["data"], differentiable=False,
          attr_defaults={"axis": None, "keepdims": False})
def _argmax(data, axis=None, keepdims=False, **kw):
    return _arg_reduce(torch.argmax, data, axis, keepdims)


@register("argmin", arg_names=["data"], differentiable=False,
          attr_defaults={"axis": None, "keepdims": False})
def _argmin(data, axis=None, keepdims=False, **kw):
    return _arg_reduce(torch.argmin, data, axis, keepdims)


@register("argmax_channel", arg_names=["data"], differentiable=False)
def _argmax_channel(data, **kw):
    return torch.argmax(data, dim=-1).to(torch.float32)


@register("broadcast_to", arg_names=["data"], attr_defaults={"shape": ()})
def _broadcast_to(data, shape=(), **kw):
    """A 0 in ``shape`` keeps the input's dim."""
    shape = tuple(d if int(s) == 0 else int(s)
                  for s, d in zip(shape, data.shape))
    return data.expand(shape)


@register("broadcast_axis", arg_names=["data"],
          attr_defaults={"axis": (), "size": ()}, aliases=("broadcast_axes",))
def _broadcast_axis(data, axis=(), size=(), **kw):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    target = list(data.shape)
    for a, s in zip(axes, sizes):
        target[a] = int(s)
    return data.expand(tuple(target))


@register("broadcast_like", arg_names=["lhs", "rhs"])
def _broadcast_like(lhs, rhs, **kw):
    return lhs.expand(rhs.shape)


@register("L2Normalization", arg_names=["data"],
          attr_defaults={"eps": 1e-10, "mode": "instance"})
def _l2norm(data, eps=1e-10, mode="instance", **kw):
    """reference: src/operator/l2_normalization.cc"""
    dims = {"instance": tuple(range(1, data.dim())), "channel": (1,),
            "spatial": tuple(range(2, data.dim()))}.get(mode)
    if dims is None:
        raise ValueError(mode)
    return data / torch.sqrt(
        torch.sum(data.square(), dim=dims, keepdim=True) + eps)
