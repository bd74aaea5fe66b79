"""Reductions over axes.

PyTorch counterpart of the ``_reg_reduce`` family of
``mxnet_tpu/ops/reduce.py`` (reference:
src/operator/tensor/broadcast_reduce_op*.cc): ``sum`` (``sum_axis``),
``mean``, ``prod``, ``nansum``, ``nanprod``, ``max`` (``max_axis``) and
``min`` (``min_axis``), each with ``axis`` (None or () for every axis),
``keepdims`` and ``exclude`` (reduce every axis but the listed ones).
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
