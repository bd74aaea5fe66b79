"""Gathers, one-hot and ordering.

PyTorch counterpart of ``mxnet_tpu/ops/indexing.py``: ``Embedding``,
``take``, ``batch_take`` / ``pick``, ``one_hot``, ``gather_nd`` /
``scatter_nd``, ``sort``, ``argsort`` and ``topk``.  Indices are float
or integer and truncate to int; sorts are stable, and a descending
order is the ascending one reversed, as the JAX package flips it.
"""
from __future__ import annotations

import torch

from .registry import register


@register("Embedding", arg_names=["data", "weight"],
          attr_defaults={"input_dim": 0, "output_dim": 0, "dtype": "float32",
                         "sparse_grad": False})
def _embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
               sparse_grad=False, **kw):
    """reference: indexing_op.cc Embedding.

    Float ids are cast to int (truncation, as ``astype(int32)``) and
    out-of-range ids CLAMP to the edge rows, as the JAX package's
    ``jnp.take(mode="clip")`` does; ``torch.index_select`` would raise."""
    idx = data.to(torch.int64).clamp(0, weight.shape[0] - 1)
    return weight[idx]


@register("take", arg_names=["a", "indices"],
          attr_defaults={"axis": 0, "mode": "clip"})
def _take(a, indices, axis=0, mode="clip", **kw):
    """reference: indexing_op.cc take.  Float indices truncate to int;
    ``mode="clip"`` clamps them to [0, n), ``"wrap"`` takes them mod n.
    The result has ``indices``' shape in place of ``axis``."""
    axis = int(axis) % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = idx.remainder(n)
    else:
        raise ValueError(f"take: mode must be clip|wrap, got {mode!r}")
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("batch_take", arg_names=["a", "indices"], aliases=("pick",),
          attr_defaults={"axis": -1, "keepdims": False})
def _pick(a, indices, axis=-1, keepdims=False, **kw):
    """reference: indexing_op.cc pick — one element along ``axis`` per
    index of the other axes."""
    axis = int(axis) % a.dim()
    idx = indices.to(torch.int64).unsqueeze(axis)
    out = torch.take_along_dim(a, idx, dim=axis)
    return out if keepdims else out.squeeze(axis)


@register("one_hot", arg_names=["indices"], differentiable=False,
          attr_defaults={"depth": 0, "on_value": 1.0, "off_value": 0.0,
                         "dtype": "float32"})
def _one_hot(indices, depth=0, on_value=1.0, off_value=0.0,
             dtype="float32", **kw):
    """Rows of ``depth`` values; an index outside [0, depth) gives a row
    of ``off_value`` (``jax.nn.one_hot``)."""
    idx = indices.to(torch.int64)
    hit = idx.unsqueeze(-1) == torch.arange(int(depth), device=idx.device)
    oh = hit.to(getattr(torch, dtype))
    return oh * (on_value - off_value) + off_value


@register("gather_nd", arg_names=["data", "indices"])
def _gather_nd(data, indices, **kw):
    """indices (M, ...) index the first M dims of data."""
    idx = indices.to(torch.int64)
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", arg_names=["data", "indices"],
          attr_defaults={"shape": ()})
def _scatter_nd(data, indices, shape=(), **kw):
    idx = indices.to(torch.int64)
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(idx[i] for i in range(idx.shape[0])), data)


@register("sort", arg_names=["data"],
          attr_defaults={"axis": -1, "is_ascend": True})
def _sort(data, axis=-1, is_ascend=True, **kw):
    out = torch.sort(data, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, (int(axis),))


@register("argsort", arg_names=["data"], differentiable=False,
          attr_defaults={"axis": -1, "is_ascend": True, "dtype": "float32"})
def _argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    out = torch.argsort(data, dim=int(axis), stable=True)
    if not is_ascend:
        out = torch.flip(out, (int(axis),))
    return out.to(getattr(torch, dtype))


@register("topk", arg_names=["data"], num_outputs=-1, differentiable=False,
          attr_defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                         "is_ascend": False, "dtype": "float32"})
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **kw):
    """reference: ordering_op.cc TopK.  Ties go to the lower index first,
    as ``lax.top_k`` orders them (a stable sort of the negated values)."""
    ax = int(axis) % data.dim()
    moved = data.movedim(ax, -1)
    sel = moved if is_ascend else -moved
    idxs = torch.argsort(sel, dim=-1, stable=True)[..., :int(k)]
    vals = torch.take_along_dim(moved, idxs, dim=-1)
    if ret_typ == "value":
        return vals.movedim(-1, ax)
    if ret_typ == "indices":
        return idxs.movedim(-1, ax).to(getattr(torch, dtype))
    if ret_typ == "both":
        return (vals.movedim(-1, ax),
                idxs.movedim(-1, ax).to(getattr(torch, dtype)))
    if ret_typ == "mask":
        mask = torch.zeros_like(moved).scatter(-1, idxs, 1)
        return mask.movedim(-1, ax)
    raise ValueError(ret_typ)
