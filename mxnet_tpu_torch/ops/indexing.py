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
    index of the other axes.  As the JAX package's ``take_along_axis``
    (its ``mode="fill"``): an index in [-n, n) reads Python-style, any
    other gives NaN (a signed integer input: its least value).  The
    gather itself only sees clamped indices, so none leaves the array on
    the card."""
    axis = int(axis) % a.dim()
    n = a.shape[axis]
    idx = indices.to(torch.int64).unsqueeze(axis)
    inside = (idx >= -n) & (idx < n)
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))
    out = torch.take_along_dim(a, idx, dim=axis)
    out = torch.where(inside, out, _fill_value(a))
    return out if keepdims else out.squeeze(axis)


def _fill_value(a):
    """What the JAX package's gathers give for an index out of range."""
    if a.is_floating_point() or a.is_complex():
        return torch.tensor(float("nan"), dtype=a.dtype, device=a.device)
    if a.dtype == torch.bool:
        return torch.tensor(True, device=a.device)
    return torch.tensor(torch.iinfo(a.dtype).min, dtype=a.dtype,
                        device=a.device)


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


def _wrap_negative(idx, dims):
    """indices (M, ...) into dims: a negative index counts from the end
    once, as NumPy-style indexing does in the JAX package."""
    n = torch.tensor(dims, dtype=idx.dtype, device=idx.device)
    n = n.reshape((-1,) + (1,) * (idx.dim() - 1))
    return torch.where(idx < 0, idx + n, idx), n


@register("gather_nd", arg_names=["data", "indices"])
def _gather_nd(data, indices, **kw):
    """indices (M, ...) index the first M dims of data.  As in the JAX
    package, a negative index counts from the end once, then every index
    clamps to [0, dim - 1]."""
    idx = indices.to(torch.int64)
    idx, n = _wrap_negative(idx, data.shape[:idx.shape[0]])
    idx = torch.minimum(idx.clamp(min=0), (n - 1).clamp(min=0))
    return data[tuple(idx[i] for i in range(idx.shape[0]))]


@register("scatter_nd", arg_names=["data", "indices"],
          attr_defaults={"shape": ()})
def _scatter_nd(data, indices, shape=(), **kw):
    """zeros(shape) with data written at indices (M, ...), as the JAX
    package's ``.at[...].set``: a negative index counts from the end
    once, an index still out of range is dropped, and of duplicate
    indices the last write wins, in the output and in the gradient (the
    others get none).  The winners are found first (the largest position
    of each element), so the write itself has no duplicates and its
    result does not depend on the device."""
    shape = tuple(int(d) for d in shape)
    idx = indices.to(torch.int64)
    M = idx.shape[0]
    idx, n = _wrap_negative(idx, shape[:M])
    lin = idx.reshape(M, -1)
    ok = ((lin >= 0) & (lin < n.reshape(M, 1))).all(0)
    strides = [1] * M
    for i in range(M - 2, -1, -1):
        strides[i] = strides[i + 1] * shape[i + 1]
    lin = (lin * torch.tensor(strides, device=lin.device)[:, None]).sum(0)
    lin = torch.where(ok, lin, 0)
    cells = 1
    for d in shape[:M]:
        cells *= d
    pos = torch.arange(lin.numel(), device=lin.device)
    last = torch.full((max(cells, 1),), -1, dtype=torch.int64,
                      device=lin.device)
    last = last.scatter_reduce(0, lin[ok], pos[ok], "amax")
    win = ok & (last[lin] == pos)
    rows = data.reshape((lin.numel(),) + shape[M:])
    out = torch.zeros((cells,) + shape[M:], dtype=data.dtype,
                      device=data.device)
    out = out.index_put((lin[win],), rows[win])
    return out.reshape(shape)


@register("sort", arg_names=["data"],
          attr_defaults={"axis": -1, "is_ascend": True})
def _sort(data, axis=-1, is_ascend=True, **kw):
    """``axis=None`` sorts the flattened array, as the JAX package does."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.sort(data, dim=int(axis), stable=True).values
    return out if is_ascend else torch.flip(out, (int(axis),))


@register("argsort", arg_names=["data"], differentiable=False,
          attr_defaults={"axis": -1, "is_ascend": True, "dtype": "float32"})
def _argsort(data, axis=-1, is_ascend=True, dtype="float32", **kw):
    """``axis=None``: indices into the flattened array."""
    if axis is None:
        data, axis = data.reshape(-1), 0
    out = torch.argsort(data, dim=int(axis), stable=True)
    if not is_ascend:
        out = torch.flip(out, (int(axis),))
    return out.to(getattr(torch, dtype))


_SAME_SIZE_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _total_order(x, negate):
    """int64 keys that order ``x`` (negated first when ``negate``) as
    ``lax.top_k`` does: floats by IEEE total order, so -NaN < -inf < ...
    < -0.0 < +0.0 < ... < inf < NaN, and negating a NaN moves it to the
    other end."""
    if not x.is_floating_point():
        k = x.to(torch.int64) if x.dtype == torch.bool else x
        return (-k if negate else k).to(torch.int64)
    itype = _SAME_SIZE_INT[x.element_size()]
    info = torch.iinfo(itype)
    bits = x.contiguous().view(itype)
    if negate:
        bits = bits ^ info.min
    return torch.where(bits < 0, bits ^ info.max, bits).to(torch.int64)


@register("topk", arg_names=["data"], num_outputs=-1, differentiable=False,
          attr_defaults={"axis": -1, "k": 1, "ret_typ": "indices",
                         "is_ascend": False, "dtype": "float32"})
def _topk(data, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32", **kw):
    """reference: ordering_op.cc TopK.  The order is ``lax.top_k``'s
    over the values (negated when ``is_ascend``, as the JAX package
    asks for it): IEEE total order, NaN above every number, ties to the
    lower index first.  ``axis=None`` raises, as in the JAX package."""
    ax = int(axis) % data.dim()
    moved = data.movedim(ax, -1)
    key = _total_order(moved, negate=bool(is_ascend))
    idxs = torch.sort(key, dim=-1, descending=True,
                      stable=True).indices[..., :int(k)]
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
