"""Shape-manipulation ops.

PyTorch counterpart of ``mxnet_tpu/ops/matrix.py``: ``Reshape`` with
MXNet's special codes, ``Flatten``, ``transpose``, ``expand_dims``,
``squeeze``, ``slice`` / ``slice_axis`` / ``slice_like``,
``reshape_like``, ``Concat``, ``stack``, ``SliceChannel`` (``split``),
``dot``, ``batch_dot``, ``tile``, ``repeat``, ``flip``, ``SwapAxis``,
``Pad``, ``Crop``, ``_slice_assign`` / ``_crop_assign`` (and their
``_scalar`` forms), ``space_to_depth``, ``depth_to_space``, ``diag``,
``shape_array``, ``size_array``, ``cast_storage`` and
``_sparse_retain``.  Reshape, transpose, swapaxes and slicing return
views where torch can; ops that need contiguous memory (the attention
kernel) make it themselves.  ``dot`` and ``batch_dot`` are plain products
(``torch.tensordot`` / ``torch.matmul``, cuBLAS on the card), as the JAX
package leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .registry import get, register


def reshape_target(src_shape, shape=(), reverse=False):
    """Target shape of MXNet reshape with special codes 0 (copy dim),
    -1 (infer), -2 (copy rest), -3 (merge two dims), -4 (split dim) —
    reference matrix_op.cc."""
    shape = tuple(int(s) for s in shape)
    src = list(src_shape)
    if reverse:
        src = src[::-1]
        shape = tuple(reversed(shape))
    out = []
    i = 0  # index into src
    j = 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i]); i += 1
        elif s == -1:
            out.append(-1); i += 1
        elif s == -2:
            out.extend(src[i:]); i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1]); i += 2
        elif s == -4:
            d1, d2 = shape[j + 1], shape[j + 2]
            if d1 == -1:
                d1 = src[i] // d2
            if d2 == -1:
                d2 = src[i] // d1
            out.extend([d1, d2]); i += 1; j += 2
        else:
            out.append(s); i += 1
        j += 1
    if reverse:
        out = out[::-1]
    return tuple(out)


@register("Reshape", arg_names=["data"], aliases=("reshape",),
          attr_defaults={"shape": (), "reverse": False})
def _reshape(data, shape=(), reverse=False, **kw):
    """MXNet reshape with special codes (see :func:`reshape_target`)."""
    return data.reshape(reshape_target(data.shape, shape, reverse))


@register("Flatten", arg_names=["data"], aliases=("flatten",))
def _flatten(data, **kw):
    """(N, ...) -> (N, prod(...))."""
    return data.reshape(data.shape[0], -1)


@register("transpose", arg_names=["data"], attr_defaults={"axes": ()})
def _transpose(data, axes=(), **kw):
    axes = tuple(axes) or tuple(reversed(range(data.dim())))
    return data.permute(axes)


@register("expand_dims", arg_names=["data"], attr_defaults={"axis": 0})
def _expand_dims(data, axis=0, **kw):
    return data.unsqueeze(int(axis))


@register("squeeze", arg_names=["data"], attr_defaults={"axis": None})
def _squeeze(data, axis=None, **kw):
    if axis is None:
        return data.squeeze()
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = tuple(int(a) for a in axes)
    for a in axes:
        if data.shape[a] != 1:
            # torch.squeeze would return the array unchanged
            raise ValueError(f"squeeze: axis {a} of shape {tuple(data.shape)}"
                             " is not of length 1")
    return data.squeeze(axes)


def _slice_tuple(begin, end, step=()):
    step = tuple(step) or (None,) * len(begin)
    return tuple(slice(b, e, s) for b, e, s in zip(begin, end, step))


def _basic_slice(data, key):
    """``data[key]`` for slices of any step: torch takes no negative
    step, so those dims are flipped first and sliced forward."""
    idx = []
    for d, sl in enumerate(key):
        step = sl.step if sl.step is not None else 1
        if step > 0:
            idx.append(sl)
            continue
        n = data.shape[d]
        lo, hi, _ = sl.indices(n)   # numpy semantics of the reverse walk
        data = data.flip(d)
        idx.append(slice(n - 1 - lo, n - 1 - hi, -step))
    return data[tuple(idx)]


@register("slice", arg_names=["data"], aliases=("crop",),
          attr_defaults={"begin": (), "end": (), "step": ()})
def _slice(data, begin=(), end=(), step=(), **kw):
    return _basic_slice(data, _slice_tuple(begin, end, step))


def _assign(data, key, value):
    """A copy of ``data`` with ``data[key] = value`` (the JAX package's
    ``.at[key].set``), for slices of any step: dims of a negative step are
    flipped, written with the forward slice :func:`_basic_slice` reads
    through, and flipped back, so the elements meet ``value`` in the same
    order."""
    flips, idx = [], []
    for d, sl in enumerate(key):
        step = sl.step if sl.step is not None else 1
        if step > 0:
            idx.append(sl)
            continue
        n = data.shape[d]
        lo, hi, _ = sl.indices(n)
        flips.append(d)
        idx.append(slice(n - 1 - lo, n - 1 - hi, -step))
    out = data.flip(flips) if flips else data.clone()
    out[tuple(idx)] = value
    return out.flip(flips) if flips else out


@register("_slice_assign", arg_names=["lhs", "rhs"],
          aliases=("_crop_assign",),
          attr_defaults={"begin": (), "end": (), "step": ()})
def _slice_assign(lhs, rhs, begin=(), end=(), step=(), **kw):
    """reference: tensor/matrix_op.cc _slice_assign — lhs with
    ``lhs[begin:end:step] = rhs``, as a new tensor."""
    return _assign(lhs, _slice_tuple(begin, end, step), rhs.to(lhs.dtype))


@register("_slice_assign_scalar", arg_names=["data"],
          aliases=("_crop_assign_scalar",),
          attr_defaults={"scalar": 0.0, "begin": (), "end": (), "step": ()})
def _slice_assign_scalar(data, scalar=0.0, begin=(), end=(), step=(), **kw):
    return _assign(data, _slice_tuple(begin, end, step), scalar)


@register("cast_storage", arg_names=["data"],
          attr_defaults={"stype": "default"})
def _cast_storage(data, stype="default", **kw):
    """reference: tensor/cast_storage-inl.h.  Tensors are dense, so in a
    graph the op is the identity whatever ``stype`` says (as in the JAX
    package, ``ops/matrix.py:116-123``); ``nd.cast_storage`` makes the
    sparse container (:func:`_cast_storage_nd`)."""
    if stype not in ("default", "row_sparse", "csr"):
        raise MXNetError(f"cast_storage: unknown stype {stype!r}")
    return data


def _cast_storage_nd(inputs, attrs):
    """``nd.cast_storage``: a dense array to ``row_sparse`` or ``csr``, a
    sparse one to ``default`` or another type
    (:func:`mxnet_tpu_torch.ndarray.sparse.cast_storage`)."""
    stype = attrs.get("stype", "default")
    if stype == getattr(inputs[0], "stype", "default") == "default":
        return NotImplemented
    from ..ndarray import sparse
    return sparse.cast_storage(inputs[0], stype)


get("cast_storage").nd_fn = _cast_storage_nd


@register("_sparse_retain", arg_names=["data", "indices"],
          aliases=("sparse_retain",))
def _sparse_retain(data, indices, **kw):
    """reference: tensor/sparse_retain.cc - the rows ``indices`` lists
    kept, every other row 0 (the dense form of the row-sparse op, JAX
    package ``ops/matrix.py:126-135``: float ids truncate, a negative id
    counts from the end, an id out of range keeps nothing)."""
    n = data.shape[0]
    idx = indices.to(torch.int64).reshape(-1)
    idx = torch.where(idx < 0, idx + n, idx)
    inside = (idx >= 0) & (idx < n)
    keep = torch.zeros(n, dtype=torch.int64, device=data.device)
    keep.scatter_reduce_(0, idx.clamp(0, n - 1), inside.to(torch.int64),
                         "amax")
    keep = keep.bool().reshape((-1,) + (1,) * (data.dim() - 1))
    return torch.where(keep, data, torch.zeros((), dtype=data.dtype,
                                               device=data.device))


def _sparse_retain_nd(inputs, attrs):
    """A RowSparseNDArray keeps its listed rows as one
    (:meth:`RowSparseNDArray.retain`), O(stored rows)."""
    if getattr(inputs[0], "stype", "default") != "row_sparse":
        return NotImplemented
    return inputs[0].retain(inputs[1])


get("_sparse_retain").nd_fn = _sparse_retain_nd


@register("reshape_like", arg_names=["lhs", "rhs"])
def _reshape_like(lhs, rhs, **kw):
    return lhs.reshape(rhs.shape)


@register("slice_like", arg_names=["data", "shape_like"],
          attr_defaults={"axes": ()})
def _slice_like(data, shape_like, axes=(), **kw):
    axes = tuple(axes) or tuple(range(min(data.dim(), shape_like.dim())))
    idx = [slice(None)] * data.dim()
    for a in axes:
        idx[a] = slice(0, shape_like.shape[a])
    return data[tuple(idx)]


@register("slice_axis", arg_names=["data"],
          attr_defaults={"axis": 0, "begin": 0, "end": None})
def _slice_axis(data, axis=0, begin=0, end=None, **kw):
    idx = [slice(None)] * data.dim()
    idx[int(axis)] = slice(begin, end)
    return data[tuple(idx)]


@register("Concat", variadic=True, aliases=("concat",),
          attr_defaults={"dim": 1, "num_args": 0})
def _concat(*args, dim=1, num_args=0, **kw):
    """reference: src/operator/concat.cc"""
    return torch.cat(args, dim=int(dim))


@register("stack", variadic=True, attr_defaults={"axis": 0, "num_args": 0})
def _stack(*args, axis=0, num_args=0, **kw):
    return torch.stack(args, dim=int(axis))


@register("SliceChannel", arg_names=["data"], num_outputs=-1,
          aliases=("split",),
          attr_defaults={"num_outputs": 1, "axis": 1, "squeeze_axis": False})
def _split(data, num_outputs=1, axis=1, squeeze_axis=False, **kw):
    """reference: src/operator/slice_channel.cc — equal parts."""
    axis = int(axis)
    n = int(num_outputs)
    if data.shape[axis] % n:
        raise ValueError(f"split: dim {data.shape[axis]} of axis {axis} "
                         f"is not divisible by {n}")
    parts = torch.split(data, data.shape[axis] // n, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


@register("dot", arg_names=["lhs", "rhs"],
          attr_defaults={"transpose_a": False, "transpose_b": False})
def _dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """reference: tensor/dot-inl.h — contracts the last axis of lhs with
    the first of rhs; a transpose flag reverses every axis of its
    operand."""
    if transpose_a:
        lhs = lhs.permute(tuple(reversed(range(lhs.dim()))))
    if transpose_b:
        rhs = rhs.permute(tuple(reversed(range(rhs.dim()))))
    return torch.tensordot(lhs, rhs, dims=1)


@register("batch_dot", arg_names=["lhs", "rhs"],
          attr_defaults={"transpose_a": False, "transpose_b": False})
def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False, **kw):
    """(..., m, k) x (..., k, n) -> (..., m, n); the flags swap the last
    two axes of an operand first."""
    if transpose_a:
        lhs = lhs.transpose(-1, -2)
    if transpose_b:
        rhs = rhs.transpose(-1, -2)
    return torch.matmul(lhs, rhs)


@register("repeat", arg_names=["data"],
          attr_defaults={"repeats": 1, "axis": None})
def _repeat(data, repeats=1, axis=None, **kw):
    """``np.repeat``: each element ``repeats`` times along ``axis`` (the
    flattened array when None)."""
    if axis is None:
        return data.reshape(-1).repeat_interleave(int(repeats))
    return data.repeat_interleave(int(repeats), dim=int(axis))


@register("tile", arg_names=["data"], attr_defaults={"reps": ()})
def _tile(data, reps=(), **kw):
    return torch.tile(data, tuple(int(r) for r in reps))


@register("flip", arg_names=["data"], aliases=("reverse",),
          attr_defaults={"axis": 0})
def _flip(data, axis=0, **kw):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(data, tuple(int(a) for a in axes))


@register("Pad", arg_names=["data"], aliases=("pad",),
          attr_defaults={"mode": "constant", "pad_width": (),
                         "constant_value": 0})
def _pad(data, mode="constant", pad_width=(), constant_value=0, **kw):
    """reference: src/operator/pad.cc — ``pad_width`` holds (before,
    after) for every axis, the leading axes' as zeros in the edge and
    reflect modes (torch pads only the trailing ones there)."""
    pw = [int(p) for p in pad_width]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode != "constant":
        if any(p != (0, 0) for p in pairs[:2]):
            raise ValueError(f"Pad {mode}: only the spatial axes of an "
                             "(N, C, ...) array pad")
        pairs = pairs[2:]
    flat = []
    for before, after in reversed(pairs):
        flat += [before, after]
    if mode == "constant":
        return F.pad(data, flat, value=float(constant_value))
    tmode = {"edge": "replicate", "reflect": "reflect"}[mode]
    return F.pad(data, flat, mode=tmode)


@register("SwapAxis", arg_names=["data"], aliases=("swapaxes",),
          attr_defaults={"dim1": 0, "dim2": 0})
def _swapaxes(data, dim1=0, dim2=0, **kw):
    """reference: src/operator/swapaxis.cc"""
    return data.transpose(int(dim1), int(dim2))


@register("Crop", variadic=True,
          attr_defaults={"num_args": 1, "offset": (0, 0), "h_w": (0, 0),
                         "center_crop": False})
def _crop(*args, num_args=1, offset=(0, 0), h_w=(0, 0), center_crop=False,
          **kw):
    """reference: src/operator/crop.cc — an NCHW spatial crop to ``h_w``,
    or to the second input's height and width, at ``offset`` or
    centred."""
    data = args[0]
    if len(args) > 1:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = (int(v) for v in h_w)
    if center_crop:
        oh = (data.shape[2] - th) // 2
        ow = (data.shape[3] - tw) // 2
    else:
        oh, ow = (int(v) for v in offset)
    return data[:, :, oh:oh + th, ow:ow + tw]


@register("space_to_depth", arg_names=["data"],
          attr_defaults={"block_size": 1})
def _space_to_depth(data, block_size=1, **kw):
    """(N, C, H, W) -> (N, C b^2, H / b, W / b), the block's offsets
    leading the channels, as the JAX package orders them."""
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, c, h // b, b, w // b, b)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, c * b * b, h // b, w // b)


@register("depth_to_space", arg_names=["data"],
          attr_defaults={"block_size": 1})
def _depth_to_space(data, block_size=1, **kw):
    """The inverse of ``space_to_depth``."""
    b = int(block_size)
    n, c, h, w = data.shape
    x = data.reshape(n, b, b, c // (b * b), h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c // (b * b), h * b, w * b)


@register("diag", arg_names=["data"], attr_defaults={"k": 0})
def _diag(data, k=0, **kw):
    """``jnp.diag``: a vector's k-th diagonal matrix or a matrix's k-th
    diagonal; of more dims, the diagonal of the first two axes, last."""
    if data.dim() <= 2:
        return torch.diag(data, int(k))
    return torch.diagonal(data, offset=int(k), dim1=0, dim2=1)


@register("shape_array", arg_names=["data"], differentiable=False)
def _shape_array(data, **kw):
    """The shape as an int64 vector, on the data's device."""
    return torch.tensor(tuple(data.shape), dtype=torch.int64,
                        device=data.device)


@register("size_array", arg_names=["data"], differentiable=False)
def _size_array(data, **kw):
    """The element count as an int64 vector of one."""
    return torch.tensor([data.numel()], dtype=torch.int64,
                        device=data.device)
