"""Shape-manipulation ops.

PyTorch counterpart of ``mxnet_tpu/ops/matrix.py``: ``Reshape`` with
MXNet's special codes, ``Flatten``, ``transpose``, ``expand_dims``,
``squeeze``, ``slice`` / ``slice_axis`` / ``slice_like``,
``reshape_like``, ``Concat``, ``stack``, ``SliceChannel`` (``split``),
``dot``, ``batch_dot``, ``tile``, ``repeat``, ``flip``, ``SwapAxis`` and
``Pad``.  Reshape, transpose, swapaxes and slicing return views where
torch can; ops that need contiguous memory (the attention kernel) make
it themselves.  ``dot`` and ``batch_dot`` are plain products
(``torch.tensordot`` / ``torch.matmul``, cuBLAS on the card), as the JAX
package leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


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
    return data.squeeze(tuple(int(a) for a in axes))


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
