"""Shape-manipulation ops (subset).

PyTorch counterpart of the part of ``mxnet_tpu/ops/matrix.py`` the
transformer, decode and zoo graphs use: ``Reshape`` with MXNet's special
codes, ``Flatten``, ``transpose``, ``expand_dims``, ``slice_axis``,
``Concat``, ``batch_dot``, ``repeat`` and ``SwapAxis``.  Reshape,
transpose, swapaxes and slicing return views where torch can; ops that
need contiguous memory (the attention kernel) make it themselves.
``batch_dot`` is a plain batched product (``torch.matmul``, cuBLAS on the
card), as the JAX package leaves it to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

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


@register("SwapAxis", arg_names=["data"], aliases=("swapaxes",),
          attr_defaults={"dim1": 0, "dim2": 0})
def _swapaxes(data, dim1=0, dim2=0, **kw):
    """reference: src/operator/swapaxis.cc"""
    return data.transpose(int(dim1), int(dim2))
