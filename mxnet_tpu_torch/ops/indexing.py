"""Embedding lookup and ``take``.

PyTorch counterpart of ``Embedding`` and ``take`` in
``mxnet_tpu/ops/indexing.py``.
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
