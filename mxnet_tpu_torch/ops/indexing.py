"""Embedding lookup.

PyTorch counterpart of ``Embedding`` in ``mxnet_tpu/ops/indexing.py``.
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
