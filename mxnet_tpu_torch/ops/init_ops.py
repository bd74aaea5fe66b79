"""Array-creation ops (subset; reference: src/operator/tensor/init_op.cc).

PyTorch counterpart of ``_arange`` in ``mxnet_tpu/ops/init_ops.py``,
also registered as ``arange``.
Creation ops have no input to take a device from, so the executor passes
``device``.
"""
from __future__ import annotations

import torch

from .registry import register


@register("_arange", aliases=("arange",),
          attr_defaults={"start": 0.0, "stop": None, "step": 1.0,
                         "repeat": 1, "dtype": "float32"})
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None, **kw):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step,
                       dtype=getattr(torch, dtype or "float32"),
                       device=device)
    if repeat != 1:
        out = out.repeat_interleave(int(repeat))
    return out
