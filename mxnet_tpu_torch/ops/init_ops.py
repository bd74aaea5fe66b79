"""Array-creation ops (subset; reference: src/operator/tensor/init_op.cc).

PyTorch counterpart of ``_zeros``, ``_ones``, ``_full`` and ``_arange``
(also registered as ``arange``) in ``mxnet_tpu/ops/init_ops.py``.
Creation ops have no input to take a device from, so the executor passes
``device``.
"""
from __future__ import annotations

import torch

from .registry import register


def _dtype(name):
    return getattr(torch, name or "float32")


@register("_zeros", attr_defaults={"shape": (), "dtype": "float32"})
def _zeros(shape=(), dtype="float32", device=None, **kw):
    return torch.zeros(tuple(shape), dtype=_dtype(dtype), device=device)


@register("_ones", attr_defaults={"shape": (), "dtype": "float32"})
def _ones(shape=(), dtype="float32", device=None, **kw):
    return torch.ones(tuple(shape), dtype=_dtype(dtype), device=device)


@register("_full", attr_defaults={"shape": (), "dtype": "float32",
                                  "value": 0.0})
def _full(shape=(), dtype="float32", value=0.0, device=None, **kw):
    return torch.full(tuple(shape), value, dtype=_dtype(dtype),
                      device=device)


@register("_arange", aliases=("arange",),
          attr_defaults={"start": 0.0, "stop": None, "step": 1.0,
                         "repeat": 1, "dtype": "float32"})
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32",
            device=None, **kw):
    if stop is None:
        start, stop = 0.0, start
    out = torch.arange(start, stop, step,
                       dtype=_dtype(dtype),
                       device=device)
    if repeat != 1:
        out = out.repeat_interleave(int(repeat))
    return out
