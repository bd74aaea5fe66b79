"""Array-creation ops (reference: src/operator/tensor/init_op.cc).

PyTorch counterpart of ``_zeros``, ``_ones``, ``_full``, ``_arange``
(also registered as ``arange``), ``_eye`` and ``_linspace`` in
``mxnet_tpu/ops/init_ops.py``.
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


@register("_eye", attr_defaults={"N": 0, "M": 0, "k": 0, "dtype": "float32"})
def _eye(N=0, M=0, k=0, dtype="float32", device=None, **kw):
    """``jnp.eye(N, M or N, k)``: ones on the k-th diagonal."""
    N, M, k = int(N), int(M) or int(N), int(k)
    rows = torch.arange(N, device=device).unsqueeze(1)
    cols = torch.arange(M, device=device).unsqueeze(0)
    return (cols - rows == k).to(_dtype(dtype))


@register("_linspace", attr_defaults={"start": 0.0, "stop": 1.0, "num": 50,
                                      "endpoint": True, "dtype": "float32"})
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32",
              device=None, **kw):
    """``jnp.linspace``'s arithmetic: ``start * (1 - t) + stop * t`` with
    ``t = i / div`` in the output's float type (float64 for an integer
    one, then floored), and ``stop`` itself appended with ``endpoint``."""
    num, out_dt = int(num), _dtype(dtype)
    comp = out_dt if out_dt.is_floating_point else torch.float64
    div = num - 1 if endpoint else num
    if num > 1:
        t = torch.arange(div, dtype=comp, device=device) / div
        out = start * (1 - t) + stop * t
        if endpoint:
            out = torch.cat([out, torch.full((1,), stop, dtype=comp,
                                             device=device)])
    else:
        out = torch.full((num,), start, dtype=comp, device=device)
    if not out_dt.is_floating_point:
        out = out.floor()
    return out.to(out_dt)
