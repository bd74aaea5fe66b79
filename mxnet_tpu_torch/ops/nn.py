"""Neural-network layer ops (subset).

PyTorch counterpart of the part of ``mxnet_tpu/ops/nn.py`` the transformer
LM runs: ``FullyConnected``, ``LayerNorm``, ``softmax`` and the forward of
``SoftmaxOutput``.  The large matrix products go to ``torch.nn.functional
.linear`` (cuBLAS on the card), as the JAX package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("FullyConnected", arg_names=["data", "weight", "bias"],
          attr_defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, **kw):
    """reference: src/operator/fully_connected.cc; weight is (out, in)."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


@register("LayerNorm", arg_names=["data", "gamma", "beta"], num_outputs=3,
          num_visible=1,
          attr_defaults={"axis": -1, "eps": 1e-5, "output_mean_var": False})
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
                **kw):
    """Returns (out, mean, var); the graph shows only ``out``.  The
    variance is the biased one, as ``jnp.var``."""
    ax = int(axis) % data.dim()
    mean = data.mean(dim=ax, keepdim=True)
    var = data.var(dim=ax, keepdim=True, correction=0)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    out = out * gamma.reshape(bshape) + beta.reshape(bshape)
    return out, mean.squeeze(ax), var.squeeze(ax)


@register("softmax", arg_names=["data"],
          attr_defaults={"axis": -1, "temperature": None})
def _softmax(data, axis=-1, temperature=None, **kw):
    if temperature:
        data = data / temperature
    return torch.softmax(data, dim=int(axis))


@register("SoftmaxOutput", arg_names=["data", "label"],
          aliases=("Softmax",),
          attr_defaults={"grad_scale": 1.0, "ignore_label": -1.0,
                         "multi_output": False, "use_ignore": False,
                         "preserve_shape": False, "normalization": "null",
                         "out_grad": False, "smooth_alpha": 0.0})
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0, **kw):
    """reference: src/operator/softmax_output.cc — the forward is softmax
    (over axis 1 with ``multi_output``, else the last axis); the label is
    read only by the gradient, which this package does not port yet."""
    return torch.softmax(data, dim=1 if multi_output else -1)
