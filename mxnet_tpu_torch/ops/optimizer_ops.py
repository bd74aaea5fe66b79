"""Optimizer update ops.

PyTorch counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (reference:
src/operator/optimizer_op.cc): plain functions of tensors with the JAX
package's formulas, each returning (new_weight, *new_states).  The
gradient is first scaled by ``rescale_grad`` and then, where
``clip_gradient`` > 0, clipped to [-clip_gradient, clip_gradient].
``adam_update`` applies no bias correction (the Python optimizer folds it
into ``lr``).  The mixed-precision ``mp_sgd_*`` ops update an fp32 master
copy and return the weight cast to its own dtype.
``nd.*_update(..., out=weight)`` writes the new weight into ``weight``;
the new states are the op's further outputs.
"""
from __future__ import annotations

import torch

from .elemwise import _sign
from .registry import register


def _clip_grad(grad, clip_gradient):
    if clip_gradient is not None and clip_gradient > 0:
        return torch.clamp(grad, -clip_gradient, clip_gradient)
    return grad


@register("sgd_update", arg_names=["weight", "grad"],
          attr_defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                         "clip_gradient": -1.0})
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient)
    return weight - lr * (g + wd * weight)


@register("sgd_mom_update", arg_names=["weight", "grad", "mom"],
          num_outputs=2,
          attr_defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                         "rescale_grad": 1.0, "clip_gradient": -1.0})
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight)
    return weight + new_mom, new_mom


@register("mp_sgd_update", arg_names=["weight", "grad", "weight32"],
          num_outputs=2,
          attr_defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                         "clip_gradient": -1.0})
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, **kw):
    """A bf16 (or fp16) weight with its fp32 master copy."""
    g = _clip_grad(grad.float() * rescale_grad, clip_gradient)
    w32 = weight32 - lr * (g + wd * weight32)
    return w32.to(weight.dtype), w32


@register("mp_sgd_mom_update", arg_names=["weight", "grad", "mom", "weight32"],
          num_outputs=3,
          attr_defaults={"lr": 0.01, "momentum": 0.0, "wd": 0.0,
                         "rescale_grad": 1.0, "clip_gradient": -1.0})
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _clip_grad(grad.float() * rescale_grad, clip_gradient)
    new_mom = momentum * mom - lr * (g + wd * weight32)
    w32 = weight32 + new_mom
    return w32.to(weight.dtype), new_mom, w32


@register("adam_update", arg_names=["weight", "grad", "mean", "var"],
          num_outputs=3,
          attr_defaults={"lr": 0.001, "beta1": 0.9, "beta2": 0.999,
                         "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                         "clip_gradient": -1.0})
def _adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient) + wd * weight
    m = beta1 * mean + (1 - beta1) * g
    v = beta2 * var + (1 - beta2) * torch.square(g)
    w = weight - lr * m / (torch.sqrt(v) + epsilon)
    return w, m, v


@register("rmsprop_update", arg_names=["weight", "grad", "n"], num_outputs=2,
          attr_defaults={"lr": 0.001, "gamma1": 0.95, "epsilon": 1e-8,
                         "wd": 0.0, "rescale_grad": 1.0, "clip_gradient": -1.0,
                         "clip_weights": -1.0})
def _rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0, **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(g)
    w = weight - lr * g / torch.sqrt(new_n + epsilon)
    if clip_weights and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n


@register("rmspropalex_update",
          arg_names=["weight", "grad", "n", "g", "delta"], num_outputs=4,
          attr_defaults={"lr": 0.001, "gamma1": 0.95, "gamma2": 0.9,
                         "epsilon": 1e-8, "wd": 0.0, "rescale_grad": 1.0,
                         "clip_gradient": -1.0, "clip_weights": -1.0})
def _rmspropalex_update(weight, grad, n, g, delta, lr=0.001, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0, **kw):
    gr = _clip_grad(grad * rescale_grad, clip_gradient) + wd * weight
    new_n = gamma1 * n + (1 - gamma1) * torch.square(gr)
    new_g = gamma1 * g + (1 - gamma1) * gr
    new_delta = gamma2 * delta - lr * gr / torch.sqrt(
        new_n - torch.square(new_g) + epsilon)
    w = weight + new_delta
    if clip_weights and clip_weights > 0:
        w = torch.clamp(w, -clip_weights, clip_weights)
    return w, new_n, new_g, new_delta


@register("ftrl_update", arg_names=["weight", "grad", "z", "n"],
          num_outputs=3,
          attr_defaults={"lr": 0.1, "lamda1": 0.01, "beta": 1.0, "wd": 0.0,
                         "rescale_grad": 1.0, "clip_gradient": -1.0})
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0, **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    sigma = (torch.sqrt(new_n) - torch.sqrt(n)) / lr
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) <= lamda1, torch.zeros_like(weight),
        -(new_z - _sign(new_z) * lamda1)
        / ((beta + torch.sqrt(new_n)) / lr + wd))
    return w, new_z, new_n


@register("signsgd_update", arg_names=["weight", "grad"],
          attr_defaults={"lr": 0.01, "wd": 0.0, "rescale_grad": 1.0,
                         "clip_gradient": -1.0})
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0, **kw):
    g = _clip_grad(grad * rescale_grad, clip_gradient)
    return weight - lr * (_sign(g) + wd * weight)
