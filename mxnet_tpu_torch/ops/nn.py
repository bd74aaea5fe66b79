"""Neural-network layer ops (subset).

PyTorch counterpart of the part of ``mxnet_tpu/ops/nn.py`` the transformer
LM runs: ``FullyConnected``, ``LayerNorm``, ``softmax`` and
``SoftmaxOutput`` with its gradient.  The large matrix products go to
``torch.nn.functional.linear`` (cuBLAS on the card), as the JAX package
leaves them to XLA.  Every op but ``SoftmaxOutput`` gets its gradient from
autograd; none of them writes in place to a tensor autograd saved.
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
    (over axis 1 with ``multi_output``, else the last axis); the gradient
    is :class:`SoftmaxOutputFunction`'s."""
    opts = (float(grad_scale), float(ignore_label), bool(use_ignore),
            bool(multi_output), str(normalization), float(smooth_alpha))
    if torch.is_grad_enabled() and data.requires_grad:
        return SoftmaxOutputFunction.apply(data, label, *opts)
    return torch.softmax(data, dim=1 if multi_output else -1)


def softmax_output_grad(out, label, grad_scale=1.0, ignore_label=-1.0,
                        use_ignore=False, multi_output=False,
                        normalization="null", smooth_alpha=0.0):
    """The head gradient of ``SoftmaxOutput``: ``(out - onehot(label)) *
    grad_scale``, with the JAX package's ``_softmax_output_vjp_bwd``
    rules.  A label of out's rank is a dense per-class target; otherwise
    it holds class ids, float or integer, truncated to int as
    ``astype(int32)`` does (a bf16 label has already been rounded).
    Ids outside [0, nclass) get a zero one-hot row, as ``jax.nn.one_hot``
    gives.  ``smooth_alpha`` blends the one-hot with the uniform
    distribution; ``use_ignore`` zeroes rows whose id is
    ``ignore_label``; ``normalization`` is ``null``, ``batch`` (divide by
    the leading dim) or ``valid`` (divide by the count of kept rows)."""
    axis = 1 if multi_output else out.dim() - 1
    nclass = out.shape[axis]
    valid = None
    if label.dim() == out.dim():
        grad = out - label.to(out.dtype)
    else:
        lab = label.to(torch.int64)
        hit = ((lab >= 0) & (lab < nclass)).to(out.dtype).unsqueeze(axis)
        idx = lab.clamp(0, nclass - 1).unsqueeze(axis)
        grad = out.clone()
        if smooth_alpha:
            grad -= smooth_alpha / nclass
            hit = hit * (1.0 - smooth_alpha)
        grad.scatter_add_(axis, idx, -hit)
        if use_ignore:
            keep = lab != int(ignore_label)
            grad *= keep.unsqueeze(axis).to(out.dtype)
            valid = keep.sum().clamp(min=1).to(out.dtype)
    if normalization == "batch":
        grad = grad / out.shape[0]
    elif normalization == "valid":
        if valid is None:
            valid = out.numel() // nclass
        grad = grad / valid
    return grad * grad_scale


class SoftmaxOutputFunction(torch.autograd.Function):
    """Softmax forward with the loss head's own gradient (counterpart of
    the JAX package's ``_softmax_output_core`` ``custom_vjp``).  The
    incoming cotangent is ignored, as the reference's loss heads do: the
    executor seeds every output with ones and this op answers with
    :func:`softmax_output_grad`.  The label gets no gradient."""

    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                multi_output, normalization, smooth_alpha):
        out = torch.softmax(data, dim=1 if multi_output else -1)
        ctx.save_for_backward(out, label)
        ctx.opts = (grad_scale, ignore_label, use_ignore, multi_output,
                    normalization, smooth_alpha)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = softmax_output_grad(out, label, *ctx.opts)
        return (grad.to(g.dtype),) + (None,) * 7
