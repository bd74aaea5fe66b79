"""Neural-network layer ops (subset).

PyTorch counterpart of the part of ``mxnet_tpu/ops/nn.py`` that the
transformer LM, the symbolic zoo and Gluon's layers run:
``FullyConnected``, ``Convolution``, ``Deconvolution``, ``Pooling``,
``BatchNorm``, ``InstanceNorm``, ``LayerNorm``, ``LRN``, ``Activation``,
``LeakyReLU`` (leaky, prelu, elu, selu, gelu, rrelu), ``Dropout``,
``softmax``, ``log_softmax``, ``SoftmaxActivation``, ``UpSampling``
(nearest), the loss heads ``SoftmaxOutput``, ``LinearRegressionOutput``,
``MAERegressionOutput``, ``LogisticRegressionOutput``, ``SVMOutput``
and ``MakeLoss`` with their own gradients, ``softmax_cross_entropy``,
``IdentityAttachKLSparseReg`` and the ``_v1`` aliases.  The
large matrix products go to ``torch.nn.functional.linear`` and the
convolutions to ``torch.nn.functional.conv{1,2,3}d`` (cuBLAS and cuDNN on
the card), as the JAX package leaves them to XLA.  ``layout="NHWC"``
keeps the weight in OIHW: an (N, H, W, C) tensor permuted to
(0, 3, 1, 2) is the same memory seen as a channels-last NCHW tensor, so
the NCHW functions run on it without a copy.  Every op but the loss
heads and the KL penalty gets its gradient from autograd; none of them writes in
place to a tensor autograd saved.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import _relu, _sign
from .indexing import _pick
from .registry import register, alias


def _pair(v, n=2):
    """An int or a sequence as an n-tuple (the JAX package's rule: a
    sequence of another length is repeated n times)."""
    if isinstance(v, (int, float)):
        return (int(v),) * n
    t = tuple(int(x) for x in v)
    return t if len(t) == n else t * n


@register("FullyConnected", arg_names=["data", "weight", "bias"],
          attr_defaults={"num_hidden": 0, "no_bias": False, "flatten": True})
def _fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                     flatten=True, **kw):
    """reference: src/operator/fully_connected.cc; weight is (out, in)."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    return F.linear(data, weight, None if no_bias else bias)


# accepted layout attr values per spatial rank; anything else fails
# loudly rather than run channels-first under a channels-last name
_LAYOUTS = {1: {None, "NCW"}, 2: {None, "NCHW", "NHWC"}, 3: {None, "NCDHW"}}
_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _check_layout(layout, rank):
    """Validate ``layout``; True for the channels-last (NHWC) path."""
    if layout not in _LAYOUTS.get(rank, {None}):
        raise ValueError(
            f"unsupported layout {layout!r} for {rank}d conv/pool "
            f"(allowed: {sorted(x for x in _LAYOUTS[rank] if x)})")
    return layout == "NHWC"


def _to_nchw(x):
    """(N, H, W, C) -> the same memory as a channels-last (N, C, H, W)."""
    return x.permute(0, 3, 1, 2)


def _to_nhwc(x):
    return x.permute(0, 2, 3, 1)


@register("Convolution", arg_names=["data", "weight", "bias"],
          attr_defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                         "num_filter": 0, "num_group": 1, "no_bias": False,
                         "layout": None, "workspace": 1024,
                         "cudnn_tune": None, "cudnn_off": False})
def _convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=0, num_group=1, no_bias=False,
                 layout=None, **kw):
    """reference: src/operator/convolution.cc — 1-D/2-D/3-D, symmetric
    padding, dilation, groups; the weight is (out, in / group, *kernel)
    in every layout."""
    rank = data.dim() - 2
    stride = _pair(stride, rank) if stride else (1,) * rank
    dilate = _pair(dilate, rank) if dilate else (1,) * rank
    pad = _pair(pad, rank) if pad else (0,) * rank
    nhwc = _check_layout(layout, rank)
    x = _to_nchw(data) if nhwc else data
    out = _CONV[rank](x, weight, None if no_bias else bias, stride, pad,
                      dilate, int(num_group))
    return _to_nhwc(out) if nhwc else out


_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution", arg_names=["data", "weight", "bias"],
          attr_defaults={"kernel": (), "stride": (), "dilate": (), "pad": (),
                         "adj": (), "target_shape": (), "num_filter": 0,
                         "num_group": 1, "no_bias": True, "layout": None,
                         "workspace": 512})
def _deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                   pad=(), adj=(), num_filter=0, num_group=1, no_bias=True,
                   **kw):
    """reference: deconvolution-inl.h — the transposed convolution, the
    gradient of Convolution with respect to its data; the weight is
    (in, out / group, *kernel), torch's own layout for it.  The output
    is (in - 1) * stride - 2 * pad + dilate * (kernel - 1) + 1 + adj
    along each spatial dim (``target_shape`` is ignored, as in the JAX
    package)."""
    rank = data.dim() - 2
    stride = _pair(stride, rank) if stride else (1,) * rank
    dilate = _pair(dilate, rank) if dilate else (1,) * rank
    pad = _pair(pad, rank) if pad else (0,) * rank
    adj = _pair(adj, rank) if adj else (0,) * rank
    return _CONV_T[rank](data, weight, None if no_bias else bias, stride,
                         pad, adj, int(num_group), dilate)


def _full_pads(in_shape, kernel, stride, pad):
    """Right-edge padding of ``pooling_convention="full"``: enough for
    ceil((in + 2p - k) / s) + 1 windows, and at least ``pad``.  Every
    window is kept, also one that starts in the padding (torch's
    ``ceil_mode`` drops that one)."""
    hi = []
    for n, k, s, p in zip(in_shape, kernel, stride, pad):
        out = int(np.ceil((n + 2 * p - k) / s)) + 1
        hi.append(max((out - 1) * s + k - n - p, p))
    return hi


def _window_reduce(x, pool_type, kernel, stride, lo, hi):
    """Max or sum over each window of an (N, C, *spatial) tensor padded
    by ``lo`` before and ``hi`` after each spatial dim with the
    reduction's identity (-inf, or the dtype's least integer, for max; 0
    for sum and avg); avg divides every window by prod(kernel), padding
    included.  Torch's own implicit padding is taken where it computes
    the same (symmetric, at most half the kernel); otherwise the tensor
    is padded first."""
    rank = len(kernel)
    if rank == 1:
        out = _window_reduce(x.unsqueeze(2), pool_type, (1,) + kernel,
                             (1,) + stride, (0,) + tuple(lo),
                             (0,) + tuple(hi))
        return out.squeeze(2)
    padding = tuple(lo)
    if list(lo) != list(hi) or any(p > k // 2 for p, k in zip(lo, kernel)):
        if pool_type != "max":
            fill = 0.0
        elif x.is_floating_point():
            fill = -math.inf
        else:
            fill = torch.iinfo(x.dtype).min
        pads = []
        for a, b in zip(reversed(lo), reversed(hi)):
            pads += [a, b]
        x = F.pad(x, pads, value=fill)
        padding = 0
    if pool_type == "max":
        fn = F.max_pool2d if rank == 2 else F.max_pool3d
        return fn(x, kernel, stride, padding)
    fn = F.avg_pool2d if rank == 2 else F.avg_pool3d
    return fn(x, kernel, stride, padding, count_include_pad=True,
              divisor_override=1 if pool_type == "sum" else None)


@register("Pooling", arg_names=["data"],
          attr_defaults={"kernel": (), "stride": (), "pad": (),
                         "pool_type": "max", "global_pool": False,
                         "pooling_convention": "valid", "cudnn_off": False,
                         "layout": None})
def _pooling(data, kernel=(), stride=(), pad=(), pool_type="max",
             global_pool=False, pooling_convention="valid", layout=None,
             **kw):
    """reference: src/operator/pooling.cc, with the JAX package's rules:
    ``global_pool`` ignores ``kernel`` and takes the max, or the mean for
    both avg and sum; avg counts the padding (count_include_pad)."""
    rank = data.dim() - 2
    nhwc = _check_layout(layout, rank)
    if pool_type not in ("max", "avg", "sum"):
        raise ValueError(pool_type)
    x = _to_nchw(data) if nhwc else data
    if global_pool:
        ax = tuple(range(2, 2 + rank))
        out = (x.amax(dim=ax, keepdim=True) if pool_type == "max"
               else x.mean(dim=ax, keepdim=True))
    else:
        kernel = _pair(kernel, rank)
        stride = _pair(stride, rank) if stride else (1,) * rank
        pad = _pair(pad, rank) if pad else (0,) * rank
        hi = (_full_pads(x.shape[2:], kernel, stride, pad)
              if pooling_convention == "full" else pad)
        out = _window_reduce(x, pool_type, kernel, stride, pad, hi)
    return _to_nhwc(out) if nhwc else out


@register("BatchNorm", arg_names=["data", "gamma", "beta"],
          aux_names=["moving_mean", "moving_var"], num_aux=2, num_outputs=3,
          num_visible=1, takes_is_train=True,
          attr_defaults={"eps": 1e-3, "momentum": 0.9, "fix_gamma": True,
                         "use_global_stats": False, "output_mean_var": False,
                         "axis": 1, "cudnn_off": False})
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, is_train=True, **kw):
    """reference: src/operator/batch_norm.cc.

    Training returns (out, batch_mean, batch_var, new_moving_mean,
    new_moving_var); the executor writes the last two back into the aux
    arrays.  The moving statistics follow the JAX package:
    ``new = old * momentum + batch * (1 - momentum)`` with the biased
    batch variance (torch's ``running_var`` would take the new value's
    weight as momentum and the unbiased variance).  ``fix_gamma`` takes
    gamma as ones, so gamma gets no gradient from the loss.

    Mixed precision: only ``data`` is in the compute dtype; gamma, beta
    and the moving statistics stay fp32.  Training runs
    ``aten.native_batch_norm``, which accumulates the statistics in fp32
    from the low-precision input and keeps only the input (in its own
    dtype) and the fp32 per-channel mean and invstd for the backward, so
    no fp32 copy of the activation is made or kept.  Inference folds the
    moving statistics into an fp32 per-channel scale and offset and casts
    only those to the data's dtype.  Integer input is promoted to fp32."""
    ax = int(axis) % data.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if not data.is_floating_point():
        data = data.float()
    if is_train and not use_global_stats:
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            data.movedim(ax, 1), g, beta, None, None, True, 0.0, eps)
        mean, invstd = mean.detach(), invstd.detach()
        var = invstd.pow(-2) - eps
        new_mm = moving_mean * momentum + mean * (1 - momentum)
        new_mv = moving_var * momentum + var * (1 - momentum)
        return out.movedim(1, ax), mean, var, new_mm, new_mv
    scale = g * torch.rsqrt(moving_var + eps)
    offset = beta - moving_mean * scale
    bshape = tuple(data.shape[ax] if i == ax else 1
                   for i in range(data.dim()))
    out = (data * scale.reshape(bshape).to(data.dtype)
           + offset.reshape(bshape).to(data.dtype))
    return out, moving_mean, moving_var


@register("InstanceNorm", arg_names=["data", "gamma", "beta"],
          attr_defaults={"eps": 1e-3})
def _instance_norm(data, gamma, beta, eps=1e-3, **kw):
    """reference: src/operator/instance_norm.cc — each (example, channel)
    normalised over its spatial dims with the biased variance."""
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = data.var(dim=red, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.dim() - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


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


@register("LRN", arg_names=["data"],
          attr_defaults={"alpha": 1e-4, "beta": 0.75, "knorm": 2.0,
                         "nsize": 5})
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    """reference: src/operator/lrn.cc — cross-channel local response
    normalisation of (N, C, H, W): each value over (knorm + alpha / nsize
    * the sum of squares of the nsize channels around it) ** beta."""
    sq = data.square()
    pad = int(nsize) // 2
    sq_pad = F.pad(sq, (0, 0, 0, 0, pad, pad))
    c = data.shape[1]
    windows = sum(sq_pad[:, i:i + c] for i in range(int(nsize)))
    return data / (knorm + alpha / nsize * windows).pow(beta)


@register("Dropout", arg_names=["data"], needs_rng=True, takes_is_train=True,
          num_outputs=2, num_visible=1,
          attr_defaults={"p": 0.5, "mode": "training", "axes": ()})
def _dropout(data, p=0.5, mode="training", axes=(), is_train=True,
             generator=None, **kw):
    """reference: src/operator/dropout.cc — returns (out, mask); the graph
    shows only ``out``.  It draws only in training or with
    ``mode="always"``: each element (or each slice along ``axes``, whose
    mask dims are 1 and broadcast) is kept with probability 1 - p and
    scaled by 1 / (1 - p).  ``generator`` (the executor's
    ``torch.Generator``, on the data's device) supplies the bits, which
    are not the JAX package's."""
    if (not is_train and mode != "always") or p <= 0.0:
        return data, torch.ones_like(data)
    shape = list(data.shape)
    for a in (axes or ()):
        shape[a] = 1
    keep = torch.rand(shape, generator=generator, device=data.device) \
        < (1.0 - p)
    mask = keep.to(data.dtype) / (1.0 - p)
    return data * mask, mask.expand(data.shape)


_ACTIVATIONS = {
    "relu": _relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", arg_names=["data"], attr_defaults={"act_type": "relu"})
def _activation(data, act_type="relu", **kw):
    """reference: src/operator/activation.cc (softrelu is softplus)."""
    try:
        fn = _ACTIVATIONS[act_type]
    except KeyError:
        raise ValueError(act_type) from None
    return fn(data)


_SELU_SCALE, _SELU_ALPHA = 1.0507009873554805, 1.6732632423543772


@register("LeakyReLU", arg_names=["data", "gamma"], needs_rng=True,
          takes_is_train=True,
          attr_defaults={"act_type": "leaky", "slope": 0.25,
                         "lower_bound": 0.125, "upper_bound": 0.334})
def _leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, is_train=True,
                generator=None, **kw):
    """reference: src/operator/leaky_relu.cc.  ``gelu`` is the tanh
    approximation (``jax.nn.gelu``'s default); ``rrelu`` draws each
    negative slope from U(lower, upper) with ``generator`` in training
    (not the JAX package's bits) and takes their mean otherwise."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.dim() - 2)) \
            if gamma.dim() == 1 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "selu":
        return _SELU_SCALE * torch.where(
            data > 0, data, _SELU_ALPHA * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data, approximate="tanh")
    if act_type == "rrelu":
        if is_train:
            s = torch.rand(data.shape, generator=generator,
                           device=data.device).to(data.dtype)
            s = s * (upper_bound - lower_bound) + lower_bound
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise ValueError(act_type)


def _promote(data):
    """Integer input as float32: torch has no integer softmax, and the
    JAX package promotes."""
    return data if data.is_floating_point() else data.float()


@register("softmax", arg_names=["data"],
          attr_defaults={"axis": -1, "temperature": None})
def _softmax(data, axis=-1, temperature=None, **kw):
    data = _promote(data)
    if temperature:
        data = data / temperature
    return torch.softmax(data, dim=int(axis))


@register("log_softmax", arg_names=["data"],
          attr_defaults={"axis": -1, "temperature": None})
def _log_softmax(data, axis=-1, temperature=None, **kw):
    data = _promote(data)
    if temperature:
        data = data / temperature
    return torch.log_softmax(data, dim=int(axis))


@register("SoftmaxActivation", arg_names=["data"],
          attr_defaults={"mode": "instance"})
def _softmax_activation(data, mode="instance", **kw):
    data = _promote(data)
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


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


class MakeLossFunction(torch.autograd.Function):
    """Identity forward whose gradient is the constant ``grad_scale``,
    normalised by ``normalization`` (counterpart of the JAX package's
    ``_makeloss_core`` ``custom_vjp``): the cotangent arriving from above
    is replaced, as the other loss heads do.  ``batch`` divides by the
    leading dim (0-d data counts as batch 1); ``valid`` by the count of
    elements above ``valid_thresh``, at least 1."""

    @staticmethod
    def forward(ctx, data, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(data)
        ctx.opts = (grad_scale, valid_thresh, normalization)
        return data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        data, = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.opts
        if normalization == "batch":
            scale = grad_scale / (data.shape[0] if data.dim() else 1)
            grad = torch.full_like(data, scale)
        elif normalization == "valid":
            valid = (data > valid_thresh).sum().clamp(min=1) \
                .to(torch.float32)
            grad = (grad_scale / valid).to(data.dtype).expand(data.shape)
        else:
            grad = torch.full_like(data, grad_scale)
        return grad.to(g.dtype), None, None, None


@register("MakeLoss", arg_names=["data"],
          attr_defaults={"grad_scale": 1.0, "valid_thresh": 0.0,
                         "normalization": "null"})
def _makeloss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null",
              **kw):
    """reference: src/operator/make_loss.cc — forward is the identity,
    the backward is :class:`MakeLossFunction`'s.  An unknown
    ``normalization`` is refused, as the reference refuses an invalid
    enum value when the op is created."""
    normalization = str(normalization)
    if normalization not in ("null", "batch", "valid"):
        raise ValueError("MakeLoss normalization must be one of "
                         "'null'/'batch'/'valid', got %r" % normalization)
    if torch.is_grad_enabled() and data.requires_grad:
        return MakeLossFunction.apply(data, float(grad_scale),
                                      float(valid_thresh), normalization)
    return data


class _RegressionOutputFunction(torch.autograd.Function):
    """The regression heads (counterpart of the JAX package's
    ``_make_regression_output`` ``custom_vjp``): the forward is the link
    function, the backward replaces the seed gradient by
    ``grad(out, label) * grad_scale``, the label reshaped to the output's
    shape; the label gets no gradient."""

    @staticmethod
    def forward(ctx, data, label, link, grad_fn, grad_scale):
        out = link(data)
        ctx.save_for_backward(out, label)
        ctx.opts = (grad_fn, grad_scale)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_fn, grad_scale = ctx.opts
        grad = grad_fn(out, label.reshape(out.shape).to(out.dtype))
        return (grad * grad_scale).to(g.dtype), None, None, None, None


def _regression_output(name, link, grad_fn):
    def _op(data, label, grad_scale=1.0, **kw):
        if torch.is_grad_enabled() and data.requires_grad:
            return _RegressionOutputFunction.apply(data, label, link,
                                                   grad_fn, float(grad_scale))
        return link(data)
    _op.__doc__ = (f"reference: src/operator/regression_output.cc "
                   f"{name}; the gradient is "
                   ":class:`_RegressionOutputFunction`'s.")
    register(name, arg_names=["data", "label"],
             attr_defaults={"grad_scale": 1.0})(_op)


_regression_output("LinearRegressionOutput", lambda x: x,
                   lambda o, l: o - l)
_regression_output("MAERegressionOutput", lambda x: x,
                   lambda o, l: _sign(o - l))
_regression_output("LogisticRegressionOutput", torch.sigmoid,
                   lambda o, l: o - l)


def svm_output_grad(data, label, margin, reg, use_linear):
    """The one-vs-all hinge gradient of ``SVMOutput`` (the reference's
    L1_SVM / L2_SVM kernels, svm_output.cc:30,48, as the JAX package
    vectorises them), in float32 and cast back to the data's dtype.  A
    label outside [0, classes) gets no true class, as ``jax.nn.one_hot``
    gives."""
    f32 = data.float()
    lab = label.to(torch.int64)
    onehot = (lab.unsqueeze(-1) == torch.arange(
        data.shape[-1], device=data.device)).float()
    if use_linear:
        g_true = -(margin > f32).float() * reg
        g_other = (margin > -f32).float() * reg
    else:
        g_true = -2.0 * reg * (margin - f32) * (margin > f32)
        g_other = 2.0 * reg * (margin + f32) * (margin > -f32)
    grad = onehot * g_true + (1.0 - onehot) * g_other
    return grad.to(data.dtype)


class _SVMOutputFunction(torch.autograd.Function):
    """Identity forward; the backward replaces the seed gradient by
    :func:`svm_output_grad` (the JAX package's ``_svm_core``)."""

    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.opts = (margin, reg, use_linear)
        return data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        grad = svm_output_grad(data, label, *ctx.opts)
        return grad.to(g.dtype), None, None, None, None


@register("SVMOutput", arg_names=["data", "label"],
          attr_defaults={"margin": 1.0, "regularization_coefficient": 1.0,
                         "use_linear": False})
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **kw):
    """reference: src/operator/svm_output.cc — the forward is the
    identity, the loss lives in the backward: the one-vs-all squared
    hinge (L2-SVM), or the hinge with ``use_linear`` (L1-SVM)."""
    if torch.is_grad_enabled() and data.requires_grad:
        return _SVMOutputFunction.apply(
            data, label, float(margin), float(regularization_coefficient),
            bool(use_linear))
    return data


@register("softmax_cross_entropy", arg_names=["data", "label"])
def _softmax_ce(data, label, **kw):
    """The summed cross entropy of ``log_softmax(data)`` at the labels, a
    0-d tensor; a label outside [-classes, classes) reads NaN, as the JAX
    package's ``take_along_axis`` does (see ``batch_take``)."""
    return -_pick(torch.log_softmax(_promote(data), dim=-1),
                  label, axis=-1).sum()


@register("UpSampling", variadic=True,
          attr_defaults={"scale": 1, "sample_type": "nearest",
                         "num_args": 1, "workspace": 512, "num_filter": 0,
                         "multi_input_mode": "concat"})
def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", **kw):
    """reference: src/operator/upsampling.cc, nearest mode: each input's
    rows and columns repeated ``scale`` times, several inputs concatenated
    on the channels or summed (``multi_input_mode``).

    ``sample_type="bilinear"`` is refused: the JAX package computes
    nearest for it too, repeating the weight input as if it were data (a
    fault of the reference, ROADMAP §3), and the port gives no answer
    rather than that one."""
    if sample_type != "nearest":
        raise MXNetError(
            f"UpSampling: sample_type={sample_type!r} is not supported; the "
            "JAX package computes nearest for bilinear, repeating the weight "
            "as data (a reference fault, ROADMAP §3)")
    s = int(scale)
    outs = [a.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
            for a in args]
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


# legacy _v1 ops (reference: batch_norm_v1.cc, convolution_v1.cc,
# pooling_v1.cc): older implementations of the same math, kept for graph
# compatibility; true aliases, as in the JAX package
alias("BatchNorm_v1", "BatchNorm")
alias("Convolution_v1", "Convolution")
alias("Pooling_v1", "Pooling")


class _KLSparseRegFunction(torch.autograd.Function):
    """Identity forward; the backward adds the KL sparseness penalty
    ``penalty * (-rho / mu + (1 - rho) / (1 - mu))`` of the per-unit
    moving average ``mu`` to the incoming gradient (the JAX package's
    ``_klreg_core``)."""

    @staticmethod
    def forward(ctx, data, moving_avg, rho, penalty):
        ctx.save_for_backward(moving_avg)
        ctx.opts = (rho, penalty)
        return data.view_as(data)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        mu, = ctx.saved_tensors
        rho, penalty = ctx.opts
        pen = penalty * (-rho / mu + (1.0 - rho) / (1.0 - mu))
        shape = (1,) + tuple(pen.shape) if g.dim() == pen.dim() + 1 \
            else pen.shape
        return g + pen.reshape(shape).to(g.dtype), None, None, None


@register("IdentityAttachKLSparseReg", arg_names=["data"], num_aux=1,
          aux_names=["moving_avg"], takes_is_train=True,
          attr_defaults={"sparseness_target": 0.1, "penalty": 0.001,
                         "momentum": 0.9})
def _identity_attach_kl_sparse_reg(data, moving_avg, sparseness_target=0.1,
                                   penalty=0.001, momentum=0.9,
                                   is_train=False, **kw):
    """reference: src/operator/identity_attach_KL_sparse_reg-inl.h — the
    identity, with the KL sparseness penalty of
    :class:`_KLSparseRegFunction` attached to its gradient.  As in the JAX
    package, the training forward updates the aux ``moving_avg`` (the
    momentum average of each unit's mean activation over the batch) and
    returns it after the output; the reference updates it in the
    backward."""
    rho, pen = float(sparseness_target), float(penalty)

    def attach(mu):
        if torch.is_grad_enabled() and data.requires_grad:
            return _KLSparseRegFunction.apply(data, mu, rho, pen)
        return data
    if is_train:
        avg = data.detach().reshape(data.shape[0], -1).mean(0) \
            .reshape(moving_avg.shape)
        ma = momentum * moving_avg + (1.0 - momentum) * avg
        return attach(ma), ma
    return attach(moving_avg)
