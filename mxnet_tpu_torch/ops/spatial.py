"""Spatial-sampling ops: GridGenerator, BilinearSampler,
SpatialTransformer and the FlowNet Correlation layer.

PyTorch counterpart of ``mxnet_tpu/ops/spatial.py`` (reference:
src/operator/grid_generator.cc, bilinear_sampler.cc,
spatial_transformer.cc, correlation.cc).  Each is a composition of
gathers and arithmetic; every gradient (the sampler's grid gradient
included) comes from autograd, as the JAX package's comes from
``jax.vjp``.

The reference's conventions hold:

* grids are normalised to [-1, 1], -1 the first pixel and +1 the last
  (x_src = (x + 1) * (W - 1) / 2);
* a bilinear sample outside the input reads 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _affine_grid(theta, h, w):
    """(B, 6) affine parameters -> (B, 2, h, w) sampling grid, channel 0
    = x (the target raster's (x_t, y_t, 1) columns times theta)."""
    theta = theta.reshape(-1, 2, 3)
    xt = torch.linspace(-1.0, 1.0, w, dtype=theta.dtype, device=theta.device)
    yt = torch.linspace(-1.0, 1.0, h, dtype=theta.dtype, device=theta.device)
    gy, gx = torch.meshgrid(yt, xt, indexing="ij")
    tgt = torch.stack([gx.reshape(-1), gy.reshape(-1),
                       torch.ones_like(gx).reshape(-1)])       # (3, hw)
    return torch.matmul(theta, tgt).reshape(-1, 2, h, w)


@register("GridGenerator", arg_names=["data"],
          attr_defaults={"transform_type": "affine", "target_shape": (0, 0)})
def _grid_generator(data, transform_type="affine", target_shape=(0, 0), **kw):
    """reference: src/operator/grid_generator.cc"""
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type == "affine":
        return _affine_grid(data, h, w)
    if transform_type == "warp":
        # data: optical flow (B, 2, H, W); out: normalised (base + flow)
        _, _, fh, fw = data.shape
        xs = torch.arange(fw, dtype=data.dtype, device=data.device)
        ys = torch.arange(fh, dtype=data.dtype, device=data.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        x = (gx[None] + data[:, 0]) * (2.0 / max(fw - 1, 1)) - 1.0
        y = (gy[None] + data[:, 1]) * (2.0 / max(fh - 1, 1)) - 1.0
        return torch.stack([x, y], dim=1)
    raise ValueError(f"unknown transform_type {transform_type!r}")


def _bilinear_sample(data, grid):
    """Sample NCHW ``data`` at the normalised ``grid`` (B, 2, h, w); a
    neighbour outside the input reads 0."""
    b, c, ih, iw = data.shape
    x = (grid[:, 0] + 1.0) * (iw - 1) / 2.0          # (B, h, w)
    y = (grid[:, 1] + 1.0) * (ih - 1) / 2.0
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = data.reshape(b, c, ih * iw)

    def gather(yi, xi):
        inb = (yi >= 0) & (yi <= ih - 1) & (xi >= 0) & (xi <= iw - 1)
        yc = yi.clamp(0, ih - 1).long()
        xc = xi.clamp(0, iw - 1).long()
        idx = (yc * iw + xc).reshape(b, 1, -1).expand(b, c, -1)
        vals = torch.gather(flat, 2, idx).reshape(b, c, *yi.shape[1:])
        return vals * inb[:, None].to(data.dtype)

    tl = gather(y0, x0)
    tr = gather(y0, x0 + 1)
    bl = gather(y0 + 1, x0)
    br = gather(y0 + 1, x0 + 1)
    wx, wy = wx[:, None], wy[:, None]
    return ((1 - wy) * ((1 - wx) * tl + wx * tr)
            + wy * ((1 - wx) * bl + wx * br))


@register("BilinearSampler", arg_names=["data", "grid"])
def _bilinear_sampler(data, grid, **kw):
    """reference: src/operator/bilinear_sampler.cc"""
    return _bilinear_sample(data, grid)


@register("SpatialTransformer", arg_names=["data", "loc"],
          attr_defaults={"target_shape": (0, 0),
                         "transform_type": "affine",
                         "sampler_type": "bilinear"})
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine",
                         sampler_type="bilinear", **kw):
    """reference: src/operator/spatial_transformer.cc (affine with
    bilinear sampling, the one combination the reference implements)."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise ValueError("SpatialTransformer supports affine/bilinear only")
    h, w = int(target_shape[0]), int(target_shape[1])
    return _bilinear_sample(data, _affine_grid(loc.to(data.dtype), h, w))


@register("Correlation", arg_names=["data1", "data2"], num_outputs=1,
          attr_defaults={"kernel_size": 1, "max_displacement": 1,
                         "stride1": 1, "stride2": 1, "pad_size": 0,
                         "is_multiply": True})
def _correlation(data1, data2, kernel_size=1, max_displacement=1,
                 stride1=1, stride2=1, pad_size=0, is_multiply=True, **kw):
    """FlowNet correlation layer (reference: src/operator/correlation.cc).

    Output (B, D*D, Ho, Wo), D = 2*(max_displacement//stride2) + 1: each
    channel (dy, dx) is the mean over channels and the k x k window of
    data1[p] * data2[p + d] (|data1 - data2| without ``is_multiply``), on
    inputs padded by pad_size, at stride1 raster positions.  One
    displacement at a time, as the JAX package's static loop."""
    b, c, h, w = data1.shape
    k = int(kernel_size)
    kr = (k - 1) // 2                    # kernel_radius (correlation-inl.h:96)
    md = int(max_displacement)
    pad = int(pad_size)
    s1, s2 = int(stride1), int(stride2)
    nd = md // s2                        # neighborhood_grid_radius
    pads = (pad, pad, pad, pad)
    p1 = torch.nn.functional.pad(data1, pads)
    p2 = torch.nn.functional.pad(data2, pads)
    ph, pw = h + 2 * pad, w + 2 * pad
    border = md + kr                     # correlation-inl.h:100-102
    ho = int(np.ceil((ph - 2 * border) / float(s1)))
    wo = int(np.ceil((pw - 2 * border) / float(s1)))
    dev = data1.device
    # window corners: x1 = x*stride1 + max_displacement, the window spans
    # [x1, x1 + k) (correlation.cu:59-69)
    ys = md + torch.arange(ho, device=dev) * s1
    xs = md + torch.arange(wo, device=dev) * s1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def window_mean(prod):
        if k > 1:
            cum = torch.nn.functional.pad(prod, (1, 0, 1, 0)) \
                .cumsum(dim=2).cumsum(dim=3)
            out = (cum[:, :, gy + k, gx + k] - cum[:, :, gy, gx + k]
                   - cum[:, :, gy + k, gx] + cum[:, :, gy, gx])
        else:
            out = prod[:, :, gy, gx]
        return out.mean(dim=1) / (k * k)

    chans = []
    for dy in range(-nd, nd + 1):
        for dx in range(-nd, nd + 1):
            shifted = torch.roll(p2, (-dy * s2, -dx * s2), dims=(2, 3))
            prod = p1 * shifted if is_multiply else (p1 - shifted).abs()
            chans.append(window_mean(prod))
    return torch.stack(chans, dim=1)
