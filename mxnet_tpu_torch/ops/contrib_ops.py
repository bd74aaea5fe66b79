"""Contrib operator tail: FFT, count-sketch, quantization, region
proposals, position-sensitive ROI pooling, deformable convolution and
pooling.

PyTorch counterpart of ``mxnet_tpu/ops/contrib_ops.py`` (reference:
src/operator/contrib/).  The JAX package ``vmap``s one image's or one
ROI's function; here each op takes the whole batch (or every ROI) in one
set of tensor ops:

* ``fft`` / ``ifft`` are ``torch.fft`` (ifft unnormalised, as cuFFT's
  C2R is);
* ``count_sketch`` is one ``index_add``;
* ``Proposal`` / ``MultiProposal`` sort each image's anchors with a
  stable descending sort (``lax.top_k`` puts the lower index first in a
  tie) and run the greedy NMS of :func:`.detection.nms_keep` with the
  reference's +1 pixel overlap (:func:`.detection.pixel_iou`);
* ``PSROIPooling`` averages each bin through a summed-area table;
* the deformable ops sample bilinearly by gathers, and autograd gives
  every gradient (offsets included), as ``jax.vjp`` does there.

Where a gradient flows through a clip, it is :func:`.detection.jnp_clip`,
which treats the ends as ``jnp.clip`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register
from .detection import jnp_clip as _clip, nms_keep, pixel_iou


# --- FFT (reference: contrib/fft-inl.h; complex numbers interleaved as
# re, im in the last dim; ifft unnormalised) --------------------------------

@register("_contrib_fft", arg_names=["data"],
          attr_defaults={"compute_size": 128})
def _fft(data, compute_size=128, **kw):
    """reference: src/operator/contrib/fft-inl.h (output last dim 2*d,
    re and im interleaved)."""
    c = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.stack([c.real, c.imag], dim=-1)
    return out.reshape(*data.shape[:-1], 2 * data.shape[-1]).to(data.dtype)


@register("_contrib_ifft", arg_names=["data"],
          attr_defaults={"compute_size": 128})
def _ifft(data, compute_size=128, **kw):
    """reference: src/operator/contrib/ifft-inl.h: input interleaved re,
    im (last dim 2*d), output the real part (last dim d), unnormalised:
    callers divide by d."""
    d = data.shape[-1] // 2
    pairs = data.to(torch.float32).reshape(*data.shape[:-1], d, 2)
    c = torch.complex(pairs[..., 0], pairs[..., 1])
    return (torch.fft.ifft(c, dim=-1).real * d).to(data.dtype)


@register("_contrib_count_sketch", arg_names=["data", "h", "s"],
          attr_defaults={"out_dim": 0, "processing_batch_size": 32})
def _count_sketch(data, h, s, out_dim=0, processing_batch_size=32, **kw):
    """Count-sketch projection (reference: contrib/count_sketch-inl.h):
    out[n, h[i]] += s[i] * data[n, i].  ``processing_batch_size`` is
    the reference's memory knob and changes nothing here."""
    out_dim = int(out_dim)
    if out_dim <= 0:
        raise ValueError("count_sketch: out_dim is required and must be > 0 "
                         "(reference: CountSketchParam out_dim has no "
                         "default)")
    idx = h.reshape(-1).to(torch.int64)
    sign = s.reshape(-1).to(data.dtype)
    out = torch.zeros(data.shape[:-1] + (out_dim,), dtype=data.dtype,
                      device=data.device)
    return out.index_add(-1, idx, sign * data)


# --- quantization (reference: contrib/quantize-inl.h, dequantize-inl.h) ----

@register("_contrib_quantize", arg_names=["data", "min_range", "max_range"],
          num_outputs=3, differentiable=False,
          attr_defaults={"out_type": "uint8"})
def _quantize(data, min_range, max_range, out_type="uint8", **kw):
    """out = uint8((in - min) * 255 / (max - min) + 0.5); returns
    (quantized, min, max) as the reference's three outputs."""
    if out_type != "uint8":
        raise NotImplementedError(
            "quantize: only out_type='uint8' is implemented (the reference "
            "kernel is uint8-only too, quantize-inl.h:70-72)")
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = 255.0 / (hi - lo)
    q = ((data - lo) * scale + 0.5).clamp(0.0, 255.0).to(torch.uint8)
    return q, lo.reshape(min_range.shape), hi.reshape(max_range.shape)


@register("_contrib_dequantize", arg_names=["data", "min_range", "max_range"],
          differentiable=False, attr_defaults={"out_type": "float32"})
def _dequantize(data, min_range, max_range, out_type="float32", **kw):
    if out_type != "float32":
        raise NotImplementedError(
            "dequantize: only out_type='float32' is implemented")
    if data.dtype != torch.uint8:
        raise NotImplementedError(
            "dequantize: input must be uint8 (reference kernel is "
            "uint8->float32 only, dequantize-inl.h:68-70)")
    lo = min_range.reshape(())
    hi = max_range.reshape(())
    scale = (hi - lo) / 255.0
    return data.to(torch.float32) * scale + lo


# --- region proposals (reference: contrib/proposal.cc, multi_proposal.cc) --

def _generate_anchors(base_size, ratios, scales):
    """utils::GenerateAnchors (proposal-inl.h:183-224), ratio-major."""
    anchors = []
    w = h = float(base_size)
    x_ctr = 0.5 * (w - 1.0)
    y_ctr = 0.5 * (h - 1.0)
    size = w * h
    for ratio in ratios:
        size_ratio = np.floor(size / ratio)
        new_w = np.floor(np.sqrt(size_ratio) + 0.5)
        new_h = np.floor(new_w * ratio + 0.5)
        for scale in scales:
            sw, sh = new_w * scale, new_h * scale
            anchors.append([x_ctr - 0.5 * (sw - 1.0),
                            y_ctr - 0.5 * (sh - 1.0),
                            x_ctr + 0.5 * (sw - 1.0),
                            y_ctr + 0.5 * (sh - 1.0)])
    return np.asarray(anchors, np.float32)


def _proposals(fg, deltas, im_info, anchors, stride, pre_n, post_n, thresh,
               min_size):
    """The proposal pipeline for a batch: fg (B, A, H, W) foreground
    scores, deltas (B, 4A, H, W), im_info (B, 3) -> boxes (B, post_n, 4)
    and scores (B, post_n), float32."""
    f32 = torch.float32
    B, a, height, width = fg.shape
    dev = fg.device
    fg, deltas, im_info = fg.to(f32), deltas.to(f32), im_info.to(f32)
    # shifted anchors in (h, w, a) order: index (h*W + w)*A + a, the
    # reference's workspace layout (proposal.cc:347-358)
    sy = torch.arange(height, dtype=f32, device=dev) * stride
    sx = torch.arange(width, dtype=f32, device=dev) * stride
    gy, gx = torch.meshgrid(sy, sx, indexing="ij")
    shifts = torch.stack([gx, gy, gx, gy], dim=-1)             # (H, W, 4)
    boxes = (anchors[None, None] + shifts[:, :, None]).reshape(-1, 4)
    scores = fg.permute(0, 2, 3, 1).reshape(B, -1)             # (B, HWA)

    # BBoxTransformInv (proposal.cc:36-90)
    d = deltas.reshape(B, a, 4, height, width).permute(0, 3, 4, 1, 2) \
        .reshape(B, -1, 4)
    bw = boxes[:, 2] - boxes[:, 0] + 1.0
    bh = boxes[:, 3] - boxes[:, 1] + 1.0
    cx = boxes[:, 0] + 0.5 * (bw - 1.0)
    cy = boxes[:, 1] + 0.5 * (bh - 1.0)
    pcx = d[..., 0] * bw + cx
    pcy = d[..., 1] * bh + cy
    pw = torch.exp(d[..., 2]) * bw
    ph = torch.exp(d[..., 3]) * bh
    im_h, im_w, im_scale = (im_info[:, i:i + 1] for i in range(3))
    zero = torch.zeros((), dtype=f32, device=dev)
    x1 = torch.minimum(torch.maximum(pcx - 0.5 * (pw - 1.0), zero), im_w - 1.0)
    y1 = torch.minimum(torch.maximum(pcy - 0.5 * (ph - 1.0), zero), im_h - 1.0)
    x2 = torch.minimum(torch.maximum(pcx + 0.5 * (pw - 1.0), zero), im_w - 1.0)
    y2 = torch.minimum(torch.maximum(pcy + 0.5 * (ph - 1.0), zero), im_h - 1.0)
    props = torch.stack([x1, y1, x2, y2], dim=-1)              # (B, HWA, 4)

    # the feature map's padding beyond the real image scores -1
    real_h = torch.floor(im_h / stride)
    real_w = torch.floor(im_w / stride)
    ghh = torch.arange(height, dtype=f32, device=dev) \
        .repeat_interleave(width * a)
    gww = torch.arange(width, dtype=f32, device=dev) \
        .repeat_interleave(a).repeat(height)
    scores = torch.where((ghh >= real_h) | (gww >= real_w), -1.0, scores)

    # FilterBox (proposal.cc:144-156): inflate and drop tiny boxes
    ms = min_size * im_scale                                   # (B, 1)
    iw = props[..., 2] - props[..., 0] + 1.0
    ih = props[..., 3] - props[..., 1] + 1.0
    tiny = (iw < ms) | (ih < ms)
    grow = torch.tensor([-0.5, -0.5, 0.5, 0.5], dtype=f32, device=dev)
    props = torch.where(tiny[..., None], props + grow * ms[..., None], props)
    scores = torch.where(tiny, -1.0, scores)

    # the top pre_n by score, ties to the lower index (lax.top_k)
    pre_n = min(pre_n, scores.shape[1])
    order = torch.sort(scores, dim=1, descending=True,
                       stable=True).indices[:, :pre_n]
    top = torch.gather(scores, 1, order)
    dets = torch.gather(props, 1, order[..., None].expand(B, pre_n, 4))

    # greedy NMS over all pre_n boxes, every unsuppressed one suppressing
    # (utils::NonMaximumSuppression)
    kept = nms_keep(dets, torch.ones((B, pre_n), dtype=torch.bool,
                                     device=dev), thresh, pixel_iou)
    out_size = kept.sum(dim=1, keepdim=True).clamp(min=1)
    idx = torch.arange(pre_n, device=dev)
    # kept indices first, each group in ascending (= score) order
    keep_list = torch.sort(torch.where(kept, idx, pre_n + idx),
                           dim=1).indices
    take = torch.arange(post_n, device=dev).expand(B, post_n)
    take = torch.where(take < out_size, take, take % out_size)
    sel = torch.gather(keep_list, 1, take)
    return (torch.gather(dets, 1, sel[..., None].expand(B, post_n, 4)),
            torch.gather(top, 1, sel))


def _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                   rpn_post_nms_top_n, threshold, rpn_min_size, scales,
                   ratios, feature_stride, iou_loss):
    if iou_loss:
        raise NotImplementedError("iou_loss=True Proposal is not supported")
    b, two_a, height, width = cls_prob.shape
    a = two_a // 2
    post_n = int(rpn_post_nms_top_n)
    if cls_prob.is_meta:
        return (torch.empty(b * post_n, 5, dtype=cls_prob.dtype,
                            device="meta"),
                torch.empty(b * post_n, 1, dtype=cls_prob.dtype,
                            device="meta"))
    anchors = torch.from_numpy(_generate_anchors(
        feature_stride, [float(r) for r in ratios],
        [float(s) for s in scales])).to(cls_prob.device)
    assert anchors.shape[0] == a, (anchors.shape, a)
    with torch.no_grad():
        boxes, scores = _proposals(
            cls_prob[:, a:], bbox_pred, im_info, anchors,
            float(feature_stride), int(rpn_pre_nms_top_n), post_n,
            float(threshold), float(rpn_min_size))
    batch_idx = torch.arange(b, dtype=cls_prob.dtype,
                             device=cls_prob.device).repeat_interleave(post_n)
    rois = torch.cat([batch_idx[:, None],
                      boxes.reshape(-1, 4).to(cls_prob.dtype)], dim=1)
    return rois, scores.reshape(-1, 1).to(cls_prob.dtype)


_PROPOSAL_DEFAULTS = {"rpn_pre_nms_top_n": 6000, "rpn_post_nms_top_n": 300,
                      "threshold": 0.7, "rpn_min_size": 16,
                      "scales": (4.0, 8.0, 16.0, 32.0),
                      "ratios": (0.5, 1.0, 2.0),
                      "feature_stride": 16, "output_score": False,
                      "iou_loss": False}


def _proposal_nvis(attrs):
    """reference ProposalProp::NumVisibleOutputs: the scores are an
    output only with output_score=True."""
    v = attrs.get("output_score", False)
    return 2 if v in (True, 1, "True", "true", "1") else 1


@register("_contrib_Proposal", arg_names=["cls_prob", "bbox_pred", "im_info"],
          num_outputs=2, num_visible=_proposal_nvis, differentiable=False,
          aliases=("Proposal",), attr_defaults=dict(_PROPOSAL_DEFAULTS))
def _proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
              rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
              scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
              feature_stride=16, output_score=False, iou_loss=False, **kw):
    """RPN proposals (reference: src/operator/contrib/proposal.cc), batch
    1 as there (MultiProposal takes a batch): rois (post_nms_top_n, 5) =
    [0, x1, y1, x2, y2]."""
    if cls_prob.shape[0] != 1:
        raise ValueError("Proposal expects batch 1; use "
                         "_contrib_MultiProposal")
    return _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                          rpn_post_nms_top_n, threshold, rpn_min_size,
                          scales, ratios, feature_stride, iou_loss)


@register("_contrib_MultiProposal",
          arg_names=["cls_prob", "bbox_pred", "im_info"],
          num_outputs=2, num_visible=_proposal_nvis, differentiable=False,
          aliases=("MultiProposal",), attr_defaults=dict(_PROPOSAL_DEFAULTS))
def _multi_proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
                    rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
                    scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
                    feature_stride=16, output_score=False, iou_loss=False,
                    **kw):
    """Batched RPN proposals (reference: contrib/multi_proposal.cc): rois
    (B * post_nms_top_n, 5) with each image's batch index."""
    return _proposal_impl(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n,
                          rpn_post_nms_top_n, threshold, rpn_min_size,
                          scales, ratios, feature_stride, iou_loss)


# --- position-sensitive ROI pooling (reference: contrib/psroi_pooling.cc) --

def _psroi_channels(od, p, g):
    """The channel of each (output channel, bin row, bin col):
    (ctop*G + gh)*G + gw, psroi_pooling.cu:50-54."""
    gh = np.clip((np.arange(p) * g) // p, 0, g - 1)
    return ((np.arange(od)[:, None, None] * g + gh[None, :, None]) * g
            + gh[None, None, :])


@register("_contrib_PSROIPooling", arg_names=["data", "rois"],
          attr_defaults={"spatial_scale": 0.0625, "output_dim": 0,
                         "pooled_size": 0, "group_size": 0})
def _psroi_pooling(data, rois, spatial_scale=0.0625, output_dim=0,
                   pooled_size=0, group_size=0, **kw):
    """R-FCN position-sensitive ROI pooling (reference:
    src/operator/contrib/psroi_pooling.cu forward kernel): each bin the
    mean of its integer window, by four lookups in a summed-area table.
    rois (R, 5) -> (R, output_dim, p, p)."""
    p = int(pooled_size)
    g = int(group_size) or p
    od = int(output_dim)
    b, c, h, w = data.shape
    R = rois.shape[0]
    if data.is_meta:
        return torch.empty(R, od, p, p, dtype=data.dtype, device="meta")
    f32 = torch.float32
    dev = data.device
    # the table with a zero row and column in front: a rectangle's sum is
    # four corner lookups
    cum = torch.nn.functional.pad(data.to(f32), (1, 0, 1, 0)) \
        .cumsum(dim=2).cumsum(dim=3)
    plane = (h + 1) * (w + 1)
    with torch.no_grad():
        r = rois.detach().to(f32)
        bi = r[:, 0].long()
        x1 = torch.round(r[:, 1]) * spatial_scale
        y1 = torch.round(r[:, 2]) * spatial_scale
        x2 = (torch.round(r[:, 3]) + 1.0) * spatial_scale
        y2 = (torch.round(r[:, 4]) + 1.0) * spatial_scale
        rw = (x2 - x1).clamp(min=0.1)
        rh = (y2 - y1).clamp(min=0.1)
        bs_h, bs_w = (rh / p)[:, None], (rw / p)[:, None]
        i = torch.arange(p, dtype=f32, device=dev)
        hs = torch.floor(i * bs_h + y1[:, None]).clamp(0, h).long()
        he = torch.ceil((i + 1.0) * bs_h + y1[:, None]).clamp(0, h).long()
        ws = torch.floor(i * bs_w + x1[:, None]).clamp(0, w).long()
        we = torch.ceil((i + 1.0) * bs_w + x1[:, None]).clamp(0, w).long()
        cmap = torch.from_numpy(_psroi_channels(od, p, g)).to(dev)
        base = (bi * (c * plane))[:, None, None, None] \
            + (cmap * plane)[None]                          # (R, od, p, p)
        hs_b, he_b = hs[:, None, :, None], he[:, None, :, None]
        ws_b, we_b = ws[:, None, None, :], we[:, None, None, :]
        area = ((he_b - hs_b) * (we_b - ws_b)).to(f32)
    flat = cum.reshape(-1)

    def corner(yy, xx):
        return flat[base + yy * (w + 1) + xx]

    total = (corner(he_b, we_b) - corner(hs_b, we_b)
             - corner(he_b, ws_b) + corner(hs_b, ws_b))
    empty = area <= 0
    out = torch.where(empty, torch.zeros((), dtype=f32, device=dev),
                      total / torch.where(empty, 1.0, area))
    return out.to(data.dtype)


# --- deformable ops (reference: contrib/deformable_convolution.cc,
# contrib/deformable_psroi_pooling.cc; the DCN and R-FCN papers) -------------

def _bilinear(flat, hw, y, x):
    """Bilinear samples of ``flat`` (M, C, H*W) at float coordinates
    ``y``, ``x`` (M, ...) clipped into the map (the caller masks what
    lies outside) -> (M, C, ...)."""
    h, w = hw
    y = _clip(y, 0.0, h - 1.0)
    x = _clip(x, 0.0, w - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy, wx = y - y0, x - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    M, C = flat.shape[0], flat.shape[1]

    def g(yi, xi):
        idx = (yi * w + xi).reshape(M, 1, -1).expand(M, C, -1)
        return torch.gather(flat, 2, idx).reshape((M, C) + y.shape[1:])

    wy, wx = wy[:, None], wx[:, None]
    return ((1 - wy) * (1 - wx) * g(y0i, x0i) + (1 - wy) * wx * g(y0i, x1i)
            + wy * (1 - wx) * g(y1i, x0i) + wy * wx * g(y1i, x1i))


@register("_contrib_DeformableConvolution",
          arg_names=["data", "offset", "weight", "bias"],
          aliases=("DeformableConvolution",),
          attr_defaults={"kernel": (3, 3), "stride": (1, 1),
                         "dilate": (1, 1), "pad": (0, 0), "num_filter": 0,
                         "num_group": 1, "num_deformable_group": 1,
                         "no_bias": False, "workspace": 1024,
                         "layout": None})
def _deformable_convolution(data, offset, weight, bias=None, kernel=(3, 3),
                            stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                            num_filter=0, num_group=1,
                            num_deformable_group=1, no_bias=False, **kw):
    """Deformable convolution v1 (reference:
    src/operator/contrib/nn/deformable_im2col.cuh:240-280): each kernel
    tap samples the input at p0 + pk + dpk bilinearly (0 outside the
    image: a sample with y or x outside [0, size) is dropped, one inside
    reads the edge row for its high neighbour), then a grouped product
    with the weights."""
    b, cin, h, w = data.shape
    kh, kw = int(kernel[0]), int(kernel[1])
    sh, sw = int(stride[0]), int(stride[1])
    dh, dw = int(dilate[0]), int(dilate[1])
    ph_, pw_ = int(pad[0]), int(pad[1])
    dg = int(num_deformable_group)
    ho = (h + 2 * ph_ - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw_ - (dw * (kw - 1) + 1)) // sw + 1
    nf = int(num_filter)
    if data.is_meta:
        return torch.empty(b, nf, ho, wo, dtype=data.dtype, device="meta")
    dt, dev = data.dtype, data.device
    oy = (torch.arange(ho, device=dev) * sh - ph_).to(dt)
    ox = (torch.arange(wo, device=dev) * sw - pw_).to(dt)
    ty = (torch.arange(kh, device=dev) * dh).to(dt)
    tx = (torch.arange(kw, device=dev) * dw).to(dt)
    base_y = oy[None, None, :, None] + ty[:, None, None, None]  # kh,1,ho,1
    base_x = ox[None, None, None, :] + tx[None, :, None, None]  # 1,kw,1,wo

    off = offset.reshape(b * dg, kh * kw, 2, ho, wo)
    y = base_y + off[:, :, 0].reshape(b * dg, kh, kw, ho, wo)
    x = base_x + off[:, :, 1].reshape(b * dg, kh, kw, ho, wo)
    inb = ((y >= 0) & (y < h) & (x >= 0) & (x < w)).to(dt)
    cpg = cin // dg
    cols = _bilinear(data.reshape(b * dg, cpg, h * w), (h, w), y, x) \
        * inb[:, None]                        # (b*dg, cpg, kh, kw, ho, wo)

    g = int(num_group)
    fpg, cpgg = nf // g, cin // g
    wg = weight.reshape(g, fpg, cpgg, kh, kw)
    colsg = cols.reshape(b, g, cpgg, kh, kw, ho, wo)
    out = torch.einsum("bgcijhw,gfcij->bgfhw", colsg.to(torch.float32),
                       wg.to(torch.float32))
    out = out.reshape(b, nf, ho, wo).to(dt)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


@register("_contrib_DeformablePSROIPooling",
          arg_names=["data", "rois", "trans"],
          aliases=("DeformablePSROIPooling",),
          num_outputs=2, num_visible=1,
          attr_defaults={"spatial_scale": 0.0625, "output_dim": 0,
                         "group_size": 0, "pooled_size": 0, "part_size": 0,
                         "sample_per_part": 1, "trans_std": 0.0,
                         "no_trans": False})
def _deformable_psroi_pooling(data, rois, trans=None, spatial_scale=0.0625,
                              output_dim=0, group_size=0, pooled_size=0,
                              part_size=0, sample_per_part=1, trans_std=0.0,
                              no_trans=False, **kw):
    """Deformable PSROI pooling (reference:
    contrib/deformable_psroi_pooling.cu forward kernel): each bin the
    mean of sample_per_part^2 bilinear samples at offset positions;
    returns (pooled, sample_count) as the reference's (top_data,
    top_count)."""
    p = int(pooled_size)
    g = int(group_size) or p
    od = int(output_dim)
    spp = int(sample_per_part)
    ps = int(part_size) or p
    b, c, h, w = data.shape
    R = rois.shape[0]
    if data.is_meta:
        return (torch.empty(R, od, p, p, dtype=data.dtype, device="meta"),
                torch.empty(R, od, p, p, dtype=data.dtype, device="meta"))
    f32, dev = torch.float32, data.device
    use_trans = not (no_trans or trans is None)
    n_classes = trans.shape[1] // 2 if use_trans else 1
    cpc = od // n_classes                     # channels of each class
    part = torch.from_numpy((np.arange(p) * ps) // p).to(dev)
    class_id = torch.from_numpy(np.arange(od) // cpc).to(dev)
    cmap = torch.from_numpy(_psroi_channels(od, p, g)).to(dev)  # (od, p, p)

    with torch.no_grad():
        r = rois.detach().to(f32)
        bi = r[:, 0].long()
        x1 = (torch.round(r[:, 1]) * spatial_scale - 0.5)[:, None, None, None]
        y1 = (torch.round(r[:, 2]) * spatial_scale - 0.5)[:, None, None, None]
        x2 = (torch.round(r[:, 3]) + 1.0) * spatial_scale - 0.5
        y2 = (torch.round(r[:, 4]) + 1.0) * spatial_scale - 0.5
        rw = (x2[:, None, None, None] - x1).clamp(min=0.1)
        rh = (y2[:, None, None, None] - y1).clamp(min=0.1)
        bs_h, bs_w = rh / p, rw / p
        sub_h, sub_w = bs_h / spp, bs_w / spp
    if use_trans:
        tr = trans.to(f32)                    # (R, 2*classes, ps, ps)
        tr_x = tr[:, class_id * 2][:, :, part][:, :, :, part]
        tr_y = tr[:, class_id * 2 + 1][:, :, part][:, :, :, part]
        tx, ty = tr_x * trans_std, tr_y * trans_std          # (R, od, p, p)
    else:
        tx = ty = torch.zeros((R, od, p, p), dtype=f32, device=dev)
    i = torch.arange(p, dtype=f32, device=dev)
    wstart = i[None, None, None, :] * bs_w + x1 + tx * rw    # (R, od, p, p)
    hstart = i[None, None, :, None] * bs_h + y1 + ty * rh
    s = torch.arange(spp, dtype=f32, device=dev)
    sub_h, sub_w = sub_h[..., None, None], sub_w[..., None, None]
    yy = (hstart[..., None, None] + s[:, None] * sub_h) \
        .expand(R, od, p, p, spp, spp)
    xx = (wstart[..., None, None] + s[None, :] * sub_w) \
        .expand(R, od, p, p, spp, spp)
    valid = ((yy > -0.5) & (yy < h - 0.5)
             & (xx > -0.5) & (xx < w - 0.5)).to(f32)

    yc = _clip(yy, 0.0, h - 1.0)
    xc = _clip(xx, 0.0, w - 1.0)
    y0, x0 = torch.floor(yc), torch.floor(xc)
    wy, wx = yc - y0, xc - x0
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp(max=h - 1)
    x1i = (x0i + 1).clamp(max=w - 1)
    flat = data.to(f32).reshape(-1)
    base = (bi[:, None, None, None] * (c * h * w)
            + cmap[None] * (h * w))[..., None, None]          # (R,od,p,p,1,1)

    def gat(yi, xi):
        return flat[base + yi * w + xi]

    val = ((1 - wy) * (1 - wx) * gat(y0i, x0i)
           + (1 - wy) * wx * gat(y0i, x1i)
           + wy * (1 - wx) * gat(y1i, x0i)
           + wy * wx * gat(y1i, x1i))
    cnt = valid.sum(dim=(-2, -1))
    tot = (val * valid).sum(dim=(-2, -1))
    pooled = torch.where(cnt > 0, tot / cnt.clamp(min=1.0),
                         torch.zeros((), dtype=f32, device=dev))
    return pooled.to(data.dtype), cnt.to(data.dtype)
