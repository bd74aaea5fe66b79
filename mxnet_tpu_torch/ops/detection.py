"""Object-detection ops: the MultiBox family, ROIPooling and the greedy
non-maximum suppression they and the region proposals share.

PyTorch counterpart of ``mxnet_tpu/ops/detection.py`` (reference:
src/operator/contrib/multibox_prior.cc, multibox_target.cc,
multibox_detection.cc; src/operator/roi_pooling.cc).  The JAX package
``vmap``s one image's function over the batch and runs the greedy loops
(bipartite matching, NMS) as ``lax.fori_loop``s; here the whole batch
goes through one set of tensor ops:

* bipartite matching takes at most ``G`` (the padded label count)
  rounds, each a batched argmax over the (N, A, G) IoU matrix;
* hard-negative mining is one stable sort per batch;
* NMS (:func:`nms_keep`) is exact and has no per-box loop: the greedy
  answer is the one fixed point of a recursion that a few batched
  rounds over the list of suppressing pairs reach (see there).  The
  pairs come from :func:`suppress_matrix`, which on the card is a
  hand-written kernel (``csrc/nms_overlap.cu``) and elsewhere its plain
  version.

The choices (which anchor matches, which negatives are mined, which box
survives) carry no gradient in the JAX package either (argmax, argsort
and comparisons), so they are made under ``torch.no_grad``; the values
that flow on (the encoded targets, the decoded boxes and scores) keep
autograd's graph when an input asks for it, so gradients equal
``jax.vjp``'s.  On the SSD path no input of these ops needs one, so
they build no graph.

Python scalars meet an array as the JAX package's weakly typed scalars
do: rounded to the array's type first (:func:`_w`), so a bf16 graph
rounds as the JAX package's does.
"""
from __future__ import annotations

import torch

from .registry import register


def _parse_floats(v, default):
    if v is None or v == ():
        return tuple(default)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def jnp_clip(x, lo, hi):
    """``jnp.clip``: min(max(x, lo), hi), which shares the gradient of a
    value at an end as ``jnp.clip`` does (``torch.clamp`` would pass all
    of it)."""
    lo = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo), hi)


def _w(v, like):
    """The Python scalar ``v`` as JAX's weak typing sees it beside the
    tensor ``like``: rounded to ``like``'s floating type."""
    if not like.is_floating_point():
        return v
    return float(torch.tensor(float(v), dtype=like.dtype))


# --------------------------------------------------------------------------
# MultiBoxPrior (multibox_prior.cc MultiBoxPriorForward)
# --------------------------------------------------------------------------
_PRIOR_CACHE = {}


@register("_contrib_MultiBoxPrior", arg_names=["data"], differentiable=False,
          attr_defaults={"sizes": (1.0,), "ratios": (1.0,), "clip": False,
                         "steps": (-1.0, -1.0), "offsets": (0.5, 0.5)},
          aliases=("MultiBoxPrior",))
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5), **kw):
    """data: (N, C, H, W) -> anchors (1, H*W*(S+R-1), 4), normalised
    [xmin, ymin, xmax, ymax], in the reference's order: all sizes at
    ratios[0], then sizes[0] at ratios[1:].  The anchors depend only on
    H, W and the attributes, so they are made once per (H, W,
    attributes, device) and kept; nothing writes into them."""
    key = (data.shape[2], data.shape[3], _parse_floats(sizes, (1.0,)),
           _parse_floats(ratios, (1.0,)), bool(clip),
           _parse_floats(steps, (-1.0, -1.0)),
           _parse_floats(offsets, (0.5, 0.5)), data.device)
    if data.is_meta:
        return _prior_anchors(*key)
    if key not in _PRIOR_CACHE:
        _PRIOR_CACHE[key] = _prior_anchors(*key)
    return _PRIOR_CACHE[key]


def _prior_anchors(H, W, sizes, ratios, clip, steps, offsets, device):
    step_y = steps[0] if steps[0] > 0 else 1.0 / H
    step_x = steps[1] if steps[1] > 0 else 1.0 / W
    f32 = torch.float32
    cy = (torch.arange(H, dtype=f32, device=device) + offsets[0]) * step_y
    cx = (torch.arange(W, dtype=f32, device=device) + offsets[1]) * step_x
    ws = [s * H / W / 2.0 for s in sizes]
    hs = [s / 2.0 for s in sizes]
    for r in ratios[1:]:
        sq = float(r) ** 0.5
        ws.append(sizes[0] * H / W * sq / 2.0)
        hs.append(sizes[0] / sq / 2.0)
    ws = torch.tensor(ws, dtype=f32, device=device)
    hs = torch.tensor(hs, dtype=f32, device=device)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")      # (H, W)
    cxg, cyg = cxg[:, :, None], cyg[:, :, None]
    boxes = torch.stack([cxg - ws, cyg - hs, cxg + ws, cyg + hs], dim=-1)
    boxes = boxes.reshape(1, -1, 4)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def iou_matrix(a, b):
    """IoU of every box of ``a`` (..., R, 4) with every box of ``b``
    (..., C, 4) -> (..., R, C), corners with no +1, 0 where the union is
    not positive (multibox_detection.cc CalculateOverlap; the JAX
    package's ``_iou_matrix`` order of operations)."""
    ax0, ay0, ax1, ay1 = (a[..., :, i:i + 1] for i in range(4))
    bx0, by0, bx1, by1 = (b[..., None, :, i] for i in range(4))
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    iw = torch.maximum(zero, torch.minimum(ax1, bx1)
                       - torch.maximum(ax0, bx0))
    ih = torch.maximum(zero, torch.minimum(ay1, by1)
                       - torch.maximum(ay0, by0))
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return torch.where(union > 0, inter / union, zero)


def pixel_iou(a, b):
    """The proposals' overlap (utils::NonMaximumSuppression): pixel
    corners with +1 in width and height, (..., R, 4) x (..., C, 4) ->
    (..., R, C)."""
    area_a = (a[..., 2] - a[..., 0] + 1.0) * (a[..., 3] - a[..., 1] + 1.0)
    area_b = (b[..., 2] - b[..., 0] + 1.0) * (b[..., 3] - b[..., 1] + 1.0)
    xx1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    yy1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    xx2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    yy2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (xx2 - xx1 + 1.0).clamp(min=0.0) \
        * (yy2 - yy1 + 1.0).clamp(min=0.0)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def _encode_loc(anchors, gt, variances):
    """SSD offset encoding (multibox_target.cc AssignLocTargets):
    anchors and gt (..., 4) corners -> (..., 4) targets."""
    v0, v1, v2, v3 = (_w(v, gt) for v in variances)
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    ax = (anchors[..., 0] + anchors[..., 2]) / 2
    ay = (anchors[..., 1] + anchors[..., 3]) / 2
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) / 2
    gy = (gt[..., 1] + gt[..., 3]) / 2
    tiny = torch.full((), 1e-8, dtype=aw.dtype, device=aw.device)
    aw = torch.maximum(aw, tiny)
    ah = torch.maximum(ah, tiny)
    return torch.stack([
        (gx - ax) / aw / v0,
        (gy - ay) / ah / v1,
        torch.log(torch.maximum(gw / aw, tiny)) / v2,
        torch.log(torch.maximum(gh / ah, tiny)) / v3], dim=-1)


# --------------------------------------------------------------------------
# MultiBoxTarget (multibox_target.cc)
# --------------------------------------------------------------------------
@register("_contrib_MultiBoxTarget",
          arg_names=["anchor", "label", "cls_pred"], num_outputs=3,
          attr_defaults={"overlap_threshold": 0.5, "ignore_label": -1.0,
                         "negative_mining_ratio": -1.0,
                         "negative_mining_thresh": 0.5,
                         "minimum_negative_samples": 0,
                         "variances": (0.1, 0.1, 0.2, 0.2)},
          aliases=("MultiBoxTarget",))
def _multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                     ignore_label=-1.0, negative_mining_ratio=-1.0,
                     negative_mining_thresh=0.5,
                     minimum_negative_samples=0,
                     variances=(0.1, 0.1, 0.2, 0.2), **kw):
    """anchor (1, A, 4); label (N, G, 5) [cls, xmin, ymin, xmax, ymax],
    padded with -1 rows; cls_pred (N, C, A).  Returns loc_target (N, 4A),
    loc_mask (N, 4A, float32) and cls_target (N, A): the class + 1 of a
    positive anchor, 0 of a negative, ``ignore_label`` of the rest."""
    variances = _parse_floats(variances, (0.1, 0.1, 0.2, 0.2))
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N, G = label.shape[0], label.shape[1]
    loc_dtype = torch.promote_types(anchors.dtype, label.dtype)
    if label.is_meta:
        return (torch.empty(N, 4 * A, dtype=loc_dtype, device="meta"),
                torch.empty(N, 4 * A, dtype=torch.float32, device="meta"),
                torch.empty(N, A, dtype=label.dtype, device="meta"))
    with torch.no_grad():
        match_gt, a_pos, a_neg = _match(
            anchors.detach(), label.detach(), cls_pred.detach(),
            float(overlap_threshold), float(negative_mining_ratio),
            float(negative_mining_thresh), int(minimum_negative_samples))
    safe_gt = match_gt.clamp(0, G - 1)
    gt_rows = torch.gather(label, 1,
                           safe_gt[:, :, None].expand(N, A, label.shape[2]))
    loc_t = _encode_loc(anchors, gt_rows[..., 1:5], variances)
    zero = torch.zeros((), dtype=loc_t.dtype, device=loc_t.device)
    loc_t = torch.where(a_pos[..., None], loc_t, zero)
    loc_m = a_pos[..., None].expand(N, A, 4).to(torch.float32)
    cls_t = torch.where(
        a_pos, gt_rows[..., 0] + 1.0,
        torch.where(a_neg, 0.0, float(ignore_label)).to(label.dtype))
    return loc_t.reshape(N, -1), loc_m.reshape(N, -1), cls_t


def _match(anchors, label, cls_pred, overlap_threshold, mining_ratio,
           mining_thresh, min_negatives):
    """The choices of MultiBoxTarget for the whole batch: (match_gt (N,
    A) int64, -1 where none; positive (N, A); negative (N, A))."""
    N, G = label.shape[0], label.shape[1]
    A = anchors.shape[0]
    dev = label.device
    rows = torch.arange(N, device=dev)
    gt_valid = label[:, :, 0] >= 0                           # (N, G)
    ious = iou_matrix(anchors.expand(N, A, 4), label[:, :, 1:5])
    ious = torch.where(gt_valid[:, None, :], ious,
                       torch.full((), -1.0, dtype=ious.dtype, device=dev))

    # phase 1: greedy bipartite (multibox_target.cc:111-147), up to G
    # rounds, each claiming the best (anchor, gt) pair left; the first
    # maximum of the flattened (A, G) matrix breaks ties, as jnp.argmax
    # does.  A round that claims nothing in any image changes nothing,
    # so neither would the rounds after it: the loop stops there (the JAX
    # package runs all G; padded labels leave most of them empty)
    match_gt = torch.full((N, A), -1, dtype=torch.int64, device=dev)
    match_iou = torch.full((N, A), -1.0, dtype=torch.float32, device=dev)
    a_used = torch.zeros((N, A), dtype=torch.bool, device=dev)
    g_used = torch.zeros((N, G), dtype=torch.bool, device=dev)
    neg1 = torch.full((), -1.0, dtype=ious.dtype, device=dev)
    eps = _w(1e-6, ious)
    for _ in range(G):
        masked = torch.where(a_used[:, :, None] | g_used[:, None, :],
                             neg1, ious)
        flat = masked.reshape(N, -1).argmax(dim=1)
        aj, gk = flat // G, flat % G
        best = masked.reshape(N, -1)[rows, flat]
        ok = best > eps
        match_gt[rows, aj] = torch.where(ok, gk, match_gt[rows, aj])
        match_iou[rows, aj] = torch.where(ok, best.float(),
                                          match_iou[rows, aj])
        a_used[rows, aj] |= ok
        g_used[rows, gk] |= ok
        if not bool(ok.any()):
            break
    a_pos = a_used

    # phase 2: per-anchor threshold matching (:149-178)
    best_iou, best_gt = ious.amax(dim=2), ious.argmax(dim=2)
    thresh_pos = (~a_pos) & (best_iou > _w(overlap_threshold, best_iou)) \
        & (overlap_threshold > 0)
    match_gt = torch.where(a_pos, match_gt,
                           torch.where(best_iou > -1.0, best_gt, -1))
    match_iou = torch.where(a_pos, match_iou, best_iou.float())
    a_pos = a_pos | thresh_pos

    if mining_ratio <= 0:
        return match_gt, a_pos, ~a_pos
    # negatives: the hardest by background probability (:180-247)
    num_pos = a_pos.sum(dim=1)
    m = cls_pred.max(dim=1).values                          # (N, A)
    num = torch.exp(cls_pred[:, 0] - m)
    # jnp.sum upcasts a bf16 sum to float32 and rounds the total
    den = torch.exp(cls_pred - m[:, None]).float().sum(dim=1) \
        .to(cls_pred.dtype)
    p_bg = num / den
    eligible = (~a_pos) & (match_iou < mining_thresh)
    key = torch.where(eligible, p_bg,
                      torch.full((), float("inf"), dtype=p_bg.dtype,
                                 device=dev))
    order = torch.sort(key, dim=1, stable=True).indices
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(A, device=dev).expand(N, A).contiguous())
    num_neg = torch.minimum((num_pos.float() * mining_ratio).long(),
                            eligible.sum(dim=1))
    num_neg = num_neg.clamp(min=min_negatives)
    a_neg = eligible & (rank < num_neg[:, None])
    return match_gt, a_pos, a_neg


# --------------------------------------------------------------------------
# greedy non-maximum suppression, batched and loop-free per box
# --------------------------------------------------------------------------
# the two overlap rules the NMS kernel knows, by its rule number
_OVERLAP_RULES = {iou_matrix: 0, pixel_iou: 1}
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def suppress_matrix(boxes, valid, classes, ks, ke, thresh, overlap):
    """S (n, ks, ke) bool: S[n, j, i] when box j suppresses box i in
    greedy NMS, i.e. j < i, valid[n, j], the classes agree (``classes``
    None: every class) and ``overlap(j, i) > thresh``, for the first
    ``ks`` rows and ``ke`` columns of ``boxes`` (n, K, 4).

    A CUDA tensor launches the Hopper kernel (``csrc/nms_overlap.cu``,
    :func:`suppress_matrix_cuda`); a CPU or meta tensor takes the plain
    version (:func:`suppress_matrix_plain`), whose order of operations
    the kernel keeps."""
    if boxes.is_cuda:
        return suppress_matrix_cuda(boxes, valid, classes, ks, ke, thresh,
                                    overlap)
    return suppress_matrix_plain(boxes, valid, classes, ks, ke, thresh,
                                 overlap)


def suppress_matrix_plain(boxes, valid, classes, ks, ke, thresh, overlap):
    """:func:`suppress_matrix` in PyTorch's elementwise ops (on any
    device: the card checks its kernel against this)."""
    b = boxes[:, :ke]
    S = overlap(b[:, :ks], b) > thresh
    idx = torch.arange(ke, device=boxes.device)
    S &= idx[:ks, None] < idx[None, :]
    if classes is not None:
        c = classes[:, :ke]
        S &= c[:, :ks, None] == c[:, None, :]
    S &= valid[:, :ks, None]
    return S


def suppress_matrix_cuda(boxes, valid, classes, ks, ke, thresh, overlap):
    """Launch ``csrc/nms_overlap.cu`` for :func:`suppress_matrix` on CUDA
    tensors: boxes float32 or bfloat16 (n, K, 4), valid bool (n, K),
    classes (n, K) (compared as float32) or None, ``overlap`` one of
    :func:`iou_matrix` and :func:`pixel_iou`.  Raises on anything else.
    ``suppress_matrix_cuda.launches`` counts successful launches."""
    import ctypes
    from ..base import MXNetError
    from .. import cuda_lib
    if overlap not in _OVERLAP_RULES:
        raise MXNetError("suppress_matrix_cuda: the kernel knows "
                         "iou_matrix and pixel_iou only")
    if boxes.dtype not in _KERNEL_DTYPES:
        raise MXNetError(f"suppress_matrix_cuda: boxes dtype {boxes.dtype} "
                         "not supported (float32 or bfloat16)")
    n, K = valid.shape
    boxes = boxes.contiguous()
    valid = valid.to(torch.bool).contiguous()
    if classes is not None:
        classes = classes.to(torch.float32).contiguous()
    for name, t in (("valid", valid), ("classes", classes)):
        if t is not None and t.device != boxes.device:
            raise MXNetError(f"suppress_matrix_cuda: {name} is on "
                             f"{t.device}, boxes on {boxes.device}")
    if tuple(boxes.shape) != (n, K, 4) or (
            classes is not None and tuple(classes.shape) != (n, K)):
        raise MXNetError("suppress_matrix_cuda: shapes differ: boxes "
                         f"{tuple(boxes.shape)}, valid {(n, K)}")
    lib = cuda_lib.library("nms_overlap.cu")
    fn = lib.mxtt_nms_suppress
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtt_error_string.argtypes = [ctypes.c_int]
        lib.mxtt_error_string.restype = ctypes.c_char_p
    S = torch.empty((n, ks, ke), dtype=torch.bool, device=boxes.device)
    err = fn(boxes.data_ptr(), valid.data_ptr(),
             classes.data_ptr() if classes is not None else None,
             S.data_ptr(), n, K, ks, ke, _KERNEL_DTYPES[boxes.dtype],
             _OVERLAP_RULES[overlap], float(thresh),
             boxes.device.index or 0,
             torch.cuda.current_stream(boxes.device).cuda_stream)
    if err != 0:
        raise MXNetError("suppress_matrix_cuda: launch failed: "
                         f"{lib.mxtt_error_string(err).decode()} ({err})")
    suppress_matrix_cuda.launches += 1
    return S


suppress_matrix_cuda.launches = 0

# elements of one chunk's (images, K, K) suppression matrix: the matrix
# and the plain version's temporaries stay near a few GiB a chunk
NMS_CHUNK_ELEMENTS = 1 << 28


def nms_keep(boxes, valid, thresh, overlap, classes=None, topk=None,
             stats=None):
    """Greedy NMS over boxes already sorted by score, for a batch.

    ``boxes`` (N, K, 4), ``valid`` (N, K) bool, ``overlap(a, b)`` the
    caller's IoU rule (:func:`iou_matrix` or :func:`pixel_iou`),
    ``classes`` (N, K) or None (every box suppresses every class),
    ``topk``: only boxes j < topk suppress (None: all).  Returns keep
    (N, K) bool: the result of visiting j = 0, 1, ... in turn and, if j
    is still kept, dropping every later box i with overlap(j, i) >
    ``thresh`` (of j's class).

    With S[j, i] = overlap > thresh, same class, j < i, j < topk (see
    :func:`suppress_matrix`), the greedy answer is the only solution of
    keep_i = valid_i and not any_j (keep_j and S[j, i]) (by induction
    over i: keep_i depends only on earlier boxes).  Iterating that map
    from keep = valid reaches it after at most the longest chain of
    suppressions plus one rounds, and no box is visited alone.  S is
    built for as many images at once as ``NMS_CHUNK_ELEMENTS`` allows
    and kept as the list of its true pairs, so a round is a gather and a
    scatter-add over those pairs.  Boxes after the last valid one of
    every image are left out (only the trailing invalid columns are cut:
    the valid boxes need not come first).  A ``stats`` dict receives the
    rounds and the pairs."""
    N, K = valid.shape
    keep = valid.clone()
    if N == 0 or K == 0:
        return keep
    live = valid.any(dim=0).nonzero()
    K_eff = int(live[-1]) + 1 if live.numel() else 0
    if K_eff == 0:
        return keep
    K_sup = K_eff if topk is None else min(int(topk), K_eff)
    per = max(1, NMS_CHUNK_ELEMENTS // (K_sup * K_eff))
    src, dst = [], []
    for s in range(0, N, per):
        S = suppress_matrix(
            boxes[s:s + per], valid[s:s + per],
            None if classes is None else classes[s:s + per],
            K_sup, K_eff, thresh, overlap)
        nz = S.nonzero()                                    # (img, j, i)
        src.append((nz[:, 0] + s) * K_eff + nz[:, 1])
        dst.append((nz[:, 0] + s) * K_eff + nz[:, 2])
    src, dst = torch.cat(src), torch.cat(dst)
    v = valid[:, :K_eff].reshape(-1)
    k = v.clone()
    rounds = 0
    while True:
        rounds += 1
        hits = torch.zeros(v.shape, dtype=torch.int32, device=v.device)
        hits.index_add_(0, dst, k[src].to(torch.int32))
        new = v & (hits == 0)
        if torch.equal(new, k):
            break
        k = new
    keep[:, :K_eff] = k.reshape(N, K_eff)
    if stats is not None:
        stats["rounds"] = max(stats.get("rounds", 0), rounds)
        stats["pairs"] = int(src.numel())
    return keep


# --------------------------------------------------------------------------
# MultiBoxDetection (multibox_detection.cc)
# --------------------------------------------------------------------------
@register("_contrib_MultiBoxDetection",
          arg_names=["cls_prob", "loc_pred", "anchor"],
          attr_defaults={"clip": True, "threshold": 0.01,
                         "background_id": 0, "nms_threshold": 0.5,
                         "force_suppress": False,
                         "variances": (0.1, 0.1, 0.2, 0.2),
                         "nms_topk": -1},
          aliases=("MultiBoxDetection",))
def _multibox_detection(cls_prob, loc_pred, anchor, clip=True,
                        threshold=0.01, background_id=0,
                        nms_threshold=0.5, force_suppress=False,
                        variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1,
                        **kw):
    """cls_prob (N, C, A); loc_pred (N, 4A); anchor (1, A, 4) -> (N, A, 6)
    rows [class_id, score, xmin, ymin, xmax, ymax] sorted by score, with
    id -1 for a box below ``threshold`` or suppressed."""
    variances = _parse_floats(variances, (0.1, 0.1, 0.2, 0.2))
    anchors = anchor.reshape(-1, 4)
    A = anchors.shape[0]
    N = cls_prob.shape[0]
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    box_dtype = torch.promote_types(loc_pred.dtype, anchors.dtype)
    out_dtype = torch.promote_types(
        torch.promote_types(torch.float32, cls_prob.dtype), box_dtype)
    if cls_prob.is_meta:
        return torch.empty(N, A, 6, dtype=out_dtype, device="meta")
    # amax shares the gradient of a tie as jnp.max does; argmax takes the
    # first maximum as jnp.argmax does
    score = fg.amax(dim=1)                              # (N, A)
    with torch.no_grad():
        cid = torch.where(score >= _w(threshold, score),
                          fg.argmax(dim=1).float(), -1.0)

    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    ax = (anchors[:, 0] + anchors[:, 2]) / 2
    ay = (anchors[:, 1] + anchors[:, 3]) / 2
    lp = loc_pred.reshape(N, A, 4)
    v0, v1, v2, v3 = (_w(v, lp) for v in variances)
    ox = lp[..., 0] * v0 * aw + ax
    oy = lp[..., 1] * v1 * ah + ay
    ow = torch.exp(lp[..., 2] * v2) * aw / 2
    oh = torch.exp(lp[..., 3] * v3) * ah / 2
    boxes = torch.stack([ox - ow, oy - oh, ox + ow, oy + oh], dim=-1)
    if clip:
        boxes = jnp_clip(boxes, 0.0, 1.0)

    with torch.no_grad():
        key = torch.where(cid >= 0, score.detach(),
                          torch.full((), float("-inf"), dtype=score.dtype,
                                     device=score.device))
        # descending by score, ties (and the invalid rows) in index order:
        # jnp.argsort(-key) is stable
        order = torch.sort(-key, dim=1, stable=True).indices
        cid_s = torch.gather(cid, 1, order)
        k = A if int(nms_topk) < 0 else min(int(nms_topk), A)
        boxes_d = torch.gather(boxes.detach(), 1,
                               order[..., None].expand(N, A, 4))
        keep = nms_keep(boxes_d, cid_s >= 0,
                        _w(nms_threshold, boxes_d), iou_matrix,
                        classes=None if force_suppress else cid_s, topk=k)
        cid_s = torch.where(keep, cid_s, -1.0)
    score_s = torch.gather(score, 1, order)
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(N, A, 4))
    return torch.cat([cid_s[..., None].to(out_dtype),
                      score_s[..., None].to(out_dtype),
                      boxes_s.to(out_dtype)], dim=-1)


# --------------------------------------------------------------------------
# ROIPooling (src/operator/roi_pooling.cc)
# --------------------------------------------------------------------------
# elements of one chunk's (rois, C, PH, PW, H, W) masked window tensor
ROI_CHUNK_ELEMENTS = 1 << 26


@register("ROIPooling", arg_names=["data", "rois"],
          attr_defaults={"pooled_size": (7, 7), "spatial_scale": 1.0})
def _roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0, **kw):
    """data (N, C, H, W); rois (R, 5) [batch_idx, x1, y1, x2, y2] in image
    coordinates -> (R, C, PH, PW), the max of each bin (0 for an empty
    one).  The max runs over the whole masked window at once, so a tie
    shares its gradient as the JAX package's ``max`` does; ROIs go in
    chunks of ``ROI_CHUNK_ELEMENTS``."""
    PH, PW = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (int(pooled_size), int(pooled_size)))
    PH, PW = int(PH), int(PW)
    N, C, H, W = data.shape
    R = rois.shape[0]
    if data.is_meta:
        return torch.empty(R, C, PH, PW, dtype=data.dtype, device="meta")
    dev = data.device
    f32 = torch.float32
    with torch.no_grad():
        r = rois.detach().to(f32)
        b = r[:, 0].long()
        x1, y1, x2, y2 = (torch.round(r[:, i] * spatial_scale)
                          for i in range(1, 5))
        rw = (x2 - x1 + 1.0).clamp(min=1.0)
        rh = (y2 - y1 + 1.0).clamp(min=1.0)
        bin_h, bin_w = rh / PH, rw / PW
        ph = torch.arange(PH, dtype=f32, device=dev)
        pw = torch.arange(PW, dtype=f32, device=dev)
        hstart = torch.floor(ph * bin_h[:, None]) + y1[:, None]  # (R, PH)
        hend = torch.ceil((ph + 1) * bin_h[:, None]) + y1[:, None]
        wstart = torch.floor(pw * bin_w[:, None]) + x1[:, None]  # (R, PW)
        wend = torch.ceil((pw + 1) * bin_w[:, None]) + x1[:, None]
        yg = torch.arange(H, dtype=f32, device=dev)
        xg = torch.arange(W, dtype=f32, device=dev)
        ymask = (yg >= hstart[..., None]) & (yg < hend[..., None])
        xmask = (xg >= wstart[..., None]) & (xg < wend[..., None])
    neg_inf = torch.full((), float("-inf"), dtype=data.dtype, device=dev)
    per = max(1, ROI_CHUNK_ELEMENTS // max(1, C * PH * PW * H * W))
    outs = []
    for s in range(0, R, per):
        m = ymask[s:s + per, :, None, :, None] \
            & xmask[s:s + per, None, :, None, :]        # (r, PH, PW, H, W)
        feat = data[b[s:s + per]]                       # (r, C, H, W)
        big = torch.where(m[:, None], feat[:, :, None, None], neg_inf)
        outs.append(big.amax(dim=(4, 5)))
    out = torch.cat(outs) if outs else \
        torch.empty(0, C, PH, PW, dtype=data.dtype, device=dev)
    return torch.where(torch.isfinite(out), out,
                       torch.zeros((), dtype=out.dtype, device=dev))
