"""The detection ops of the PyTorch port (MultiBoxPrior, MultiBoxTarget,
MultiBoxDetection, ROIPooling) and the MakeLoss head against the same
ops of the JAX package, on the same numpy inputs; the port's NMS helper
against a plain numpy greedy NMS.

Tolerances, each with its reason:

* Choices are exact: class targets, masks, which box survives NMS and
  every row's class id must be equal.  Both packages round each f32 (or
  bf16) operation the same way (the port rounds a Python constant to the
  array's type first, as JAX's weak typing does), so the IoUs that decide
  them are the same numbers.
* Values within 1e-6 (f32): the encoded targets and decoded boxes are a
  few f32 operations in the same order; exp and log may differ by an ulp
  between XLA's CPU code and PyTorch's.
* Gradients within 1e-5 (f32): ``jax.vjp`` and autograd sum the same
  terms in their own order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu.ops  # noqa: F401  registers the JAX ops
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import detection as tdet

VAL = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-5)


def _run(name, arrays, attrs):
    """(JAX outputs, port outputs) as lists of numpy arrays.  The JAX op
    runs under one ``jax.jit`` (one compile instead of one an operation;
    XLA rounds each operation as the eager run does)."""
    fn = jreg.get(name).fn
    j = jax.jit(lambda *a: fn(*a, **attrs))(*[jnp.asarray(a)
                                             for a in arrays])
    t = treg.get(name).fn(*[torch.from_numpy(np.array(a)) for a in arrays],
                          **attrs)
    j = list(j) if isinstance(j, (tuple, list)) else [j]
    t = list(t) if isinstance(t, (tuple, list)) else [t]
    assert len(j) == len(t)
    return ([np.asarray(x.astype(jnp.float32)) if x.dtype == jnp.bfloat16
             else np.asarray(x) for x in j],
            [x.detach().float().numpy() if x.dtype == torch.bfloat16
             else x.detach().numpy() for x in t])


def _boxes(rng, n, lo=0.0, hi=1.0, min_side=0.05, max_side=0.5):
    """n random corner boxes inside [lo, hi]."""
    w = rng.uniform(min_side, max_side, n)
    h = rng.uniform(min_side, max_side, n)
    x0 = rng.uniform(lo, hi - w)
    y0 = rng.uniform(lo, hi - h)
    return np.stack([x0, y0, x0 + w, y0 + h], 1).astype(np.float32)


# --------------------------------------------------------------------------
# registration: the same names, aliases, inputs and attributes
# --------------------------------------------------------------------------
FAMILY = ["_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
          "_contrib_MultiBoxDetection", "ROIPooling", "MakeLoss",
          "_contrib_fft", "_contrib_ifft", "_contrib_count_sketch",
          "_contrib_quantize", "_contrib_dequantize", "_contrib_Proposal",
          "_contrib_MultiProposal", "_contrib_PSROIPooling",
          "_contrib_DeformableConvolution",
          "_contrib_DeformablePSROIPooling", "GridGenerator",
          "BilinearSampler", "SpatialTransformer", "Correlation"]


@pytest.mark.parametrize("name", FAMILY)
def test_registered_as_in_the_jax_package(name):
    j, t = jreg.get(name), treg.get(name)
    assert t.name == j.name
    j_names = sorted(n for n in jreg.list_ops() if jreg.get(n) is j)
    assert sorted(n for n in treg.list_ops() if treg.get(n) is t) == j_names
    assert t.arg_names == j.arg_names
    assert t.num_outputs == j.num_outputs
    # MultiBoxPrior's anchors depend on the input's shape alone: the port
    # marks it non-differentiable (its output never asks for a gradient,
    # and jax.vjp gives zero, test_multibox_prior_has_no_gradient_...)
    assert t.differentiable == (j.differentiable
                                and name != "_contrib_MultiBoxPrior")
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in t.attr_defaults.items()} == \
        {k: tuple(v) if isinstance(v, list) else v
         for k, v in j.attr_defaults.items()}
    if callable(j.num_visible):
        for attrs in ({}, {"output_score": True}):
            assert t.num_visible(attrs) == j.num_visible(attrs)
    else:
        assert t.num_visible == j.num_visible
    # the contrib namespaces reach the _contrib_ ops by their short names
    if name.startswith("_contrib_"):
        short = name[len("_contrib_"):]
        assert callable(getattr(mt.nd.contrib, short))
        assert callable(getattr(mt.sym.contrib, short))


# --------------------------------------------------------------------------
# MultiBoxPrior
# --------------------------------------------------------------------------
PRIOR_CASES = {
    "test_layout": ((1, 3, 4, 6), dict(sizes=(0.5, 0.25), ratios=(1, 2))),
    "clip": ((1, 3, 4, 6), dict(sizes=(0.9,), clip=True)),
    "ssd_scale": ((2, 8, 5, 5), dict(sizes=(0.54, 0.619),
                                     ratios=(1, 2, 0.5, 3, 1 / 3),
                                     clip=True)),
    "steps_offsets": ((1, 2, 3, 7), dict(sizes=(0.3,), ratios=(1, 0.5),
                                         steps=(0.2, 0.1),
                                         offsets=(0.25, 0.75))),
}


@pytest.mark.parametrize("case", sorted(PRIOR_CASES))
def test_multibox_prior_vs_jax(case):
    shape, attrs = PRIOR_CASES[case]
    x = np.zeros(shape, np.float32)
    (j,), (t,) = _run("_contrib_MultiBoxPrior", [x], attrs)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_allclose(t, j, **VAL)


def test_multibox_prior_cache_equals_a_fresh_computation():
    fn = treg.get("_contrib_MultiBoxPrior").fn
    x = torch.zeros(1, 3, 5, 7)
    attrs = dict(sizes=(0.2, 0.3), ratios=(1, 2, 0.5), clip=True)
    a1, a2 = fn(x, **attrs), fn(x, **attrs)
    assert a1 is a2
    fresh = tdet._prior_anchors(5, 7, (0.2, 0.3), (1.0, 2.0, 0.5), True,
                                (-1.0, -1.0), (0.5, 0.5), x.device)
    assert torch.equal(a1, fresh)
    # another attribute is another entry
    assert not torch.equal(fn(x, sizes=(0.2, 0.3)), a1)


def test_multibox_prior_has_no_gradient_in_either_package():
    x = np.random.RandomState(0).randn(1, 2, 3, 3).astype(np.float32)
    fn = jreg.get("_contrib_MultiBoxPrior").fn
    out, vjp = jax.vjp(lambda d: fn(d, sizes=(0.5,)), jnp.asarray(x))
    g, = vjp(jnp.ones_like(out))
    assert not np.asarray(g).any()
    t = torch.from_numpy(x).requires_grad_()
    assert not treg.get("_contrib_MultiBoxPrior").fn(
        t, sizes=(0.5,)).requires_grad


# --------------------------------------------------------------------------
# MultiBoxTarget
# --------------------------------------------------------------------------
def _target_inputs(seed, N=3, A=60, G=4, C=4, pad=True):
    rng = np.random.RandomState(seed)
    anchors = _boxes(rng, A)[None]
    label = np.full((N, G, 5), -1.0, np.float32)
    for n in range(N):
        k = G - n if pad else G                      # n padding rows
        label[n, :k, 0] = rng.randint(0, C - 1, k)
        label[n, :k, 1:] = _boxes(rng, k, min_side=0.1)
    cls_pred = rng.randn(N, C, A).astype(np.float32)
    return anchors, label, cls_pred


def _jax_test_matching_inputs():
    anchor = np.array([[[0., 0., 0.5, 0.5], [0.4, 0.4, 0.9, 0.9],
                        [0., 0.5, 0.5, 1.0]]], np.float32)
    label = np.array([[[1., 0.42, 0.42, 0.88, 0.88]]], np.float32)
    return anchor, label, np.zeros((1, 3, 3), np.float32)


def _jax_test_mining_inputs():
    anchor = np.random.RandomState(0).rand(1, 20, 4).astype(np.float32)
    label = np.full((1, 4, 5), -1.0, np.float32)
    label[0, 0] = [0, 0.2, 0.2, 0.7, 0.7]
    cls_pred = np.random.RandomState(1).randn(1, 3, 20).astype(np.float32)
    return anchor, label, cls_pred


TARGET_CASES = {
    "jax_matching": (_jax_test_matching_inputs, {}),
    "jax_padded_labels_and_mining": (
        _jax_test_mining_inputs,
        dict(negative_mining_ratio=3.0, negative_mining_thresh=0.5)),
    "random_no_mining": (lambda: _target_inputs(1), {}),
    "random_mining": (lambda: _target_inputs(2), dict(
        negative_mining_ratio=3.0, negative_mining_thresh=0.5)),
    "mining_min_negatives": (lambda: _target_inputs(3), dict(
        negative_mining_ratio=1.0, minimum_negative_samples=20,
        ignore_label=-2.0)),
    "threshold_0_3": (lambda: _target_inputs(4), dict(
        overlap_threshold=0.3, negative_mining_ratio=2.0,
        negative_mining_thresh=0.4, variances=(0.2, 0.2, 0.1, 0.1))),
    "all_padding": (lambda: _target_inputs(5, N=2, G=2, pad=True), dict(
        negative_mining_ratio=3.0)),
}


@pytest.mark.parametrize("case", sorted(TARGET_CASES))
def test_multibox_target_vs_jax(case):
    make, attrs = TARGET_CASES[case]
    anchor, label, cls_pred = make()
    (jl, jm, jc), (tl, tm, tc) = _run("_contrib_MultiBoxTarget",
                                      [anchor, label, cls_pred], attrs)
    for j, t in ((jl, tl), (jm, tm), (jc, tc)):
        assert j.shape == t.shape and j.dtype == t.dtype
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tl, jl, **VAL)


def test_multibox_target_bf16_equals_jax():
    """Under a bf16 compute dtype the executor hands MultiBoxTarget bf16
    anchors, labels and class scores (it is not in AMP_FP32_OPS in either
    package), so IoUs, the mining softmax and the encoding run in bf16.
    The port rounds as the JAX package does: equal targets, the
    encoding's values equal."""
    for seed in (6, 7, 8):
        anchor, label, cls_pred = _target_inputs(seed, N=4, A=300, G=6,
                                                 C=5)
        arrays = [jnp.asarray(a, jnp.bfloat16)
                  for a in (anchor, label, cls_pred)]
        arrays = [np.asarray(a) for a in arrays]   # ml_dtypes bfloat16
        attrs = dict(negative_mining_ratio=3.0)
        j = jreg.get("_contrib_MultiBoxTarget").fn(
            *[jnp.asarray(a) for a in arrays], **attrs)
        t = treg.get("_contrib_MultiBoxTarget").fn(
            *[torch.from_numpy(a.astype(np.float32)).bfloat16()
              for a in arrays], **attrs)
        assert [str(x.dtype) for x in j] == ["bfloat16", "float32",
                                            "bfloat16"]
        assert [x.dtype for x in t] == [torch.bfloat16, torch.float32,
                                        torch.bfloat16]
        for jx, tx in zip(j, t):
            np.testing.assert_array_equal(
                tx.float().numpy(), np.asarray(jx.astype(jnp.float32)))


def test_multibox_target_gradient_vs_jax_vjp():
    """jax.vjp through MultiBoxTarget is zero for cls_pred (it only ranks
    the negatives) and not zero for the anchors and the label corners (the
    encoding); the port's autograd gives the same."""
    anchor, label, cls_pred = _target_inputs(9)
    attrs = dict(negative_mining_ratio=3.0)
    fn = jreg.get("_contrib_MultiBoxTarget").fn
    outs, vjp = jax.vjp(jax.jit(lambda a, l, c: fn(a, l, c, **attrs)),
                        jnp.asarray(anchor), jnp.asarray(label),
                        jnp.asarray(cls_pred))
    rng = np.random.RandomState(10)
    cts = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    jg = vjp(tuple(jnp.asarray(c) for c in cts))
    ins = [torch.from_numpy(a).requires_grad_()
           for a in (anchor, label, cls_pred)]
    touts = treg.get("_contrib_MultiBoxTarget").fn(*ins, **attrs)
    heads = [(o, torch.from_numpy(c)) for o, c in zip(touts, cts)
             if o.requires_grad]
    tg = torch.autograd.grad([h for h, _ in heads], ins,
                             [c for _, c in heads], allow_unused=True)
    assert not np.asarray(jg[2]).any()
    assert np.abs(np.asarray(jg[0])).sum() > 0
    for j, t in zip(jg, tg):
        t = np.zeros(np.shape(j), np.float32) if t is None else t.numpy()
        np.testing.assert_allclose(t, np.asarray(j), **GRAD)


def test_multibox_target_builds_no_graph_on_the_ssd_path():
    """In the SSD graph only cls_pred needs a gradient; it feeds the
    mining alone, so no output of MultiBoxTarget carries a graph."""
    anchor, label, cls_pred = _target_inputs(11)
    outs = treg.get("_contrib_MultiBoxTarget").fn(
        torch.from_numpy(anchor), torch.from_numpy(label),
        torch.from_numpy(cls_pred).requires_grad_(),
        negative_mining_ratio=3.0)
    assert not any(o.requires_grad for o in outs)


# --------------------------------------------------------------------------
# MultiBoxDetection
# --------------------------------------------------------------------------
def _clustered(rng, n_clusters, per, spread=0.03):
    """Boxes in clusters, so that NMS has work to do."""
    centers = _boxes(rng, n_clusters, min_side=0.15, max_side=0.4)
    out = [c + rng.uniform(-spread, spread, (per, 4)) for c in centers]
    return np.clip(np.concatenate(out), 0, 1).astype(np.float32)


def _detect_inputs(seed, N=2, C=4, clusters=6, per=8):
    rng = np.random.RandomState(seed)
    A = clusters * per
    anchors = _clustered(rng, clusters, per)[None]
    logits = rng.randn(N, C, A).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(N, 4 * A) * 0.3).astype(np.float32)
    return prob.astype(np.float32), loc, anchors


def _jax_test_nms_inputs():
    anchor = np.array([[[0.1, 0.1, 0.4, 0.4], [0.12, 0.12, 0.42, 0.42],
                        [0.6, 0.6, 0.9, 0.9]]], np.float32)
    cls_prob = np.zeros((1, 2, 3), np.float32)
    cls_prob[0, 1] = [0.9, 0.8, 0.7]
    return cls_prob, np.zeros((1, 12), np.float32), anchor


def _jax_test_threshold_inputs():
    anchor = np.array([[[0.1, 0.1, 0.4, 0.4]]], np.float32)
    cls_prob = np.zeros((1, 2, 1), np.float32)
    cls_prob[0, 1, 0] = 0.005
    return cls_prob, np.zeros((1, 4), np.float32), anchor


def _tied_inputs():
    """Tied scores: the sort must keep index order among equal scores,
    and the invalid rows' order shows in the output."""
    prob, loc, anchors = _detect_inputs(12, N=2, C=3)
    prob[:, 1:] = np.round(prob[:, 1:] * 4) / 4
    return prob, loc, anchors


DETECT_CASES = {
    "jax_decode_and_nms": (_jax_test_nms_inputs, dict(nms_threshold=0.5)),
    "jax_threshold": (_jax_test_threshold_inputs, dict(threshold=0.01)),
    "default": (lambda: _detect_inputs(1), {}),
    "nms_topk": (lambda: _detect_inputs(2), dict(nms_topk=10)),
    "force_suppress": (lambda: _detect_inputs(3),
                       dict(force_suppress=True, nms_threshold=0.3)),
    "background_id_2": (lambda: _detect_inputs(4), dict(background_id=2)),
    "threshold_no_clip": (lambda: _detect_inputs(5),
                          dict(threshold=0.3, clip=False,
                               variances=(0.2, 0.2, 0.1, 0.1))),
    "tied_scores": (_tied_inputs, dict(nms_threshold=0.4)),
}


@pytest.mark.parametrize("case", sorted(DETECT_CASES))
def test_multibox_detection_vs_jax(case):
    make, attrs = DETECT_CASES[case]
    (j,), (t,) = _run("_contrib_MultiBoxDetection", list(make()), attrs)
    assert t.shape == j.shape and t.dtype == j.dtype
    np.testing.assert_array_equal(t[..., 0], j[..., 0])
    np.testing.assert_allclose(t, j, **VAL)
    if case == "default":   # NMS had something to suppress
        valid = (j[..., 1] >= 0.01)
        assert ((j[..., 0] < 0) & valid).sum() > 0


def test_multibox_detection_bf16_equals_jax():
    prob, loc, anchors = _detect_inputs(13, N=2, C=5, clusters=10, per=10)
    arrays = [np.asarray(jnp.asarray(a, jnp.bfloat16))
              for a in (prob, loc, anchors)]
    j = jreg.get("_contrib_MultiBoxDetection").fn(
        *[jnp.asarray(a) for a in arrays])
    t = treg.get("_contrib_MultiBoxDetection").fn(
        *[torch.from_numpy(a.astype(np.float32)).bfloat16() for a in arrays])
    assert t.dtype == torch.float32 and str(j.dtype) == "float32"
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_multibox_detection_gradient_vs_jax_vjp():
    """The scores and decoded boxes carry gradients in the JAX package
    (its jnp code is differentiable), the choices do not; the port's
    autograd gives the same numbers."""
    prob, loc, anchors = _detect_inputs(14)
    fn = jreg.get("_contrib_MultiBoxDetection").fn
    out, vjp = jax.vjp(jax.jit(lambda *a: fn(*a, nms_topk=20)),
                       *[jnp.asarray(a) for a in (prob, loc, anchors)])
    ct = np.random.RandomState(15).randn(*out.shape).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    ins = [torch.from_numpy(a).requires_grad_() for a in (prob, loc, anchors)]
    t = treg.get("_contrib_MultiBoxDetection").fn(*ins, nms_topk=20)
    tg = torch.autograd.grad(t, ins, torch.from_numpy(ct))
    for j, g in zip(jg, tg):
        assert np.abs(np.asarray(j)).sum() > 0
        np.testing.assert_allclose(g.numpy(), np.asarray(j), **GRAD)


# --------------------------------------------------------------------------
# the NMS helper against a numpy greedy NMS
# --------------------------------------------------------------------------
def _np_iou(a, b, plus_one):
    e = 1.0 if plus_one else 0.0
    area = lambda x: (x[2] - x[0] + e) * (x[3] - x[1] + e)  # noqa: E731
    iw = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + e)
    ih = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + e)
    inter = iw * ih
    union = area(a) + area(b) - inter
    if not plus_one and union <= 0:
        return 0.0
    return inter / union


def _np_greedy(boxes, valid, thresh, classes, topk, plus_one):
    """One image: visit j in order; a kept j < topk drops every later
    box of its class that overlaps it by more than thresh."""
    keep = valid.copy()
    for j in range(min(topk, len(boxes))):
        if not keep[j]:
            continue
        for i in range(j + 1, len(boxes)):
            same = classes is None or classes[i] == classes[j]
            if keep[i] and same and \
                    _np_iou(boxes[j], boxes[i], plus_one) > thresh:
                keep[i] = False
    return keep


def _chain(n, step=0.02):
    """n boxes, each overlapping the next by more than 0.5 IoU and the one
    after by less: greedy keeps every other one, the longest chain."""
    x0 = np.arange(n) * step
    return np.stack([x0, np.zeros(n), x0 + 0.07, np.ones(n) * 0.5],
                    1).astype(np.float32)


NMS_CASES = {
    "random": dict(seed=0, K=200, thresh=0.3),
    "random_classes_topk": dict(seed=1, K=150, thresh=0.2, classes=3,
                                topk=40),
    "invalid_holes": dict(seed=2, K=120, thresh=0.25, holes=True),
    "long_chain": dict(seed=3, chain=60, thresh=0.5),
    "pixel_boxes": dict(seed=4, K=100, thresh=0.5, pixel=True),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_helper_vs_numpy_greedy(case):
    c = NMS_CASES[case]
    rng = np.random.RandomState(c["seed"])
    N = 3
    if "chain" in c:
        K = c["chain"]
        boxes = np.stack([_chain(K) for _ in range(N)])
    elif c.get("pixel"):
        K = c["K"]
        boxes = np.stack([_clustered(rng, 10, K // 10, 0.05)
                          for _ in range(N)]) * 60
        boxes = np.round(boxes).astype(np.float32)
    else:
        K = c["K"]
        boxes = np.stack([_clustered(rng, K // 10, 10) for _ in range(N)])
    valid = np.ones((N, K), bool)
    if c.get("holes"):
        valid = rng.rand(N, K) > 0.3
        valid[:, -10:] = False              # trailing invalid columns
    classes = rng.randint(0, c["classes"], (N, K)) if "classes" in c \
        else None
    topk = c.get("topk", K)
    rule = tdet.pixel_iou if c.get("pixel") else tdet.iou_matrix
    keep = tdet.nms_keep(
        torch.from_numpy(boxes), torch.from_numpy(valid), c["thresh"], rule,
        classes=None if classes is None else torch.from_numpy(classes),
        topk=topk).numpy()
    for n in range(N):
        want = _np_greedy(boxes[n], valid[n], c["thresh"],
                          None if classes is None else classes[n], topk,
                          c.get("pixel", False))
        np.testing.assert_array_equal(keep[n], want)
    if "chain" in c:
        assert keep[0].sum() == (K + 1) // 2


def test_nms_helper_chunks_images(monkeypatch):
    """The overlap matrix is built for a few images at a time; the answer
    does not depend on the chunk size."""
    rng = np.random.RandomState(5)
    boxes = torch.from_numpy(np.stack([_clustered(rng, 8, 8)
                                       for _ in range(5)]))
    valid = torch.ones(5, 64, dtype=torch.bool)
    whole = tdet.nms_keep(boxes, valid, 0.3, tdet.iou_matrix)
    monkeypatch.setattr(tdet, "NMS_CHUNK_ELEMENTS", 64 * 64 * 2)
    assert torch.equal(tdet.nms_keep(boxes, valid, 0.3, tdet.iou_matrix),
                       whole)


# --------------------------------------------------------------------------
# ROIPooling
# --------------------------------------------------------------------------
def _roi_vjp(feat, rois, attrs, seed):
    fn = jreg.get("ROIPooling").fn
    out, vjp = jax.vjp(
        jax.jit(lambda d: fn(d, jnp.asarray(rois), **attrs)),
        jnp.asarray(feat))
    ct = np.random.RandomState(seed).randn(*out.shape).astype(np.float32)
    jg, = vjp(jnp.asarray(ct))
    x = torch.from_numpy(feat).requires_grad_()
    t = treg.get("ROIPooling").fn(x, torch.from_numpy(rois), **attrs)
    tg, = torch.autograd.grad(t, x, torch.from_numpy(ct))
    return np.asarray(out), t.detach().numpy(), np.asarray(jg), tg.numpy()


def test_roi_pooling_jax_case_values_and_gradient():
    feat = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.array([[0, 0, 0, 3, 3], [0, 2, 2, 3, 3]], np.float32)
    jo, to, jg, tg = _roi_vjp(feat, rois, dict(pooled_size=(2, 2),
                                               spatial_scale=1.0), 0)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(to[0, 0], [[5., 7.], [13., 15.]])
    np.testing.assert_allclose(tg, jg, **GRAD)


def test_roi_pooling_random_vs_jax(monkeypatch):
    rng = np.random.RandomState(1)
    feat = rng.randn(2, 3, 12, 10).astype(np.float32)
    rois = np.array([[0, 0, 0, 40, 30], [1, 8, 4, 36, 44],
                     [0, 20, 20, 22, 21], [1, 30, 30, 60, 60]], np.float32)
    attrs = dict(pooled_size=(3, 2), spatial_scale=0.25)
    monkeypatch.setattr(tdet, "ROI_CHUNK_ELEMENTS", 3 * 6 * 120 * 2)
    jo, to, jg, tg = _roi_vjp(feat, rois, attrs, 2)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(tg, jg, **GRAD)


def test_roi_pooling_tie_shares_its_gradient_as_jax():
    feat = np.ones((1, 1, 4, 4), np.float32)     # every bin all ties
    rois = np.array([[0, 0, 0, 3, 3]], np.float32)
    _, _, jg, tg = _roi_vjp(feat, rois, dict(pooled_size=(2, 2)), 3)
    np.testing.assert_allclose(tg, jg, **GRAD)


# --------------------------------------------------------------------------
# MakeLoss
# --------------------------------------------------------------------------
MAKELOSS_CASES = {
    "null": ((4, 5), dict()),
    "null_scale": ((4, 5), dict(grad_scale=0.3)),
    "batch": ((4, 5), dict(normalization="batch", grad_scale=2.0)),
    "batch_0d": ((), dict(normalization="batch")),
    "valid": ((4, 5), dict(normalization="valid")),
    "valid_thresh": ((3, 6), dict(normalization="valid", valid_thresh=0.5,
                                  grad_scale=1.5)),
    "valid_none_above": ((2, 3), dict(normalization="valid",
                                      valid_thresh=10.0)),
    "zero_scale": ((4, 5), dict(grad_scale=0.0)),
}


@pytest.mark.parametrize("case", sorted(MAKELOSS_CASES))
def test_makeloss_vs_jax_vjp(case):
    shape, attrs = MAKELOSS_CASES[case]
    x = np.asarray(np.random.RandomState(0).randn(*shape), np.float32)
    fn = jreg.get("MakeLoss").fn
    out, vjp = jax.vjp(lambda d: fn(d, **attrs), jnp.asarray(x))
    ct = np.asarray(np.random.RandomState(1).randn(*out.shape), np.float32)
    jg, = vjp(jnp.asarray(ct))
    t = torch.from_numpy(x).requires_grad_()
    to = treg.get("MakeLoss").fn(t, **attrs)
    tg, = torch.autograd.grad(to, t, torch.from_numpy(ct))
    np.testing.assert_array_equal(to.detach().numpy(), np.asarray(out))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **GRAD)


def test_makeloss_refuses_an_unknown_normalization():
    x = torch.zeros(2, 2)
    with pytest.raises(ValueError):
        treg.get("MakeLoss").fn(x, normalization="valdi")
    with pytest.raises(ValueError):
        jreg.get("MakeLoss").fn(jnp.zeros((2, 2)), normalization="valdi")
    net = mt.sym.MakeLoss(mt.sym.Variable("x"), normalization="mean")
    with pytest.raises(mt.base.MXNetError, match="normalization"):
        net.infer_shape(x=(2, 2))
