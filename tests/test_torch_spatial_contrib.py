"""The contrib and spatial ops of the PyTorch port against the same ops of
the JAX package, on the same numpy inputs: fft, ifft, count_sketch,
quantize, dequantize, Proposal, MultiProposal, PSROIPooling,
DeformableConvolution, DeformablePSROIPooling, GridGenerator,
BilinearSampler, SpatialTransformer and Correlation.  Forward, and for
the differentiable ones the gradient of every float input (``jax.vjp``
against ``torch.autograd.grad`` with the same seeded cotangent of the
first output).  The cases are those of ``tests/test_spatial_contrib.py``.

Tolerances, each with its reason:

* 1e-5 relative and absolute (f32) for values and gradients: both
  packages compute in f32 and differ only in summation order (the
  summed-area tables, the deformable product, FFTs of up to 16 points)
  and in the last ulp of exp.
* Quantized values, proposals' order and the NMS's choices are exact:
  they are decisions on the same f32 numbers.
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
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _as_np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _compare(name, arrays, attrs, grad=True, seed=0, tol=TOL):
    """Every output in both packages and, with ``grad``, the gradient of
    sum(out0 * g) with respect to every float input.  The JAX side runs
    under one ``jax.jit`` (XLA compiles the op once instead of op by
    op; it rounds each operation as the eager run does)."""
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn
    floats = [i for i, a in enumerate(arrays)
              if np.issubdtype(a.dtype, np.floating)] if grad else []

    def jf(*fl):
        full = [jnp.asarray(a) for a in arrays]
        for i, v in zip(floats, fl):
            full[i] = v
        out = jfn(*full, **attrs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)
    jouts, vjp = jax.vjp(jax.jit(jf),
                         *[jnp.asarray(arrays[i]) for i in floats])
    tins = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in floats:
        tins[i].requires_grad_()
    touts = tfn(*tins, **attrs)
    touts = list(touts) if isinstance(touts, (tuple, list)) else [touts]
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j, t = _as_np(j), _as_np(t)
        assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape)
        np.testing.assert_allclose(t, j, **tol)
    if not grad:
        return jouts, touts
    g = np.random.RandomState(seed + 1).randn(
        *np.shape(jouts[0])).astype(np.float32)
    jgrads = vjp(tuple(jnp.asarray(g) if k == 0 else jnp.zeros_like(o)
                       for k, o in enumerate(jouts)))
    tgrads = torch.autograd.grad(touts[0], [tins[i] for i in floats],
                                 torch.from_numpy(g), allow_unused=True)
    for i, jg, tg in zip(floats, jgrads, tgrads):
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, jg, err_msg=f"input {i}", **tol)
    return jouts, touts


def _rs(seed):
    return np.random.RandomState(seed)


# --- fft / ifft / count_sketch / quantize ---------------------------------

@pytest.mark.parametrize("shape", [(3, 8), (2, 2, 16)])
def test_fft_vs_jax(shape):
    x = _rs(5).randn(*shape).astype(np.float32)
    _compare("_contrib_fft", [x], {})


def test_ifft_vs_jax_and_roundtrip():
    x = _rs(6).randn(2, 16).astype(np.float32)
    f = np.asarray(jreg.get("_contrib_fft").fn(jnp.asarray(x)))
    _compare("_contrib_ifft", [f], {})
    back = mt.nd.contrib.ifft(mt.nd.contrib.fft(mt.nd.array(x, ctx=mt.cpu())))
    np.testing.assert_allclose(back.asnumpy() / 16.0, x, **TOL)


@pytest.mark.parametrize("out_dim", [3, 5])
def test_count_sketch_vs_jax(out_dim):
    rs = _rs(7)
    x = rs.randn(4, 6).astype(np.float32)
    h = np.array([0, 2, 1, 2, 0, 1], np.float32)
    s = np.array([1, -1, 1, 1, -1, 1], np.float32)
    _compare("_contrib_count_sketch", [x, h, s], dict(out_dim=out_dim))


def test_count_sketch_requires_out_dim():
    with pytest.raises(ValueError):
        treg.get("_contrib_count_sketch").fn(
            torch.zeros(2, 3), torch.zeros(3), torch.ones(3))


def test_quantize_dequantize_vs_jax():
    x = np.linspace(-1.0, 2.0, 17).astype(np.float32)
    lo, hi = np.array([-1.0], np.float32), np.array([2.0], np.float32)
    _, (q, qlo, qhi) = _compare("_contrib_quantize", [x, lo, hi], {},
                                grad=False, tol=dict(rtol=0, atol=0))
    assert q.dtype == torch.uint8
    _compare("_contrib_dequantize", [q.numpy(), lo, hi], {}, grad=False)
    with pytest.raises(NotImplementedError):
        treg.get("_contrib_quantize").fn(torch.from_numpy(x),
                                         torch.from_numpy(lo),
                                         torch.from_numpy(hi),
                                         out_type="int8")


# --- Proposal / MultiProposal ----------------------------------------------

PROPOSAL_CASES = {
    "shapes_and_validity": (8, 1, 6, 7, dict(
        feature_stride=16, scales=(2.,), ratios=(0.5, 1., 2.),
        rpn_pre_nms_top_n=30, rpn_post_nms_top_n=10, threshold=0.7,
        rpn_min_size=4), (96., 112., 1.0)),
    "numpy_pipeline": (9, 1, 5, 6, dict(
        feature_stride=8, scales=(4.,), ratios=(1.,), rpn_pre_nms_top_n=20,
        rpn_post_nms_top_n=8, threshold=0.7, rpn_min_size=4),
        (40., 48., 1.0)),
    "output_score": (15, 1, 3, 3, dict(
        feature_stride=16, scales=(4.,), ratios=(1.,), rpn_pre_nms_top_n=9,
        rpn_post_nms_top_n=4, threshold=0.7, rpn_min_size=1,
        output_score=True), (48., 48., 1.0)),
    "multi_batch": (10, 3, 4, 4, dict(
        feature_stride=16, scales=(4., 8.), ratios=(1.,),
        rpn_pre_nms_top_n=16, rpn_post_nms_top_n=5, threshold=0.7,
        rpn_min_size=2), (64., 64., 1.0)),
    "tied_scores_wrap": (16, 2, 6, 6, dict(
        feature_stride=8, scales=(2., 6.), ratios=(0.5, 1.),
        rpn_pre_nms_top_n=50, rpn_post_nms_top_n=40, threshold=0.3,
        rpn_min_size=3), (40., 44., 1.0)),
}


@pytest.mark.parametrize("case", sorted(PROPOSAL_CASES))
def test_proposal_vs_jax(case):
    seed, b, h, w, attrs, info = PROPOSAL_CASES[case]
    a = len(attrs["scales"]) * len(attrs["ratios"])
    rs = _rs(seed)
    cls = rs.rand(b, 2 * a, h, w).astype(np.float32)
    if case == "tied_scores_wrap":          # ties in the top-k sort
        cls = np.round(cls * 3) / 3
    bbox = (rs.randn(b, 4 * a, h, w) * 0.2).astype(np.float32)
    im_info = np.tile(np.array([info], np.float32), (b, 1))
    name = "_contrib_Proposal" if b == 1 else "_contrib_MultiProposal"
    jouts, touts = _compare(name, [cls, bbox, im_info], attrs, grad=False,
                            tol=dict(rtol=1e-6, atol=1e-4))
    assert touts[0].shape == (b * attrs["rpn_post_nms_top_n"], 5)
    np.testing.assert_array_equal(touts[0][:, 0].numpy(),
                                  np.asarray(jouts[0])[:, 0])
    # the nd wrapper shows the scores only with output_score
    ret = getattr(mt.nd.contrib, name[len("_contrib_"):])(
        *[mt.nd.array(v, ctx=mt.cpu()) for v in (cls, bbox, im_info)],
        **attrs)
    assert isinstance(ret, list) == bool(attrs.get("output_score"))


def test_proposal_default_pre_nms_6000():
    """The default rpn_pre_nms_top_n (6000) over a 38 x 50 map of 12
    anchors: the NMS over 6000 boxes runs without a per-box loop and
    gives the JAX package's rois."""
    rs = _rs(17)
    cls = rs.rand(1, 24, 38, 50).astype(np.float32)
    bbox = (rs.randn(1, 48, 38, 50) * 0.1).astype(np.float32)
    im_info = np.array([[600., 800., 1.0]], np.float32)
    _compare("_contrib_Proposal", [cls, bbox, im_info], {}, grad=False,
             tol=dict(rtol=1e-6, atol=1e-3))


# --- PSROIPooling -----------------------------------------------------------

def test_psroi_pooling_vs_jax():
    rs = _rs(11)
    od, p, g = 2, 3, 3
    data = rs.randn(2, od * g * g, 9, 9).astype(np.float32)
    rois = np.array([[0, 0, 0, 32, 32], [1, 8, 4, 40, 28],
                     [0, 16, 16, 47, 47], [1, 60, 60, 70, 70]], np.float32)
    _compare("_contrib_PSROIPooling", [data, rois],
             dict(spatial_scale=0.2, output_dim=od, pooled_size=p,
                  group_size=g))


def test_psroi_pooling_group_size_differs():
    rs = _rs(18)
    data = rs.randn(1, 3 * 2 * 2, 8, 8).astype(np.float32)
    rois = np.array([[0, 4, 4, 28, 20], [0, 0, 0, 31, 31]], np.float32)
    _compare("_contrib_PSROIPooling", [data, rois],
             dict(spatial_scale=0.25, output_dim=3, pooled_size=4,
                  group_size=2))


# --- deformable ops ---------------------------------------------------------

DCONV_CASES = {
    "zero_offset": ((2, 4, 7, 7), (6, 4, 3, 3), True, None,
                    dict(kernel=(3, 3), num_filter=6)),
    "random_offset_pad_stride": ((1, 4, 8, 8), (4, 4, 3, 3), True, 0.8,
                                 dict(kernel=(3, 3), num_filter=4,
                                      pad=(1, 1), stride=(2, 2))),
    "groups_deformable_groups": ((1, 4, 6, 6), (4, 2, 3, 3), False, 0.5,
                                 dict(kernel=(3, 3), num_filter=4,
                                      num_group=2, num_deformable_group=2,
                                      no_bias=True, dilate=(1, 1))),
    "dilate": ((1, 2, 9, 9), (3, 2, 3, 3), True, 0.6,
               dict(kernel=(3, 3), num_filter=3, dilate=(2, 2),
                    pad=(2, 2))),
}


@pytest.mark.parametrize("case", sorted(DCONV_CASES))
def test_deformable_convolution_vs_jax(case):
    xs, ws, bias, scale, attrs = DCONV_CASES[case]
    rs = _rs(12)
    x = rs.randn(*xs).astype(np.float32)
    wgt = rs.randn(*ws).astype(np.float32)
    kh, kw = attrs["kernel"]
    s = attrs.get("stride", (1, 1))
    d = attrs.get("dilate", (1, 1))
    p = attrs.get("pad", (0, 0))
    ho = (xs[2] + 2 * p[0] - (d[0] * (kh - 1) + 1)) // s[0] + 1
    wo = (xs[3] + 2 * p[1] - (d[1] * (kw - 1) + 1)) // s[1] + 1
    dg = attrs.get("num_deformable_group", 1)
    off = np.zeros((xs[0], dg * 2 * kh * kw, ho, wo), np.float32)
    if scale:
        # away from integer positions, where the bilinear weights kink
        off = (rs.uniform(0.1, 0.4, off.shape) * np.sign(
            rs.randn(*off.shape)) * scale).astype(np.float32)
    arrays = [x, off, wgt]
    if bias:
        arrays.append(rs.randn(ws[0]).astype(np.float32))
    _compare("_contrib_DeformableConvolution", arrays, attrs)


def test_deformable_conv_constant_shift_case():
    x = np.arange(36, dtype=np.float32).reshape(1, 1, 6, 6)
    wgt = np.ones((1, 1, 1, 1), np.float32)
    off = np.ones((1, 2, 6, 6), np.float32)
    _compare("_contrib_DeformableConvolution", [x, off, wgt],
             dict(kernel=(1, 1), num_filter=1, no_bias=True))


DPSROI_CASES = {
    "no_trans_constant": (dict(spatial_scale=0.25, output_dim=2,
                               pooled_size=3, group_size=3, part_size=3,
                               sample_per_part=2, trans_std=0.1), 2, 8, 1),
    "trans": (dict(spatial_scale=0.25, output_dim=4, pooled_size=2,
                   group_size=2, part_size=2, sample_per_part=3,
                   trans_std=0.2), 4, 12, 2),
    "no_trans_flag": (dict(spatial_scale=0.25, output_dim=2, pooled_size=2,
                           group_size=2, sample_per_part=2, no_trans=True),
                      2, 10, 1),
}


@pytest.mark.parametrize("case", sorted(DPSROI_CASES))
def test_deformable_psroi_pooling_vs_jax(case):
    attrs, od, size, classes = DPSROI_CASES[case]
    rs = _rs(19)
    p, g = attrs["pooled_size"], attrs["group_size"]
    ps = attrs.get("part_size") or p
    data = rs.randn(2, od * g * g, size, size).astype(np.float32)
    rois = np.array([[0, 4, 4, 28, 28], [1, 0, 2, 20, 36],
                     [0, 10, 6, 44, 30]], np.float32)
    trans = (rs.uniform(0.1, 0.9, (3, 2 * classes, ps, ps))
             * np.sign(rs.randn(3, 2 * classes, ps, ps))).astype(np.float32)
    _compare("_contrib_DeformablePSROIPooling", [data, rois, trans], attrs)


# --- GridGenerator / BilinearSampler / SpatialTransformer -------------------

@pytest.mark.parametrize("theta,shape", [
    ([1., 0., 0., 0., 1., 0.], (4, 5)),
    ([1., 0., 0.25, 0., 1., -0.5], (3, 3)),
    ([0.8, 0.1, 0.05, -0.1, 0.9, -0.02], (6, 4)),
])
def test_grid_generator_affine_vs_jax(theta, shape):
    t = np.array([theta, theta], np.float32)
    _compare("GridGenerator", [t], dict(transform_type="affine",
                                        target_shape=shape))


def test_grid_generator_warp_vs_jax():
    flow = (_rs(20).randn(2, 2, 4, 6) * 0.5).astype(np.float32)
    _compare("GridGenerator", [flow], dict(transform_type="warp"))


def _identity_grid(b, h, w):
    gx, gy = np.meshgrid(np.linspace(-1, 1, w), np.linspace(-1, 1, h))
    return np.tile(np.stack([gx, gy])[None], (b, 1, 1, 1)).astype(np.float32)


@pytest.mark.parametrize("case", ["identity", "random", "out_of_bounds"])
def test_bilinear_sampler_vs_jax(case):
    rs = _rs(1)
    x = rs.randn(2, 3, 5, 7).astype(np.float32)
    if case == "identity":
        grid = _identity_grid(2, 5, 7)
    elif case == "random":
        grid = (rs.rand(2, 2, 4, 6).astype(np.float32) - 0.5) * 1.8
    else:
        grid = (rs.rand(2, 2, 3, 3).astype(np.float32) - 0.5) * 5
    _compare("BilinearSampler", [x, grid], {})


# at the identity every sample sits on a pixel centre, where the sampler's
# gradient in theta jumps (the bilinear pair changes); the two packages'
# linspace may put a centre an ulp to either side, so the identity is
# held forward only and the gradient near it
@pytest.mark.parametrize("theta,shape,grad", [
    ([1., 0., 0., 0., 1., 0.], (6, 6), False),
    ([1.01, 0., 0.003, 0., 0.99, -0.004], (6, 6), True),
    ([0.8, 0.1, 0.05, -0.1, 0.9, -0.02], (4, 4), True),
])
def test_spatial_transformer_vs_jax(theta, shape, grad):
    x = _rs(3).randn(2, 2, 6, 6).astype(np.float32)
    loc = np.array([theta, theta], np.float32)
    _compare("SpatialTransformer", [x, loc],
             dict(target_shape=shape, transform_type="affine",
                  sampler_type="bilinear"), grad=grad)


# --- Correlation ------------------------------------------------------------

@pytest.mark.parametrize("k,md,s1,s2,pad,mult", [
    (1, 1, 1, 1, 1, True),
    (3, 2, 2, 1, 2, True),
    (1, 2, 1, 2, 2, False),
])
def test_correlation_vs_jax(k, md, s1, s2, pad, mult):
    rs = _rs(4)
    d1 = rs.randn(2, 3, 8, 9).astype(np.float32)
    d2 = rs.randn(2, 3, 8, 9).astype(np.float32)
    _compare("Correlation", [d1, d2],
             dict(kernel_size=k, max_displacement=md, stride1=s1,
                  stride2=s2, pad_size=pad, is_multiply=mult))


def test_symbolic_shapes_vs_jax():
    """infer_shape of a graph of the spatial ops equals the JAX
    package's (the port infers by running the ops on meta tensors)."""
    import mxnet_tpu as mx
    shapes = dict(data=(2, 3, 8, 8), loc=(2, 6), a=(2, 4, 8, 8),
                  b=(2, 4, 8, 8))
    outs = []
    for m in (mx, mt):
        st = m.sym.SpatialTransformer(m.sym.Variable("data"),
                                      m.sym.Variable("loc"),
                                      target_shape=(5, 5))
        cor = m.sym.Correlation(m.sym.Variable("a"), m.sym.Variable("b"),
                                kernel_size=3, max_displacement=2,
                                pad_size=2)
        prop = m.sym.contrib.MultiProposal(
            m.sym.Variable("cls"), m.sym.Variable("bbox"),
            m.sym.Variable("info"), rpn_post_nms_top_n=7, scales=(8.,),
            ratios=(1.,), output_score=True)
        outs.append([m.sym.Group([st, cor]).infer_shape(**shapes)[1],
                     prop.infer_shape(cls=(2, 2, 4, 4), bbox=(2, 4, 4, 4),
                                      info=(2, 3))[1]])
    assert outs[0] == outs[1]
