"""ResNet in the PyTorch port against the JAX package: small networks of
``models/resnet.py`` built by both packages (bottleneck and basic units,
the cifar stem, the conv7 and s2d stems, NCHW and NHWC), forward and
every parameter gradient from the same numpy weights; the port's own
s2d-vs-conv7 and NHWC-vs-NCHW identities; and the bf16 contract.
Training through Module is ``tests/test_torch_resnet_train.py``.

Tolerances:
* forward (softmax probabilities) 1e-5 absolute in float32: summation
  order only;
* gradients: within 1e-4 of the network's largest gradient element.  A
  gradient is a sum over the batch and every pixel, and BatchNorm's
  backward subtracts two such sums of similar size, so f32 rounding
  leaves an error of the size of the largest terms' rounding, also in
  a parameter whose gradient cancels to near 0 (measured: up to 8e-6 of
  the largest element);
* the moving statistics of a training forward: within 1e-4 of each
  one's largest element (measured: 1e-6)."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from mxnet_tpu.executor import build_interpreter as jbuild
from mxnet_tpu.models.resnet import resnet as j_resnet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_interpreter as tbuild
from mxnet_tpu_torch.models.resnet import (resnet as t_resnet,
                                           space_to_depth_stem_weight)
import torch_threads  # noqa: F401,E402  a worker's share of the cores

FWD_TOL = 1e-5
GRAD_RTOL = 1e-4
INPUTS = ("data", "softmax_label")

VARIANTS = {
    # (units, filter_list, bottle_neck, image_shape, stem, layout)
    "bottleneck_conv7": ([1, 1, 1, 1], [8, 16, 32, 64, 128], True,
                         (3, 64, 64), "conv7", "NCHW"),
    "basic_conv7": ([1, 1, 1, 1], [8, 8, 16, 32, 64], False, (3, 64, 64),
                    "conv7", "NCHW"),
    "bottleneck_s2d_nhwc": ([1, 1, 1, 1], [8, 16, 32, 64, 128], True,
                            (3, 64, 64), "s2d", "NHWC"),
    "cifar_basic": ([1, 1, 1], [8, 8, 16, 32], False, (3, 28, 28), "conv7",
                    "NCHW"),
}


def _net(pkg_resnet, variant, num_classes=10):
    units, filters, bottle, shape, stem, layout = VARIANTS[variant]
    return pkg_resnet(units=units, num_stages=len(units),
                      filter_list=filters, num_classes=num_classes,
                      image_shape=shape, bottle_neck=bottle, stem=stem,
                      layout=layout)


def _params(net, B, shape, seed=0):
    """He-scaled conv/FC weights, gamma near 1, small beta and moving
    statistics near (0, 1), as numpy."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + shape,
                                                softmax_label=(B,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in INPUTS:
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        args[n] = v.astype(np.float32)
    aux = {}
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        v = (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
             else rng.randn(*s) * 0.1)
        aux[n] = v.astype(np.float32)
    return args, aux


def _batch(B, shape, num_classes=10, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B,) + shape).astype(np.float32),
            rng.randint(0, num_classes, (B,)).astype(np.float32))


def _jax_step(net, args, aux, x, y, compute_dtype=None):
    """(probabilities, {param: grad}, {aux: new value}) of one training
    forward and backward, by the JAX package's interpreter and jax.vjp
    (jitted: one compile instead of one per op)."""
    run, names, aux_names = jbuild(net, compute_dtype)
    pnames = [n for n in names if n not in INPUTS]

    def f(*pv):
        env = dict(zip(pnames, pv), data=jnp.asarray(x),
                   softmax_label=jnp.asarray(y))
        outs, new_aux = run([env[n] for n in names],
                            [jnp.asarray(aux[n]) for n in aux_names],
                            jax.random.PRNGKey(0), True)
        return outs[0], new_aux

    def step(pv):
        out, vjp, new_aux = jax.vjp(f, *pv, has_aux=True)
        return out, vjp(jnp.ones_like(out)), new_aux
    out, grads, new_aux = jax.jit(step)(
        tuple(jnp.asarray(args[n]) for n in pnames))
    return (np.asarray(out, np.float32),
            {n: np.asarray(g, np.float32) for n, g in zip(pnames, grads)},
            {n: np.asarray(v) for n, v in zip(aux_names, new_aux)})


def _torch_step(net, args, aux, x, y, compute_dtype=None):
    """The same by the port's interpreter and torch.autograd.grad, on the
    CPU."""
    run, names, aux_names = tbuild(net, compute_dtype)
    vals = [torch.from_numpy(x if n == "data" else y if n == "softmax_label"
                             else args[n].copy()) for n in names]
    leaves = [v.requires_grad_() for n, v in zip(names, vals)
              if n not in INPUTS]
    outs, new_aux = run(vals, [torch.from_numpy(aux[n].copy())
                               for n in aux_names], is_train=True)
    grads = torch.autograd.grad(outs[0], leaves, torch.ones_like(outs[0]),
                                allow_unused=True)
    pnames = [n for n in names if n not in INPUTS]
    return (outs[0].detach().float().numpy(),
            {n: (np.zeros(args[n].shape, np.float32) if g is None
                 else g.float().numpy()) for n, g in zip(pnames, grads)},
            {n: v.numpy() for n, v in zip(aux_names, new_aux)})


def _assert_grads(got, want):
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n in want:
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= GRAD_RTOL * scale, (n, err, scale)


def _assert_aux(got, want):
    for n in want:
        scale = float(np.abs(want[n]).max())
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= GRAD_RTOL * scale, (n, err, scale)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_and_gradients_match_jax(variant):
    jnet, tnet = _net(j_resnet, variant), _net(t_resnet, variant)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    shape, B = VARIANTS[variant][3], 2
    args, aux = _params(jnet, B, shape)
    x, y = _batch(B, shape)
    # the port's parameters are carried over by its own converter, which
    # checks every name and shape against the port's symbol
    targs, taux = mt.params_from_numpy(args, aux, mt.cpu(), tnet,
                                       {"data": (B,) + shape,
                                        "softmax_label": (B,)})
    jout, jgrads, jaux = _jax_step(jnet, args, aux, x, y)
    tout, tgrads, tnew = _torch_step(
        tnet, {n: v.numpy() for n, v in targs.items()},
        {n: v.numpy() for n, v in taux.items()}, x, y)
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FWD_TOL)
    assert set(tgrads) == set(jgrads)
    _assert_grads(tgrads, jgrads)
    _assert_aux(tnew, jaux)
    # gamma of bn_data is fixed (fix_gamma=True): no gradient from the loss
    assert not np.any(tgrads["bn_data_gamma"])


def _eval_forward(net, args, aux, x, y):
    run, names, aux_names = tbuild(net)
    vals = [torch.from_numpy(x if n == "data" else y if n == "softmax_label"
                             else args[n]) for n in names]
    return run(vals, [torch.from_numpy(aux[n]) for n in aux_names])[0][0] \
        .numpy()


def test_s2d_stem_equals_conv7():
    """The port's version of ``tests/test_models.py``'s
    ``test_s2d_stem_equivalent_to_conv7``: the same weights through
    ``space_to_depth_stem_weight`` give the same function."""
    rs = np.random.RandomState(3)
    B = 2
    x = rs.uniform(-1, 1, (B, 3, 64, 64)).astype("f")
    y = np.zeros(B, np.float32)
    kw = dict(num_layers=18, num_classes=10, image_shape="3,64,64")
    ref = mt.models.resnet(stem="conv7", **kw)
    s2d = mt.models.resnet(stem="s2d", **kw)
    args, aux = _params(ref, B, (3, 64, 64), seed=3)
    args2 = dict(args, conv0_weight=space_to_depth_stem_weight(
        args["conv0_weight"]))
    o1 = _eval_forward(ref, args, aux, x, y)
    o2 = _eval_forward(s2d, args2, aux, x, y)
    np.testing.assert_allclose(o1, o2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_nhwc_equals_nchw(stem):
    """The port's version of ``tests/test_models.py``'s
    ``test_nhwc_layout_matches_nchw``: the same (OIHW) weights give the
    same outputs, gradients and moving statistics in both layouts."""
    rs = np.random.RandomState(7)
    B = 2
    x = rs.uniform(-1, 1, (B, 3, 64, 64)).astype("f")
    y = rs.randint(0, 10, (B,)).astype("f")
    kw = dict(num_layers=18, num_classes=10, image_shape="3,64,64",
              stem=stem)
    nchw = mt.models.resnet(layout="NCHW", **kw)
    nhwc = mt.models.resnet(layout="NHWC", **kw)
    assert nchw.list_arguments() == nhwc.list_arguments()
    args, aux = _params(nchw, B, (3, 64, 64), seed=7)
    o1, g1, a1 = _torch_step(nchw, args, aux, x, y)
    o2, g2, a2 = _torch_step(nhwc, args, aux, x, y)
    np.testing.assert_allclose(o2, o1, rtol=0, atol=FWD_TOL)
    _assert_grads(g2, g1)
    _assert_aux(a2, a1)


class _OpDtypes(TorchDispatchMode):
    """Records the dtypes of the tensor arguments of every call of the
    watched aten ops."""

    def __init__(self, ops):
        super().__init__()
        self.ops = ops
        self.calls = {op: [] for op in ops}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops:
            self.calls[func].append([a.dtype if isinstance(a, torch.Tensor)
                                     else None for a in args])
        return func(*args, **(kwargs or {}))


def test_bf16_contract_bf16_convolutions_no_fp32_activation_saved():
    """Under ``compute_dtype="bfloat16"`` every convolution, forward and
    backward, gets bf16 operands; BatchNorm gets its data in bf16 and
    gamma and beta in fp32; and no tensor that autograd saves for the
    backward with at least N*C*H*W elements (the input batch's size) is
    fp32, so no fp32 copy of an activation is kept.  The port's
    counterpart of ``tests/test_amp_hlo.py``."""
    B, shape = 2, (3, 64, 64)
    net = t_resnet(units=[1, 1, 1, 1], num_stages=4,
                   filter_list=[16, 64, 64, 128, 256], num_classes=10,
                   image_shape=shape, bottle_neck=True)
    args, aux = _params(net, B, shape)
    x, y = _batch(B, shape)
    run, names, aux_names = tbuild(net, "bfloat16")
    vals = [torch.from_numpy(x if n == "data" else y if n == "softmax_label"
                             else args[n].copy()) for n in names]
    leaves = [v.requires_grad_() for n, v in zip(names, vals)
              if n not in INPUTS]
    saved = []

    def pack(t):
        saved.append((t.dtype, t.numel()))
        return t
    conv = torch.ops.aten.convolution.default
    conv_bwd = torch.ops.aten.convolution_backward.default
    bn = torch.ops.aten.native_batch_norm.default
    with _OpDtypes([conv, conv_bwd, bn]) as rec:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            outs, _ = run(vals, [torch.from_numpy(aux[n])
                                 for n in aux_names], is_train=True)
        grads = torch.autograd.grad(outs[0], leaves,
                                    torch.ones_like(outs[0]),
                                    allow_unused=True)
    n_convs = sum(1 for n in names if n.endswith("conv0_weight")
                  or "_conv" in n or n.endswith("_sc_weight"))
    assert len(rec.calls[conv]) == n_convs > 10
    assert len(rec.calls[conv_bwd]) == n_convs
    for dts in rec.calls[conv]:
        assert dts[:2] == [torch.bfloat16, torch.bfloat16], dts
    for dts in rec.calls[conv_bwd]:
        assert dts[:3] == [torch.bfloat16] * 3, dts
    assert rec.calls[bn]
    for dts in rec.calls[bn]:
        assert dts[:3] == [torch.bfloat16, torch.float32, torch.float32], dts
    big = B * int(np.prod(shape))
    fp32_big = [s for s in saved if s[0] == torch.float32 and s[1] >= big]
    bf16_big = [s for s in saved if s[0] == torch.bfloat16 and s[1] >= big]
    assert fp32_big == [] and len(bf16_big) > 10, (fp32_big, bf16_big)
    # the masters stay fp32 and get fp32 gradients
    assert all(g is None or g.dtype == torch.float32 for g in grads)


@pytest.mark.parametrize("label_dtype", [np.float32, np.int32])
def test_bf16_float_label_999_trains_as_999(label_dtype):
    """SoftmaxOutput is in AMP_FP32_OPS and on this path the label reaches
    it directly, so a float label of 999 is not rounded to bf16 (where
    999 would become 1000, out of range): the fc1 bias gradient is
    p - 1 at 999 for that row, as with an int32 label, in both
    packages."""
    variant, B = "cifar_basic", 2
    shape = VARIANTS[variant][3]
    jnet = _net(j_resnet, variant, num_classes=1000)
    tnet = _net(t_resnet, variant, num_classes=1000)
    args, aux = _params(jnet, B, shape)
    x = _batch(B, shape)[0]
    y = np.array([999, 3], label_dtype)
    tout, tgrads, _ = _torch_step(tnet, args, aux, x, y, "bfloat16")
    gb = tgrads["fc1_bias"]
    assert gb[999] < -0.5 and gb[3] < -0.5
    assert np.all(np.delete(gb, [3, 999]) >= 0)
    _, jgrads, _ = _jax_step(jnet, args, aux, x, y, jnp.bfloat16)
    jgb = jgrads["fc1_bias"]
    assert jgb[999] < -0.5
    # both packages target the same classes; the values differ by where
    # each rounds to bf16
    np.testing.assert_allclose(gb, jgb, atol=0.05)


def test_resnet50_fp32_gradient_against_float64():
    """The error budget of ``chip_smoke.py``'s fp32 card-vs-CPU step: the
    same ResNet-50 (full depth and width, batch 4 of 128x128, the same
    seeded weights) in fp32 and in float64 on the CPU.  The forward and
    the head's gradient hold tightly, but BatchNorm over 64 values a
    channel in the last stage makes the backward ill-conditioned: fp32
    moves the whole gradient by about 1e-2 of its norm against float64,
    and single parameters by far more than 1e-3 of their largest element.
    The card check's bounds (5e-2 of the norm, 1e-3 on fc1) must hold
    here with a margin of 3."""
    import chip_smoke as cs
    B, shape = cs.RESNET_FP32_BATCH, cs.RESNET_FP32_IMAGE
    sym, args, aux = cs.resnet_numpy_params(mt, B, shape, cs.SEED + 7)
    rng = np.random.default_rng(cs.SEED + 8)
    x = rng.uniform(-1, 1, (B,) + shape).astype(np.float32)
    y = rng.integers(0, 1000, B).astype(np.float32)
    res = {}
    for dt in (torch.float32, torch.float64):
        run, names, aux_names = tbuild(sym)
        vals = [torch.from_numpy(x if n == "data" else y
                                 if n == "softmax_label" else args[n]).to(dt)
                for n in names]
        pnames = [n for n in names if n not in INPUTS]
        leaves = [v.requires_grad_() for n, v in zip(names, vals)
                  if n in pnames]
        outs, new_aux = run(vals, [torch.from_numpy(aux[n]).to(dt)
                                   for n in aux_names], is_train=True)
        grads = torch.autograd.grad(outs[0], leaves,
                                    torch.ones_like(outs[0]),
                                    allow_unused=True)
        p = outs[0].detach().double().numpy()
        res[dt] = (-np.log(p[np.arange(B), y.astype(int)]).mean(),
                   {n: g.double().numpy() for n, g in zip(pnames, grads)
                    if g is not None},
                   {n: v.double().numpy() for n, v in zip(aux_names,
                                                          new_aux)})
    (l32, g32, a32), (l64, g64, a64) = res[torch.float32], res[torch.float64]
    assert abs(l32 - l64) < cs.RESNET_FP32_LOSS_TOL / 3
    for n in a64:
        assert np.abs(a32[n] - a64[n]).max() \
            < cs.RESNET_FP32_AUX_RTOL / 3 * np.abs(a64[n]).max(), n
    for n in ("fc1_weight", "fc1_bias"):
        assert np.abs(g32[n] - g64[n]).max() \
            < cs.RESNET_FP32_HEAD_RTOL / 3 * np.abs(g64[n]).max(), n
    norm = np.sqrt(sum(((g32[n] - g64[n]) ** 2).sum() for n in g64)
                   / sum((g ** 2).sum() for g in g64.values()))
    assert norm < cs.RESNET_FP32_UPDATE_NORM_RTOL / 3
