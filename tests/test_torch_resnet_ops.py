"""The ops of the ResNet path in the PyTorch port against the same ops of
the JAX package, on the same numpy inputs: Convolution, Pooling,
BatchNorm, Activation, Flatten and identity, forward and gradient
(``jax.vjp`` against ``torch.autograd.grad`` with the same seeded
cotangent of the first output).

Tolerance: 1e-5 relative and absolute in float32.  Both packages compute
in f32 and differ only in summation order (convolutions over up to 36
products, BatchNorm statistics over up to 100 values per channel) and in
where BatchNorm rounds (the JAX package folds the statistics into a
scale and an offset, the port's ``native_batch_norm`` normalises first).
Window selection, padding and shapes must agree exactly: a wrong window
is an O(1) difference."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu.ops  # noqa: F401  registers the JAX ops

from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.executor import AMP_SPLIT_OPS

TOL = dict(rtol=1e-5, atol=1e-5)


def _arr(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _compare(name, arrays, attrs, grad=True, seed=0):
    """Forward (every output) and, with ``grad``, the gradient of
    sum(out0 * g) with respect to every float input, in both packages."""
    jfn, tfn = jreg.get(name), treg.get(name)
    jouts = jfn(*[jnp.asarray(a) for a in arrays], **attrs)
    tins = [torch.from_numpy(a.copy()) for a in arrays]
    floats = [i for i, a in enumerate(arrays)
              if np.issubdtype(a.dtype, np.floating)]
    if grad:
        for i in floats:
            tins[i].requires_grad_()
    touts = tfn(*tins, **attrs)
    jouts = jouts if isinstance(jouts, (tuple, list)) else (jouts,)
    touts = touts if isinstance(touts, (tuple, list)) else (touts,)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j, t = np.asarray(j), t.detach().numpy()
        assert j.shape == t.shape and j.dtype == t.dtype
        np.testing.assert_allclose(t, j, **TOL)
    if not grad:
        return
    g = np.random.RandomState(seed + 1).randn(
        *np.shape(jouts[0])).astype(np.float32)

    def jf(*fl):
        full = [jnp.asarray(a) for a in arrays]
        for i, v in zip(floats, fl):
            full[i] = v
        return _first(jfn(*full, **attrs))
    _, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in floats])
    jgrads = vjp(jnp.asarray(g))
    tgrads = torch.autograd.grad(_first(touts), [tins[i] for i in floats],
                                 torch.from_numpy(g), allow_unused=True)
    for i, jg, tg in zip(floats, jgrads, tgrads):
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, jg, err_msg=f"input {i}", **TOL)


R = np.random.RandomState(0)

CONV_CASES = {
    "nchw_s1_p1_bias": ((2, 4, 9, 9), (6, 4, 3, 3), True,
                        dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1))),
    "nchw_s2_p0_nobias": ((2, 4, 9, 9), (6, 4, 3, 3), False,
                          dict(kernel=(3, 3), stride=(2, 2))),
    "nchw_dilate2": ((2, 4, 9, 9), (6, 4, 3, 3), True,
                     dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2))),
    "nchw_groups2": ((2, 4, 8, 8), (6, 2, 3, 3), True,
                     dict(kernel=(3, 3), pad=(1, 1), num_group=2)),
    "nchw_7x7_s2_p3": ((2, 3, 16, 16), (8, 3, 7, 7), False,
                       dict(kernel=(7, 7), stride=(2, 2), pad=(3, 3))),
    "nhwc_s2_p1_bias": ((2, 9, 9, 4), (6, 4, 3, 3), True,
                        dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                             layout="NHWC")),
    "nhwc_groups2_1x1": ((2, 5, 5, 4), (6, 2, 1, 1), False,
                         dict(kernel=(1, 1), num_group=2, layout="NHWC")),
    "1d_s2_p1": ((2, 4, 11), (5, 4, 3), True,
                 dict(kernel=(3,), stride=(2,), pad=(1,))),
    "1d_dilate2_nobias": ((2, 4, 11), (5, 4, 3), False,
                          dict(kernel=(3,), dilate=(2,))),
    "3d_s2_p1": ((1, 2, 5, 6, 7), (3, 2, 3, 3, 3), True,
                 dict(kernel=(3, 3, 3), stride=(2, 2, 2), pad=(1, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_convolution(case):
    dshape, wshape, bias, attrs = CONV_CASES[case]
    arrays = [_arr(R, *dshape), _arr(R, *wshape)]
    if bias:
        arrays.append(_arr(R, wshape[0]))
    _compare("Convolution", arrays,
             dict(attrs, num_filter=wshape[0], no_bias=not bias))


def test_convolution_rejects_unknown_layout():
    x, w = _arr(R, 1, 2, 5, 5), _arr(R, 3, 2, 3, 3)
    with pytest.raises(ValueError, match="layout"):
        treg.get("Convolution")(torch.from_numpy(x), torch.from_numpy(w),
                                kernel=(3, 3), num_filter=3, no_bias=True,
                                layout="NWHC")


POOL_CASES = {
    # 3x3/2 pad 1 is the ResNet stem's max pool
    "max_3x3_s2_p1": ((2, 3, 9, 9), dict(pool_type="max", kernel=(3, 3),
                                         stride=(2, 2), pad=(1, 1))),
    "avg_3x3_s2_p1": ((2, 3, 9, 9), dict(pool_type="avg", kernel=(3, 3),
                                         stride=(2, 2), pad=(1, 1))),
    "sum_3x3_s2_p1": ((2, 3, 9, 9), dict(pool_type="sum", kernel=(3, 3),
                                         stride=(2, 2), pad=(1, 1))),
    "max_2x2_s2": ((2, 3, 8, 8), dict(pool_type="max", kernel=(2, 2),
                                      stride=(2, 2))),
    "max_pad_over_half_kernel": ((1, 2, 7, 7), dict(
        pool_type="max", kernel=(2, 2), stride=(1, 1), pad=(2, 2))),
    # size 8, kernel 3, stride 2: "valid" gives 3 windows, "full" 4
    "full_max_adds_window": ((2, 3, 8, 8), dict(
        pool_type="max", kernel=(3, 3), stride=(2, 2),
        pooling_convention="full")),
    "full_avg_adds_window": ((2, 3, 8, 8), dict(
        pool_type="avg", kernel=(3, 3), stride=(2, 2),
        pooling_convention="full")),
    "full_sum_adds_window": ((2, 3, 8, 8), dict(
        pool_type="sum", kernel=(3, 3), stride=(2, 2),
        pooling_convention="full")),
    "valid_avg_odd": ((2, 3, 8, 8), dict(
        pool_type="avg", kernel=(3, 3), stride=(2, 2))),
    # size 4, kernel 2, stride 3, pad 1: the last "full" window starts in
    # the right padding, which torch's ceil_mode would drop
    "full_max_window_in_padding": ((1, 2, 4, 4), dict(
        pool_type="max", kernel=(2, 2), stride=(3, 3), pad=(1, 1),
        pooling_convention="full")),
    "full_avg_window_in_padding": ((1, 2, 4, 4), dict(
        pool_type="avg", kernel=(2, 2), stride=(3, 3), pad=(1, 1),
        pooling_convention="full")),
    "global_max": ((2, 3, 5, 7), dict(pool_type="max", global_pool=True,
                                      kernel=(7, 7))),
    "global_avg": ((2, 3, 5, 7), dict(pool_type="avg", global_pool=True,
                                      kernel=(7, 7))),
    "global_sum": ((2, 3, 5, 7), dict(pool_type="sum", global_pool=True)),
    "nhwc_max_3x3_s2_p1": ((2, 9, 9, 3), dict(
        pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
        layout="NHWC")),
    "nhwc_global_avg": ((2, 5, 5, 3), dict(pool_type="avg", global_pool=True,
                                           kernel=(7, 7), layout="NHWC")),
    "nhwc_full_avg": ((2, 8, 8, 3), dict(
        pool_type="avg", kernel=(3, 3), stride=(2, 2),
        pooling_convention="full", layout="NHWC")),
    "1d_max_s2_p1": ((2, 3, 11), dict(pool_type="max", kernel=(3,),
                                      stride=(2,), pad=(1,))),
    "1d_avg_full": ((2, 3, 10), dict(pool_type="avg", kernel=(3,),
                                     stride=(2,),
                                     pooling_convention="full")),
    "3d_max_s2_p1": ((1, 2, 5, 6, 7), dict(
        pool_type="max", kernel=(3, 3, 3), stride=(2, 2, 2),
        pad=(1, 1, 1))),
}


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pooling(case):
    shape, attrs = POOL_CASES[case]
    _compare("Pooling", [_arr(R, *shape)], attrs)


def test_full_convention_adds_the_window_valid_drops():
    x = torch.from_numpy(_arr(R, 1, 1, 8, 8))
    kw = dict(pool_type="max", kernel=(3, 3), stride=(2, 2))
    pool = treg.get("Pooling")
    assert pool(x, **kw).shape == (1, 1, 3, 3)
    assert pool(x, pooling_convention="full", **kw).shape == (1, 1, 4, 4)


BN_CASES = {
    "train_axis1": ((4, 3, 5, 5), 1, dict(fix_gamma=False), True),
    "train_fix_gamma": ((4, 3, 5, 5), 1, dict(fix_gamma=True), True),
    "train_axis3_nhwc": ((4, 5, 5, 3), 3, dict(fix_gamma=False), True),
    "train_axis_neg1": ((4, 5, 5, 3), -1, dict(fix_gamma=False), True),
    "train_2d": ((16, 3), 1, dict(fix_gamma=False), True),
    "train_use_global_stats": ((4, 3, 5, 5), 1,
                               dict(fix_gamma=False, use_global_stats=True),
                               True),
    "eval_axis1": ((4, 3, 5, 5), 1, dict(fix_gamma=False), False),
    "eval_fix_gamma": ((4, 3, 5, 5), 1, dict(fix_gamma=True), False),
    "eval_axis3_nhwc": ((4, 5, 5, 3), 3, dict(fix_gamma=False), False),
}


def _bn_inputs(rng, shape, axis):
    c = shape[axis]
    # data off zero mean and unit variance, so that the statistics matter
    data = rng.randn(*shape).astype(np.float32) * 1.7 + 0.6
    return [data, rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.randn(c).astype(np.float32) * 0.3,
            rng.randn(c).astype(np.float32) * 0.2,
            rng.uniform(0.5, 2.0, c).astype(np.float32)]


@pytest.mark.parametrize("case", sorted(BN_CASES))
def test_batch_norm(case):
    shape, axis, attrs, is_train = BN_CASES[case]
    _compare("BatchNorm", _bn_inputs(R, shape, axis),
             dict(attrs, axis=axis, eps=2e-5, momentum=0.9,
                  is_train=is_train))


@pytest.mark.parametrize("is_train", [True, False])
def test_batch_norm_promotes_integer_input(is_train):
    ins = _bn_inputs(R, (4, 3, 2, 2), 1)
    ins[0] = R.randint(0, 255, (4, 3, 2, 2)).astype(np.int32)
    _compare("BatchNorm", ins, dict(fix_gamma=True, is_train=is_train),
             grad=False)


@pytest.mark.parametrize("axis", [1, 3])
def test_batch_norm_moving_stats_over_three_steps(axis):
    """The aux update ``mm * 0.9 + batch_mean * 0.1`` with the biased
    batch variance, fed back for 3 steps on new batches: torch's own
    running_var update (unbiased, momentum as the new value's weight)
    would differ from the first step."""
    rng = np.random.RandomState(5)
    shape = (6, 4, 3, 3) if axis == 1 else (6, 3, 3, 4)
    data, gamma, beta, mm, mv = _bn_inputs(rng, shape, axis)
    jmm, jmv = jnp.asarray(mm), jnp.asarray(mv)
    tmm, tmv = torch.from_numpy(mm), torch.from_numpy(mv)
    attrs = dict(fix_gamma=False, eps=2e-5, momentum=0.9, axis=axis,
                 is_train=True)
    for step in range(3):
        x = (rng.randn(*shape) * (1 + step) + step).astype(np.float32)
        jo = jreg.get("BatchNorm")(jnp.asarray(x), jnp.asarray(gamma),
                                   jnp.asarray(beta), jmm, jmv, **attrs)
        to = treg.get("BatchNorm")(torch.from_numpy(x),
                                   torch.from_numpy(gamma),
                                   torch.from_numpy(beta), tmm, tmv, **attrs)
        jmm, jmv, tmm, tmv = jo[3], jo[4], to[3], to[4]
        np.testing.assert_allclose(tmm.numpy(), np.asarray(jmm), **TOL)
        np.testing.assert_allclose(tmv.numpy(), np.asarray(jmv), **TOL)
    n = x.size // shape[axis]
    red = tuple(i for i in range(4) if i != axis)
    unbiased = x.var(axis=red) * n / (n - 1)
    assert not np.allclose(unbiased, x.var(axis=red))


@pytest.mark.parametrize("act_type", ["relu", "sigmoid", "tanh", "softrelu",
                                      "softsign"])
def test_activation(act_type):
    _compare("Activation", [_arr(R, 3, 4, 5) * 3], dict(act_type=act_type))


def test_activation_rejects_unknown_type():
    with pytest.raises(ValueError):
        treg.get("Activation")(torch.zeros(2), act_type="swish")


@pytest.mark.parametrize("name,shape", [("Flatten", (2, 3, 4, 5)),
                                        ("flatten", (2, 7)),
                                        ("Flatten", (3, 2, 1, 1)),
                                        ("_copy", (2, 3, 4)),
                                        ("identity", (2, 3))])
def test_flatten_and_identity(name, shape):
    _compare(name, [_arr(R, *shape)], {})


def test_registry_metadata_matches_jax():
    for name in ("Convolution", "Pooling", "BatchNorm", "Activation",
                 "Flatten", "flatten", "_copy", "identity"):
        j, t = jreg.get(name), treg.get(name)
        for f in ("num_outputs", "num_visible", "needs_rng", "num_aux",
                  "takes_is_train", "arg_names", "aux_names", "variadic"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.attr_defaults == j.attr_defaults, name
    # only BatchNorm's data goes to the compute dtype; gamma, beta and the
    # moving statistics keep their fp32 masters
    assert AMP_SPLIT_OPS == {"BatchNorm": (0,)}
