"""The port's training IO against the JAX package's: ``NDArrayIter``
batches, pads and shuffle order under the same ``np.random.seed``; the
metrics on the same arrays; the initializers by statistics and by their
name rules.

Tolerances: batches are compared exactly (the same numpy slicing);
metrics 1e-5 relative (sums of f32 logs, in f64 on the port's side and
f32 on the JAX side); initializer variances 3% (a 512 x 256 sample's
variance has a relative standard deviation of sqrt(2 / 131072), 0.4%,
so 3% is more than seven of them)."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt


def _iter_batches(pkg, data, label, **kw):
    it = pkg.io.NDArrayIter(data, label, **kw)
    out = []
    for epoch in range(2):
        it.reset()
        for b in it:
            out.append(([d.asnumpy() for d in b.data],
                        [l.asnumpy() for l in b.label], b.pad))
    return it, out


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
def test_ndarray_iter_matches_jax(handle, shuffle):
    rng = np.random.RandomState(0)
    data = rng.randint(0, 100, (23, 5)).astype(np.int32)
    label = rng.randint(0, 10, (23,)).astype(np.float32)
    res = {}
    for pkg in (mx, mt):
        np.random.seed(4)
        res[pkg.__name__] = _iter_batches(pkg, data, label, batch_size=6,
                                          shuffle=shuffle,
                                          last_batch_handle=handle)
    (jit, jb), (tit, tb) = res["mxnet_tpu"], res["mxnet_tpu_torch"]
    assert len(tb) == len(jb) > 0
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert tp == jp
        np.testing.assert_array_equal(td[0], jd[0])
        np.testing.assert_array_equal(tl[0], jl[0])
        assert td[0].dtype == np.int32      # ids stay int32
    assert [(d.name, d.shape) for d in tit.provide_data] == \
        [(d.name, d.shape) for d in jit.provide_data]
    assert tit.provide_data[0].dtype == np.int32
    assert [(d.name, d.shape) for d in tit.provide_label] == \
        [(d.name, d.shape) for d in jit.provide_label]


def test_ndarray_iter_dict_inputs_and_cpu_batches():
    it = mt.io.NDArrayIter({"data": np.zeros((4, 3), np.float64)},
                           {"softmax_label": np.zeros(4)}, batch_size=2)
    b = next(it)
    assert b.data[0].dtype == np.float32       # float64 becomes float32
    assert b.data[0].context == mt.cpu()
    assert [d.name for d in it.provide_data] == ["data"]
    with pytest.raises(ValueError, match="batch_size"):
        mt.io.NDArrayIter(np.zeros((2, 3)), batch_size=4)


def _metric_inputs(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(40, 7).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    labels = rng.randint(0, 7, (40,)).astype(np.float32)
    labels[::9] = 3
    return probs.astype(np.float32), labels


@pytest.mark.parametrize("name,kwargs", [
    ("acc", {}), ("ce", {}), ("loss", {}),
    ("perplexity", {"ignore_label": None}),
    ("perplexity", {"ignore_label": 3}),
])
def test_metrics_match_jax(name, kwargs):
    probs, labels = _metric_inputs()
    vals = {}
    for pkg in (mx, mt):
        m = pkg.metric.create(name, **kwargs)
        for lo in (0, 16):    # two batches
            sl = slice(lo, lo + 24)
            m.update([pkg.nd.array(labels[sl], ctx=pkg.cpu())],
                     [pkg.nd.array(probs[sl], ctx=pkg.cpu())])
        vals[pkg.__name__] = m.get()
    (tn, tv), (jn, jv) = vals["mxnet_tpu_torch"], vals["mxnet_tpu"]
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-5)


def test_composite_metric_and_update_dict():
    probs, labels = _metric_inputs(1)
    vals = {}
    for pkg in (mx, mt):
        m = pkg.metric.create(["acc", "ce"])
        m.update_dict({"softmax_label": pkg.nd.array(labels, ctx=pkg.cpu())},
                      {"softmax_output": pkg.nd.array(probs,
                                                      ctx=pkg.cpu())})
        vals[pkg.__name__] = m.get_name_value()
    t, j = vals["mxnet_tpu_torch"], vals["mxnet_tpu"]
    assert [n for n, _ in t] == [n for n, _ in j] == ["accuracy",
                                                     "cross-entropy"]
    np.testing.assert_allclose([v for _, v in t], [v for _, v in j],
                               rtol=1e-5)
    m = mt.metric.create("acc")
    assert np.isnan(m.get()[1])   # no data yet, as the JAX package


@pytest.mark.parametrize("rnd_type,factor_type,magnitude", [
    ("gaussian", "avg", 2.0), ("uniform", "avg", 3.0),
    ("gaussian", "in", 2.0), ("uniform", "out", 1.0)])
def test_xavier_variance(rnd_type, factor_type, magnitude):
    fan_out, fan_in = 512, 256
    mt.random.seed(11)
    arr = mt.nd.zeros((fan_out, fan_in), ctx=mt.cpu())
    mt.initializer.Xavier(rnd_type=rnd_type, factor_type=factor_type,
                          magnitude=magnitude)(
        mt.initializer.InitDesc("fc_weight"), arr)
    x = arr.asnumpy()
    factor = {"avg": (fan_in + fan_out) / 2, "in": fan_in,
              "out": fan_out}[factor_type]
    scale = np.sqrt(magnitude / factor)
    want = scale ** 2 if rnd_type == "gaussian" else scale ** 2 / 3
    assert abs(x.var() / want - 1) < 0.03
    assert abs(x.mean()) < 5 * np.sqrt(want / x.size)
    if rnd_type == "uniform":
        assert np.abs(x).max() <= scale
    # same seed, same draw; the next draw differs
    mt.random.seed(11)
    again = mt.nd.zeros((fan_out, fan_in), ctx=mt.cpu())
    mt.initializer.Xavier(rnd_type=rnd_type, factor_type=factor_type,
                          magnitude=magnitude)("fc_weight", again)
    np.testing.assert_array_equal(again.asnumpy(), x)


NAMES = ["fc_weight", "fc_bias", "ln_gamma", "ln_beta", "bn_moving_mean",
         "bn_moving_var", "q_min", "q_max", "pos_embed_weight"]


def test_name_rules_match_jax():
    """The same name-to-rule dispatch as the JAX package's Initializer:
    Constant(0.5) fills weights and follows the name rules elsewhere."""
    for name in NAMES:
        got = {}
        for pkg in (mx, mt):
            arr = pkg.nd.zeros((3, 4), ctx=pkg.cpu()) if name.endswith(
                "weight") else pkg.nd.array(np.full(4, 7.0, np.float32),
                                            ctx=pkg.cpu())
            pkg.initializer.Constant(0.5)(
                pkg.initializer.InitDesc(name), arr)
            got[pkg.__name__] = arr.asnumpy()
        np.testing.assert_array_equal(got["mxnet_tpu_torch"],
                                      got["mxnet_tpu"], err_msg=name)
    for pkg in (mx, mt):
        with pytest.raises(ValueError, match="Unknown initialization"):
            pkg.initializer.Constant(0.5)(
                pkg.initializer.InitDesc("mystery"),
                pkg.nd.zeros((2,), ctx=pkg.cpu()))


def test_init_params_fills_by_name_and_keeps_dtype():
    net = mt.models.transformer_lm(20, 4, num_layers=1, d_model=8,
                                   num_heads=2)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[mt.io.DataDesc("data", (2, 4), np.int32)],
             label_shapes=[("softmax_label", (2, 4))])
    mod.init_params(mt.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    args, _ = mod.get_params()
    assert mod._exec.arg_dict["data"].as_torch().dtype == torch.int32
    for name, arr in args.items():
        x = arr.asnumpy()
        assert arr.as_torch().dtype == torch.float32, name
        if name.endswith(("_bias", "_beta")):
            assert not x.any(), name
        elif name.endswith("_gamma"):
            assert (x == 1).all(), name
        else:
            assert x.std() > 0, name
    with pytest.raises(ValueError, match="extra"):
        mod.init_params(arg_params={"bogus": np.zeros(2)}, force_init=True)
