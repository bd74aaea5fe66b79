"""Every optimizer of the JAX package in the port, against the JAX
package's on the same numpy weights and gradients, through each
package's updater keyed by parameter name (so the lr / wd multipliers
and the no-decay rule for ``*_bias`` apply), over 5 steps with
clipping, gradient rescaling, weight decay and multipliers.

Tolerance: 1e-6 absolute and relative in float32, as for SGD and Adam
(``test_torch_optimizer.py``): the same formulas in f32, differing in
the order of a few roundings a step.  With ``multi_precision`` on bf16
weights the fp32 masters agree to 1e-6 and the bf16 weights to one bf16
step (2**-8 relative).  SGLD draws noise, whose stream is not the JAX
package's: its deterministic part is compared with the noise taken out,
and the noise by its moments."""
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ("fc_weight", "fc_bias", "conv_weight")
SHAPES = ((6, 5), (6,), (4, 3, 2, 2))
COMMON = {"wd": 0.01, "clip_gradient": 2.0, "rescale_grad": 0.5}

CASES = [
    ("nag", {"learning_rate": 0.05}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_weights": 1.5}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.1, "lamda1": 0.05}),
    ("adamax", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}),
    ("signum", {"learning_rate": 0.01}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.0}),
    ("signum", {"learning_rate": 0.01, "wd_lh": 0.05}),
    ("dcasgd", {"learning_rate": 0.05}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("lars", {"learning_rate": 0.1, "eta": 0.01}),
    ("lamb", {"learning_rate": 0.01}),
    ("lamb", {"learning_rate": 0.01, "lower_bound": 0.5,
              "upper_bound": 1.0}),
    ("test", {}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
]
IDS = [f"{n}{i}" for i, (n, _) in enumerate(CASES)]
# the JAX package's Adamax, Nadam and DCASGD override ``update`` and do
# not take the multi-precision state tuple
JAX_NO_MP = {"adamax", "nadam", "dcasgd"}


def _data(steps, seed=0):
    rng = np.random.RandomState(seed)
    w = {n: rng.randn(*s).astype(np.float32) for n, s in zip(NAMES, SHAPES)}
    grads = [{n: (rng.randn(*w[n].shape) * 3).astype(np.float32)
              for n in NAMES} for _ in range(steps)]
    return w, grads


def _updater(pkg, name, params):
    opt = pkg.optimizer.create(name, param_idx2name={n: n for n in NAMES},
                               **params)
    opt.set_lr_mult({"conv_weight": 0.5})
    opt.set_wd_mult({"conv_weight": 2.0})
    return opt, pkg.optimizer.get_updater(opt)


def _np(s):
    return None if s is None else s.asnumpy().astype(np.float32)


def _run(pkg, name, params, w, grads, dtype=None, upd=None):
    ctx = pkg.cpu()
    if upd is None:
        _, upd = _updater(pkg, name, params)
    weights = {n: pkg.nd.array(v, ctx=ctx, dtype=dtype) for n, v in w.items()}
    for g in grads:
        for n in NAMES:
            upd(n, pkg.nd.array(g[n], ctx=ctx, dtype=dtype), weights[n])
    return ({n: a.asnumpy().astype(np.float32) for n, a in weights.items()},
            {n: [_np(s) for s in upd.states[n]] for n in NAMES}, upd)


def _close_states(a, b, **tol):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_allclose(x, y, **tol)


@pytest.mark.parametrize("name,params", CASES, ids=IDS)
def test_updates_match_jax(name, params):
    params = dict(COMMON, **params)
    w, grads = _data(5)
    jw, jst, _ = _run(mx, name, params, w, grads)
    tw, tst, _ = _run(mt, name, params, w, grads)
    for n in NAMES:
        assert not np.allclose(tw[n], w[n]), n
        np.testing.assert_allclose(tw[n], jw[n], err_msg=n, **TOL)
        _close_states(tst[n], jst[n], err_msg=n, **TOL)


@pytest.mark.parametrize("name,params", CASES, ids=IDS)
def test_multi_precision_bf16(name, params):
    """bf16 weights with fp32 masters: the master equals the JAX
    package's (its fp32 run from the bf16-rounded weights and gradients
    where it does not take multi-precision states), and the weight is
    the master rounded to bf16."""
    params = dict(COMMON, **params)
    w, grads = _data(4, seed=3)
    tw, tst, _ = _run(mt, name, dict(params, multi_precision=True), w, grads,
                      dtype="bfloat16")
    if name in JAX_NO_MP:
        def rnd(d):
            return {k: np.asarray(jnp.asarray(v, jnp.bfloat16), np.float32)
                    for k, v in d.items()}
        jw, jst, _ = _run(mx, name, params, rnd(w), [rnd(g) for g in grads])
        jmaster = {n: jw[n] for n in NAMES}
        jrest = jst
    else:
        jw, jst, _ = _run(mx, name, dict(params, multi_precision=True), w,
                          grads, dtype=jnp.bfloat16)
        jmaster = {n: jst[n][0] for n in NAMES}
        jrest = {n: jst[n][1:] for n in NAMES}
    for n in NAMES:
        np.testing.assert_allclose(tst[n][0], jmaster[n], err_msg=n, **TOL)
        _close_states(tst[n][1:], jrest[n], err_msg=n, **TOL)
        np.testing.assert_array_equal(
            tw[n], torch.from_numpy(tst[n][0]).bfloat16().float().numpy())


@pytest.mark.parametrize("name,params", CASES, ids=IDS)
def test_state_blobs_cross_both_ways(name, params):
    """Two steps in one package, its updater's states into the other's,
    three more steps there: equal to five steps in the JAX package."""
    params = dict(COMMON, **params)
    w, grads = _data(5, seed=5)
    jw, _, _ = _run(mx, name, params, w, grads)
    for first, second in ((mx, mt), (mt, mx)):
        w2, _, upd1 = _run(first, name, params, w, grads[:2])
        opt2, upd2 = _updater(second, name, params)
        upd2.set_states(upd1.get_states())
        # the update counts travel with the optimizer, not the blob
        opt2._index_update_count = dict(upd1.optimizer._index_update_count)
        opt2.num_update = upd1.optimizer.num_update
        if name == "nadam":
            opt2.m_schedule = upd1.optimizer.m_schedule
        got, _, _ = _run(second, name, params, w2, grads[2:], upd=upd2)
        for n in NAMES:
            np.testing.assert_allclose(got[n], jw[n], err_msg=n, **TOL)


def test_sgld_deterministic_part_and_noise_moments():
    """SGLD: w' = w - lr/2 (g + wd w) + N(0, sqrt(lr)).  The port's step
    minus the JAX package's noiseless part is the noise: mean 0 and
    standard deviation sqrt(lr) within 5 standard errors over 40000
    draws; the draws follow ``mt.random.seed``."""
    lr, wd = 0.01, 0.1
    rng = np.random.RandomState(0)
    w = rng.randn(200, 200).astype(np.float32)
    g = rng.randn(200, 200).astype(np.float32)
    det = w - lr / 2 * (np.clip(g * 0.5, -2, 2) + wd * w)

    def step(seed):
        mt.random.seed(seed)
        opt = mt.optimizer.create("sgld", learning_rate=lr, wd=wd,
                                  rescale_grad=0.5, clip_gradient=2.0)
        wt = mt.nd.array(w, ctx=mt.cpu())
        mt.optimizer.get_updater(opt)(0, mt.nd.array(g, ctx=mt.cpu()), wt)
        return wt.asnumpy()

    noise = (step(7) - det).ravel()
    n = noise.size
    assert abs(noise.mean()) < 5 * np.sqrt(lr) / np.sqrt(n)
    assert abs(noise.std() - np.sqrt(lr)) < 5 * np.sqrt(lr) / np.sqrt(2 * n)
    np.testing.assert_array_equal(step(7), step(7))
    assert not np.array_equal(step(7), step(8))
    # the JAX package's SGLD has the same deterministic part
    jopt = mx.optimizer.create("sgld", learning_rate=lr, wd=wd,
                               rescale_grad=0.5, clip_gradient=2.0)
    jw = mx.nd.array(w)
    mx.optimizer.get_updater(jopt)(0, mx.nd.array(g), jw)
    jnoise = jw.asnumpy() - det
    assert abs(jnoise.std() - np.sqrt(lr)) < 5 * np.sqrt(lr) / np.sqrt(2 * n)


def test_every_jax_optimizer_name_is_registered():
    from mxnet_tpu.optimizer import _OPT_REGISTRY as jreg
    assert len(jreg._entries) >= 16
    for name in jreg._entries:
        assert isinstance(mt.optimizer.create(name),
                          mt.optimizer.Optimizer), name


def test_lars_lamb_trust_ratio_one_at_zero_norm():
    """A zero weight (or zero gradient) takes a trust ratio of 1."""
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        opt = pkg.optimizer.create("lars", learning_rate=0.1, momentum=0.0)
        w = pkg.nd.array(np.zeros((3, 4), np.float32), ctx=ctx)
        pkg.optimizer.get_updater(opt)(
            0, pkg.nd.array(np.ones((3, 4), np.float32), ctx=ctx), w)
        np.testing.assert_allclose(w.asnumpy(), -0.1, rtol=1e-6)


def test_module_state_files_cross(tmp_path):
    """``save_optimizer_states`` of a LARS and a centered-RMSProp Module
    in one package loads into the other's, state for state."""
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")
    tnet = mt.sym.load_json(net.tojson())
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5).astype(np.float32)
    y = rng.randint(0, 3, 4).astype(np.float32)
    for name, params in (("lars", {"learning_rate": 0.1}),
                         ("rmsprop", {"centered": True})):
        mods = {}
        for pkg, sym in ((mx, net), (mt, tnet)):
            mod = pkg.mod.Module(sym, context=pkg.cpu())
            mod.bind(data_shapes=[("data", (4, 5))],
                     label_shapes=[("softmax_label", (4,))])
            pkg.random.seed(0)
            mod.init_params(pkg.initializer.Constant(0.1))
            mod.init_optimizer(optimizer=name, optimizer_params=params)
            mods[pkg.__name__] = mod
        src = mods["mxnet_tpu"]
        src.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        src.backward()
        src.update()
        f = str(tmp_path / f"{name}.states")
        src.save_optimizer_states(f)
        dst = mods["mxnet_tpu_torch"]
        dst.load_optimizer_states(f)
        with open(f, "rb") as fh:
            want = pickle.load(fh)
        for n, st in want.items():
            got = [s.asnumpy() for s in dst._updater.states[n]]
            assert len(got) == len(st)
            for a, b in zip(got, st):
                np.testing.assert_array_equal(a, np.asarray(b))
        back = str(tmp_path / f"{name}_back.states")
        dst.save_optimizer_states(back)
        src.load_optimizer_states(back)
        for n, st in want.items():
            for a, b in zip(src._opt_states[n], st):
                np.testing.assert_array_equal(a.asnumpy(), np.asarray(b))
