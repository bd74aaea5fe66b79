"""The PyTorch port's optimizers against the JAX package's, step by step
on the same numpy weights and gradients, through each package's updater
(``get_updater``), keyed by parameter name so the lr/wd multipliers
apply (no weight decay on ``*_bias``).

Tolerance: 1e-6 absolute and relative in float32 — the same formulas in
f32, differing only in the order of a few roundings per step (measured
about 1e-7).  With ``multi_precision`` on bf16 weights, the fp32 masters
agree to 1e-6 and the bf16 weights to one bf16 step (2**-8 relative),
since a master near a rounding boundary may round either way."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx

import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ("fc_weight", "fc_bias")


def _data(steps, seed=0):
    rng = np.random.RandomState(seed)
    w = {n: rng.randn(*s).astype(np.float32)
         for n, s in zip(NAMES, ((6, 5), (6,)))}
    grads = [{n: (rng.randn(*w[n].shape) * 3).astype(np.float32)
              for n in NAMES} for _ in range(steps)]
    return w, grads


def _run(pkg, name, params, w, grads, dtype=None):
    ctx = pkg.cpu()
    opt = pkg.optimizer.create(name, param_idx2name={n: n for n in NAMES},
                               **params)
    upd = pkg.optimizer.get_updater(opt)
    weights = {n: pkg.nd.array(v, ctx=ctx, dtype=dtype) for n, v in w.items()}
    for g in grads:
        for n in NAMES:
            upd(n, pkg.nd.array(g[n], ctx=ctx, dtype=dtype), weights[n])
    return ({n: a.asnumpy().astype(np.float32) for n, a in weights.items()},
            {n: [s.asnumpy().astype(np.float32) for s in upd.states[n]]
             for n in NAMES})


CASES = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 0.01,
             "clip_gradient": 2.0, "rescale_grad": 0.5}),
    ("adam", {"learning_rate": 0.01}),
    ("adam", {"learning_rate": 0.01, "beta1": 0.8, "beta2": 0.99,
              "wd": 0.01, "clip_gradient": 1.0, "rescale_grad": 0.25}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(CASES)])
def test_updates_match_jax(name, params):
    w, grads = _data(5)
    jw, jst = _run(mx, name, params, w, grads)
    tw, tst = _run(mt, name, params, w, grads)
    for n in NAMES:
        assert not np.allclose(tw[n], w[n])
        np.testing.assert_allclose(tw[n], jw[n], err_msg=n, **TOL)
        assert len(tst[n]) == len(jst[n])
        for a, b in zip(tst[n], jst[n]):
            np.testing.assert_allclose(a, b, err_msg=n, **TOL)


def test_no_weight_decay_on_bias():
    opt = mt.optimizer.create("sgd", wd=0.1,
                              param_idx2name={n: n for n in NAMES})
    assert opt._get_wd("fc_weight") == pytest.approx(0.1)
    assert opt._get_wd("fc_bias") == 0.0


def test_adam_bias_correction_counts_updates():
    """Adam's t is each weight's own update count: a weight first updated
    after another weight's third update still starts at t = 1, so its
    step equals a fresh optimizer's first step."""
    w, grads = _data(3, seed=2)
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        g0 = grads[0]["fc_weight"]
        opt = pkg.optimizer.create("adam", learning_rate=0.01)
        upd = pkg.optimizer.get_updater(opt)
        a = pkg.nd.array(w["fc_weight"], ctx=ctx)
        b = pkg.nd.array(w["fc_weight"], ctx=ctx)
        for g in grads:
            upd("a", pkg.nd.array(g["fc_weight"], ctx=ctx), a)
        upd("b", pkg.nd.array(g0, ctx=ctx), b)
        assert opt._index_update_count == {"a": 3, "b": 1}
        fresh = pkg.optimizer.get_updater(
            pkg.optimizer.create("adam", learning_rate=0.01))
        c = pkg.nd.array(w["fc_weight"], ctx=ctx)
        fresh("c", pkg.nd.array(g0, ctx=ctx), c)
        np.testing.assert_array_equal(b.asnumpy(), c.asnumpy())
        # the first step moves an element with |g| >> epsilon by about lr
        step = np.abs(b.asnumpy() - w["fc_weight"])[np.abs(g0) > 1e-3]
        np.testing.assert_allclose(step, 0.01, rtol=1e-3)


@pytest.mark.parametrize("name,params", [CASES[1], CASES[3]],
                         ids=["sgd_mom", "adam"])
def test_multi_precision_bf16_matches_jax(name, params):
    w, grads = _data(4, seed=3)
    params = dict(params, multi_precision=True)
    jw, jst = _run(mx, name, params, w, grads, dtype=jnp.bfloat16)
    tw, tst = _run(mt, name, params, w, grads, dtype="bfloat16")
    for n in NAMES:
        # states[0] is the fp32 master copy
        assert len(tst[n]) == len(jst[n]) >= 1
        np.testing.assert_allclose(tst[n][0], jst[n][0], err_msg=n, **TOL)
        np.testing.assert_allclose(tw[n], jw[n], rtol=2 ** -8, atol=2 ** -8,
                                   err_msg=n)
        # the bf16 weight is the rounded master
        np.testing.assert_array_equal(
            tw[n], torch.from_numpy(tst[n][0]).bfloat16().float().numpy())


def test_factor_scheduler_matches_jax():
    lrs = {}
    for pkg in (mx, mt):
        sched = pkg.lr_scheduler.FactorScheduler(step=3, factor=0.5,
                                                 stop_factor_lr=0.02)
        opt = pkg.optimizer.create("sgd", learning_rate=0.2,
                                   lr_scheduler=sched)
        upd = pkg.optimizer.get_updater(opt)
        wt = pkg.nd.array(np.ones(3, np.float32), ctx=pkg.cpu())
        seq = []
        for _ in range(14):
            upd(0, pkg.nd.array(np.ones(3, np.float32), ctx=pkg.cpu()), wt)
            seq.append(opt._get_lr(0))
        lrs[pkg.__name__] = (seq, wt.asnumpy())
    assert lrs["mxnet_tpu_torch"][0] == pytest.approx(lrs["mxnet_tpu"][0])
    assert min(lrs["mxnet_tpu_torch"][0]) == pytest.approx(0.02)
    np.testing.assert_allclose(lrs["mxnet_tpu_torch"][1],
                               lrs["mxnet_tpu"][1], **TOL)
