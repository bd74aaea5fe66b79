"""The optimizer update ops (``sgd_update``, ``sgd_mom_update``,
``mp_sgd_update``, ``mp_sgd_mom_update``, ``adam_update``,
``rmsprop_update``, ``rmspropalex_update``, ``ftrl_update``,
``signsgd_update``) of the PyTorch port against the JAX package's, and
``sgd_mom_update`` / ``adam_update`` against the port's own
``optimizer.SGD`` / ``Adam``.

Every op runs with weight decay, ``rescale_grad`` and ``clip_gradient``
(which clips some of the gradients here), on the same float32 inputs in
both packages.  Tolerance 1e-6 relative and absolute: the same
elementwise formulas in float32, which may round a square root or a
division differently by an ulp (measured at most 1.2e-7).  Against the
port's optimizers: ``sgd_mom_update`` bit for bit (the same operations);
``adam_update`` within 1e-6 (Adam forms ((1 - beta2) g) g, the op
(1 - beta2) g^2, one rounding apart; measured 3e-8)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (6, 7)
CPU = mt.cpu()
COMMON = dict(wd=0.01, rescale_grad=0.5, clip_gradient=0.6)

# op, state inputs (after weight and grad), attributes
OPS = {
    "sgd_update": ([], dict(lr=0.1)),
    "sgd_mom_update": (["mom"], dict(lr=0.1, momentum=0.9)),
    "adam_update": (["mean", "var"], dict(lr=0.01, beta1=0.8, beta2=0.95,
                                          epsilon=1e-6)),
    "rmsprop_update": (["n"], dict(lr=0.01, gamma1=0.9, epsilon=1e-6,
                                   clip_weights=0.8)),
    "rmspropalex_update": (["n", "g", "delta"],
                           dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6, clip_weights=0.8)),
    "ftrl_update": (["z", "n"], dict(lr=0.1, lamda1=0.05, beta=1.0)),
    "signsgd_update": ([], dict(lr=0.1)),
}


def _arrays(names, seed):
    rng = np.random.default_rng(seed)
    out = {"weight": rng.uniform(-1, 1, SHAPE).astype(np.float32),
           "grad": rng.uniform(-2, 2, SHAPE).astype(np.float32)}
    for n in names:   # states that keep the formulas' square roots real
        out[n] = rng.uniform(0.0, 0.5, SHAPE).astype(np.float32)
    if "delta" in names:
        out["g"] = rng.uniform(-0.1, 0.1, SHAPE).astype(np.float32)
    return out


@pytest.mark.parametrize("op", sorted(OPS))
def test_update_op_matches_jax(op):
    states, attrs = OPS[op]
    arrays = _arrays(states, sorted(OPS).index(op))
    inputs = [arrays[n] for n in ["weight", "grad"] + states]
    want = getattr(mx.nd, op)(*map(mx.nd.array, inputs), **attrs, **COMMON)
    got = getattr(mt.nd, op)(*(mt.nd.array(a, ctx=CPU) for a in inputs),
                             **attrs, **COMMON)
    want = want if isinstance(want, list) else [want]
    got = got if isinstance(got, list) else [got]
    assert len(got) == len(want) == 1 + len(states)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=1e-6,
                                   atol=1e-6)
    assert not np.array_equal(got[0].asnumpy(), arrays["weight"])


@pytest.mark.parametrize("op", ["mp_sgd_update", "mp_sgd_mom_update"])
def test_mixed_precision_ops_update_the_fp32_master(op):
    """A bf16 weight and gradient with an fp32 master copy: the master
    moves in fp32 and the weight comes back as the master rounded to
    bf16, as in the JAX package."""
    arrays = _arrays(["mom"], 11)
    w32 = arrays["weight"]
    mom = [arrays["mom"]] if op == "mp_sgd_mom_update" else []
    attrs = dict(lr=0.1, **COMMON)
    if mom:
        attrs["momentum"] = 0.9
    jw = mx.nd.array(w32).astype(jnp.bfloat16)
    jg = mx.nd.array(arrays["grad"]).astype(jnp.bfloat16)
    want = getattr(mx.nd, op)(jw, jg, *map(mx.nd.array, mom),
                              mx.nd.array(w32), **attrs)
    tw = mt.nd.array(w32, ctx=CPU).astype("bfloat16")
    tg = mt.nd.array(arrays["grad"], ctx=CPU).astype("bfloat16")
    got = getattr(mt.nd, op)(tw, tg, *(mt.nd.array(m, ctx=CPU)
                                       for m in mom),
                             mt.nd.array(w32, ctx=CPU), **attrs)
    assert got[0].dtype == "bfloat16" and got[-1].dtype == np.float32
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy().astype(np.float32),
                                   np.asarray(w.asnumpy(), np.float32),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        got[0].asnumpy().astype(np.float32),
        torch.tensor(got[-1].asnumpy()).bfloat16().float().numpy())


def test_out_writes_the_new_weight_into_the_weight():
    arrays = _arrays([], 12)
    w = mt.nd.array(arrays["weight"], ctx=CPU)
    ret = mt.nd.sgd_update(w, mt.nd.array(arrays["grad"], ctx=CPU),
                           out=w, lr=0.1)
    assert ret is w
    np.testing.assert_allclose(
        w.asnumpy(), arrays["weight"] - 0.1 * arrays["grad"], rtol=1e-6)


def _optimizer_steps(opt, steps, arrays):
    w = mt.nd.array(arrays["weight"], ctx=CPU)
    state = opt.create_state(0, w)
    for _ in range(steps):
        opt.update(0, w, mt.nd.array(arrays["grad"], ctx=CPU), state)
    return w.asnumpy()


def test_sgd_mom_update_equals_the_sgd_optimizer():
    arrays = _arrays(["mom"], 13)
    kw = dict(learning_rate=0.1, momentum=0.9, wd=0.01, rescale_grad=0.5,
              clip_gradient=0.6)
    want = _optimizer_steps(mt.optimizer.SGD(**kw), 3, arrays)
    w = mt.nd.array(arrays["weight"], ctx=CPU)
    mom = mt.nd.zeros(SHAPE, ctx=CPU)
    for _ in range(3):
        w, mom = mt.nd.sgd_mom_update(
            w, mt.nd.array(arrays["grad"], ctx=CPU), mom, lr=0.1,
            momentum=0.9, wd=0.01, rescale_grad=0.5, clip_gradient=0.6)
    np.testing.assert_array_equal(w.asnumpy(), want)


def test_adam_update_with_the_bias_corrected_lr_equals_adam():
    """``adam_update`` applies no bias correction; given Adam's
    ``lr * sqrt(1 - beta2**t) / (1 - beta1**t)`` (in float32) at each
    step t it gives the port's ``optimizer.Adam``."""
    arrays = _arrays([], 14)
    kw = dict(learning_rate=0.01, beta1=0.8, beta2=0.95, epsilon=1e-6,
              wd=0.01, rescale_grad=0.5, clip_gradient=0.6)
    want = _optimizer_steps(mt.optimizer.Adam(**kw), 3, arrays)
    w = mt.nd.array(arrays["weight"], ctx=CPU)
    mean, var = mt.nd.zeros(SHAPE, ctx=CPU), mt.nd.zeros(SHAPE, ctx=CPU)
    one = np.float32(1.0)
    for t in range(1, 4):
        lr = float(np.float32(0.01) * np.sqrt(one - np.float32(0.95) ** t)
                   / (one - np.float32(0.8) ** t))
        w, mean, var = mt.nd.adam_update(
            w, mt.nd.array(arrays["grad"], ctx=CPU), mean, var, lr=lr,
            beta1=0.8, beta2=0.95, epsilon=1e-6, wd=0.01, rescale_grad=0.5,
            clip_gradient=0.6)
    np.testing.assert_allclose(w.asnumpy(), want, rtol=1e-6, atol=1e-6)
