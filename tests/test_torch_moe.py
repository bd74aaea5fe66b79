"""The mixture-of-experts FFN (``_contrib_MoE``) of the PyTorch port
against the JAX package: the op, the MoE transformer LM through
``Module``, its decode step, a JAX MoE checkpoint in the port, and the
JAX package's bf16 routing fault (ROADMAP §3).

The port routes by indices (a gather into an (E, C, d) buffer, an
``index_add`` back) where the JAX package builds (T, E, C) one-hot
tensors; the function is the same.  Tolerances (float32): the op's
outputs within 1e-5 relative and 1e-6 absolute, its gradients (of order
1 to 5, sums over 48 tokens) within 1e-5 of both kinds (both packages
sum the same products in other orders; measured up to 1.2e-6);
the LM's loss and gradients within 1e-4 relative and 1e-6 absolute, as
``test_torch_module.py`` holds the dense LM; the routing itself exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.ops import moe as jmoe

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import moe as tmoe
import torch_threads  # noqa: F401,E402  a worker's share of the cores

T, D, F, E = 48, 16, 24, 4


def _op_inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) * sc
            for s, sc in (((T, D), 1.0), ((D, E), 1.0), ((E, D, F), 0.3),
                          ((E, F), 0.1), ((E, F, D), 0.3), ((E, D), 0.1))]


@pytest.mark.parametrize("k,activation,cf", [
    (1, "relu", 2.0), (2, "gelu", 2.0), (1, "gelu", 0.5), (2, "relu", 0.5)],
    ids=["k1-relu", "k2-gelu", "k1-gelu-drops", "k2-relu-drops"])
def test_op_forward_and_vjp_match_jax(k, activation, cf):
    """Capacity factor 0.5 drops tokens (checked); both activations, k 1
    and 2; every input's gradient against ``jax.vjp``."""
    args = _op_inputs(k)
    want, vjp = jax.vjp(
        lambda *a: jmoe.moe_ffn(*a, E, k, cf, activation),
        *map(jnp.asarray, args))
    g = np.random.default_rng(9).standard_normal(want.shape).astype(
        np.float32)
    want_g = vjp(jnp.asarray(g))
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    stats = {}
    got = tmoe.moe_ffn(*ts, E, k, cf, activation, stats=stats)
    got.backward(torch.tensor(g))
    assert (stats["dropped"] > 0) == (cf < 1), stats["dropped"]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    for t, w, name in zip(ts, want_g, ("data", "gate", "w1", "b1", "w2",
                                       "b2")):
        if k == 1 and name == "gate":   # rounding noise in both packages
            continue                    # (test_top1_router_gets_no_...)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("k", [1, 2])
def test_routing_equals_the_jax_dispatch_tensor(k):
    """Each kept (token, expert) pair sits in the slot where the JAX
    package's dispatch tensor puts it; a dropped one nowhere; and the
    gates equal the combine weights."""
    x, gw = _op_inputs(3)[:2]
    logits = x @ gw
    C = tmoe.capacity_of(T, k, E, 0.5)
    dispatch, combine = jmoe._top_k_gating(jnp.asarray(logits), k, C)
    dispatch, combine = np.asarray(dispatch), np.asarray(combine)
    experts, slots, keep, gates = tmoe.top_k_route(torch.tensor(logits),
                                                   k, C)
    mine = np.zeros_like(dispatch)
    weight = np.zeros_like(combine)
    for t in range(T):
        for j in range(k):
            if keep[t, j]:
                mine[t, experts[t, j], slots[t, j]] = 1.0
                weight[t, experts[t, j], slots[t, j]] = gates[t, j]
    np.testing.assert_array_equal(mine, dispatch)
    np.testing.assert_allclose(weight, combine, rtol=1e-6, atol=0)
    assert not keep.all()


def test_top1_router_gets_no_gradient_in_either_package():
    """At k = 1 the renormalised gate is p / p = 1, so no gradient
    reaches the gate weight through it (the dispatch is a choice, not a
    function of the weight): in both packages only the rounding of the
    division's two cancelling terms is left, about 1e-6 here against
    expert gradients of order 1.  Kept as the JAX package has it, not
    "fixed"."""
    args = _op_inputs(5)
    _, vjp = jax.vjp(lambda *a: jmoe.moe_ffn(*a, E, 1, 2.0, "gelu"),
                     *map(jnp.asarray, args))
    gate_j = np.asarray(vjp(jnp.ones((T, D), jnp.float32))[1])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    tmoe.moe_ffn(*ts, E, 1, 2.0, "gelu").sum().backward()
    assert np.abs(ts[1].grad.numpy()).max() <= 1e-5
    assert np.abs(gate_j).max() <= 1e-5
    assert np.abs(ts[2].grad.numpy()).max() > 1e-3   # the experts learn


def test_op_through_nd_and_autograd():
    """``nd.contrib.MoE`` imperatively under ``autograd.record()``; its
    ``num_experts`` defaults to the gate's width."""
    args = _op_inputs(6)
    with mt.cpu():
        nds = [mt.nd.array(a) for a in args]
        for a in nds:
            a.attach_grad()
        with mt.autograd.record():
            y = mt.nd.contrib.MoE(*nds, k=2, activation="gelu")
        y.backward()
    want = jmoe.moe_ffn(*map(jnp.asarray, args), E, 2, 2.0, "gelu")
    np.testing.assert_allclose(y.asnumpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert np.abs(nds[1].grad.asnumpy()).max() > 0


# --------------------------------------------------------------------------
# the MoE transformer LM
# --------------------------------------------------------------------------
V, S, B = 40, 8, 3
LM = dict(num_layers=2, d_model=16, num_heads=2, moe_experts=E, moe_k=2)


def _lm_params(net, seed=0, scale=0.3):
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(B, S), softmax_label=(B, S))[0]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("loss_type", ["softmax", "chunked_ce"])
def test_moe_lm_step_through_module_matches_jax(loss_type):
    """The JAX graph's names (``layer{i}_gate_weight``,
    ``layer{i}_expert_w1_weight``, ..., ``lm_head_weight``) and shapes,
    then one forward and backward through ``Module``: outputs and every
    parameter's gradient."""
    kw = dict(LM, loss_type=loss_type, ce_chunks=3)
    jnet = jmodels.transformer_lm(V, S, **kw)
    tnet = mt.models.transformer_lm(V, S, **kw)
    assert tnet.list_arguments() == jnet.list_arguments()
    params = _lm_params(jnet)
    assert "layer1_expert_w2_weight" in params
    rng = np.random.RandomState(1)
    x = rng.randint(0, V, (B, S)).astype(np.int32)
    y = rng.randint(0, V, (B, S)).astype(np.int32)
    res = {}
    for name, pkg, net in (("jax", mx, jnet), ("port", mt, tnet)):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[pkg.io.DataDesc("data", (B, S), np.int32)],
                 label_shapes=[pkg.io.DataDesc("softmax_label", (B, S),
                                               np.int32)])
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                     [pkg.nd.array(y, ctx=ctx)]),
                    is_train=True)
        mod.backward()
        res[name] = (mod.get_outputs()[0].asnumpy(),
                     {n: mod._exec.grad_dict[n].asnumpy() for n in params})
    np.testing.assert_allclose(res["port"][0], res["jax"][0], rtol=1e-4,
                               atol=1e-6)
    for n in params:
        np.testing.assert_allclose(res["port"][1][n], res["jax"][1][n],
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    assert np.abs(res["port"][1]["layer0_gate_weight"]).max() > 0


def _decode_module(pkg, params, Bd):
    dec = (jmodels if pkg is mx else mt.models).transformer_decode_step(
        V, S, Bd, **LM)
    names = [f"layer{i}_{kv}_cache" for i in range(LM["num_layers"])
             for kv in ("k", "v")] + ["cur_pos"]
    dmod = pkg.mod.Module(dec, context=pkg.cpu(), data_names=("data",),
                          label_names=None, state_names=names)
    dmod.bind(data_shapes=[("data", (Bd,))], for_training=False)
    dmod.init_params(arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                                 for n, v in params.items()})
    dmod.set_states(value=0)
    return dmod


def test_moe_decode_step_matches_jax_and_the_teacher_forced_lm():
    """The MoE decode step (B = 3 tokens a call: capacity 3 an expert, so
    no token is dropped; nor in the LM's 24-token calls) equals the JAX
    package's decode step at every step, and the port's LM's
    teacher-forced distributions."""
    net = mt.models.transformer_lm(V, S, **LM)
    params = _lm_params(net, seed=4)
    toks = np.random.RandomState(5).randint(0, V, (B, S)).astype(np.float32)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B, S))], for_training=False)
    mod.init_params(arg_params=params)
    with tmoe.collect_routing() as lm_stats:
        mod.forward(mt.io.DataBatch([mt.nd.array(toks, ctx=mt.cpu())],
                                    [mt.nd.zeros((B, S), ctx=mt.cpu())]),
                    is_train=False)
    assert lm_stats["dropped"] == 0
    probs = mod.get_outputs()[0].asnumpy().reshape(B, S, V)
    dmods = {pkg: _decode_module(pkg, params, B) for pkg in (mx, mt)}
    with tmoe.collect_routing() as dec_stats:
        for t in range(S):
            out = {}
            for pkg, dmod in dmods.items():
                dmod.forward(pkg.io.DataBatch(
                    [pkg.nd.array(toks[:, t], ctx=pkg.cpu())], []))
                res = dmod.get_outputs()
                dmod.set_states(states=res[1:])
                out[pkg] = res[0].asnumpy()
            np.testing.assert_allclose(out[mt], out[mx], rtol=1e-4,
                                       atol=1e-5, err_msg=f"step {t}")
            e = np.exp(out[mt] - out[mt].max(1, keepdims=True))
            np.testing.assert_allclose(e / e.sum(1, keepdims=True),
                                       probs[:, t], atol=2e-5,
                                       err_msg=f"position {t}")
    assert dec_stats["dropped"] == 0 and dec_stats["capacity"] == 3


def test_jax_moe_checkpoint_loads_into_the_port(tmp_path):
    """A JAX MoE LM checkpoint (expert weights of three dimensions
    included) loads into the port's Module unchanged, and the port's
    forward equals the JAX Module's."""
    jnet = jmodels.transformer_lm(V, S, **LM)
    jmod = mx.mod.Module(jnet, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (B, S))],
              label_shapes=[("softmax_label", (B, S))], for_training=False)
    mx.random.seed(3)
    jmod.init_params(mx.initializer.Xavier())
    prefix = str(tmp_path / "moe")
    jmod.save_checkpoint(prefix, 1)
    tnet, args, auxs = mt.model.load_checkpoint(prefix, 1)
    targs, taux = mt.params_from_numpy(
        {n: a.asnumpy() for n, a in args.items()},
        {n: a.asnumpy() for n, a in auxs.items()}, mt.cpu(), tnet,
        {"data": (B, S), "softmax_label": (B, S)})
    assert targs["layer0_expert_w1_weight"].shape == (E, 16, 64)
    tmod = mt.mod.Module(tnet, context=mt.cpu())
    tmod.bind(data_shapes=[("data", (B, S))],
              label_shapes=[("softmax_label", (B, S))], for_training=False)
    tmod.init_params(arg_params=targs, aux_params=taux)
    x = np.random.RandomState(2).randint(0, V, (B, S)).astype(np.float32)
    outs = []
    for pkg, m in ((mx, jmod), (mt, tmod)):
        m.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())],
                                   [pkg.nd.zeros((B, S), ctx=pkg.cpu())]),
                  is_train=False)
        outs.append(m.get_outputs()[0].asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-4, atol=1e-6)


# --------------------------------------------------------------------------
# the JAX package's bf16 routing fault
# --------------------------------------------------------------------------
def test_jax_bf16_slots_collide_past_256_tokens_an_expert_the_port_never():
    """Reference fault (ROADMAP §3): the JAX op counts each token's slot
    as ``cumsum(mask) * mask - 1`` in the gates' dtype; under bf16 that
    count is exact only to 256, so past 256 tokens an expert several
    tokens land in one slot and the dispatch einsum adds them into one
    expert input.  Here 1024 tokens over 2 experts (k 1, capacity 1024):
    the JAX op in bf16 puts more than one token in some slots and uses
    fewer slots than tokens; in float32 it puts one token a slot, and the
    port's integer count puts one token a slot at either dtype and
    equals the JAX float32 routing exactly."""
    Tn, En = 1024, 2
    logits = np.random.default_rng(0).standard_normal((Tn, En)).astype(
        np.float32)
    C = tmoe.capacity_of(Tn, 1, En)
    per_slot = {}
    for dt in ("float32", "bfloat16"):
        dispatch, _ = jmoe._top_k_gating(
            jnp.asarray(logits, getattr(jnp, dt)), 1, C)
        per_slot[dt] = np.asarray(dispatch, np.float32).sum(axis=0)
    assert per_slot["float32"].max() == 1
    assert per_slot["float32"].sum() == Tn
    assert per_slot["bfloat16"].max() > 1                   # collisions
    assert (per_slot["bfloat16"] > 0).sum() < Tn            # slots used
    for dt in (torch.float32, torch.bfloat16):
        experts, slots, keep, _ = tmoe.top_k_route(
            torch.tensor(logits).to(dt), 1, C)
        flat = (experts * C + slots)[keep]
        assert keep.all() and flat.unique().numel() == Tn, dt
        if dt == torch.float32:
            mine = np.zeros((En, C), np.float32)
            mine[experts[:, 0].numpy(), slots[:, 0].numpy()] = 1
            np.testing.assert_array_equal(mine, per_slot["float32"])
