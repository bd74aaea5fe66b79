"""The transformer LM slice end to end: a 2-layer, d=32, 4-head LM with
grouped-query attention (2 KV heads), seq 16, vocab 50, through the JAX
package's ``build_interpreter`` and the port's, with the port's weights
carried over by ``params_from_numpy``.

Tolerances, in log-probability (the output is a softmax over the vocab):
* float32: 1e-5 — both compute in f32 and differ only in summation order
  (measured about 1e-6);
* bfloat16 ``compute_dtype``: 0.1 — both cast every op input to bf16
  (8-bit mantissa, 2**-8 relative) but round at different points inside
  fused ops (the JAX side fuses under XLA, the port runs op by op), so
  single elements differ by a few bf16 ulps after two layers (measured
  about 0.03)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import models as jmodels
from mxnet_tpu.executor import build_interpreter as jbuild

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_interpreter as tbuild

V, S, B = 50, 16, 3
KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2)
LOGP_TOL = {None: 1e-5, "bfloat16": 0.1}


def _setup(pos_type, seed=0):
    jnet = jmodels.transformer_lm(V, S, pos_type=pos_type, **KW)
    tnet = mt.models.transformer_lm(V, S, pos_type=pos_type, **KW)
    shapes = dict(zip(jnet.list_arguments(),
                      jnet.infer_shape(data=(B, S),
                                       softmax_label=(B, S))[0]))
    rng = np.random.RandomState(seed)
    params = {n: (rng.randn(*s) * 0.3).astype(np.float32)
              for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    data = rng.randint(0, V, (B, S)).astype(np.float32)
    lab = np.zeros((B, S), np.float32)
    return jnet, tnet, params, data, lab


def _jax_forward(jnet, params, data, lab, cd):
    run, names, _ = jbuild(jnet, jnp.bfloat16 if cd else None)
    vals = [jnp.asarray(data if n == "data" else lab
                        if n == "softmax_label" else params[n])
            for n in names]
    out = run(vals, [], jax.random.PRNGKey(0), False)[0][0]
    return np.asarray(out, dtype=np.float32)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("pos_type", ["learned", "rope"])
def test_lm_forward_matches_jax(pos_type, cd):
    jnet, tnet, params, data, lab = _setup(pos_type)
    ref = _jax_forward(jnet, params, data, lab, cd)
    args, aux = mt.params_from_numpy(
        params, {}, mt.cpu(), tnet,
        {"data": (B, S), "softmax_label": (B, S)})
    assert aux == {} and all(t.device.type == "cpu" for t in args.values())
    run, names, _ = tbuild(tnet, cd)
    vals = [torch.from_numpy(data) if n == "data"
            else torch.from_numpy(lab) if n == "softmax_label"
            else args[n] for n in names]
    outs, new_aux = run(vals, [])
    out = outs[0].float().numpy()
    assert out.shape == ref.shape == (B * S, V) and new_aux == ()
    assert outs[0].dtype == torch.float32   # SoftmaxOutput stays f32
    np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-5)
    diff = np.abs(np.log(out) - np.log(ref)).max()
    assert diff <= LOGP_TOL[cd], diff


def test_params_from_numpy_checks_names_and_shapes():
    _, tnet, params, _, _ = _setup("learned")
    shapes = {"data": (B, S), "softmax_label": (B, S)}
    missing = dict(params)
    missing.pop("layer0_qkv_bias")
    with pytest.raises(mt.MXNetError, match="missing.*layer0_qkv_bias"):
        mt.params_from_numpy(missing, {}, mt.cpu(), tnet, shapes)
    extra = dict(params, bogus_weight=np.zeros(3, np.float32))
    with pytest.raises(mt.MXNetError, match="extra.*bogus_weight"):
        mt.params_from_numpy(extra, {}, mt.cpu(), tnet, shapes)
    bad = dict(params, lm_head_weight=params["lm_head_weight"].T.copy())
    with pytest.raises(mt.MXNetError, match="lm_head_weight.*shape"):
        mt.params_from_numpy(bad, {}, mt.cpu(), tnet, shapes)
    with pytest.raises(mt.MXNetError, match="auxiliary"):
        mt.params_from_numpy(params, {"moving_mean": np.zeros(1)},
                             mt.cpu(), tnet, shapes)


def test_interpreter_refuses_rng_ops():
    """The interpreter refuses to run an op that draws random numbers
    without a ``generator`` (torch's default one is not seeded by
    ``mt.random.seed``); given one (an Executor's ``torch.Generator``), it
    hands it to the op."""
    from mxnet_tpu_torch.ops import registry as treg
    from mxnet_tpu_torch.symbol.symbol import _compose
    if treg.find("_test_rng_op") is None:
        treg.register("_test_rng_op", arg_names=["data"], needs_rng=True)(
            lambda data, generator=None, **kw:
            data + torch.rand(data.shape, generator=generator))
    net = _compose("_test_rng_op", [mt.sym.Variable("x")], {}, None)
    run, _, _ = tbuild(net)
    assert run.needs_rng
    x = torch.zeros(4)
    with pytest.raises(mt.MXNetError, match="_test_rng_op.*generator="):
        run([x], [])
    draws = [run([x], [], generator=torch.Generator().manual_seed(3))[0][0]
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], x)
    assert not tbuild(mt.sym.Variable("x") * 2.0)[0].needs_rng
