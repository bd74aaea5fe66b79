"""Symbol graph of the PyTorch port against the JAX package: the same
``transformer_lm`` has the same arguments and inferred shapes in both,
and symbol JSON saved by either package loads in the other."""
import numpy as np
import pytest
import torch

from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.executor import build_interpreter as jbuild
import jax
import jax.numpy as jnp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.executor import build_interpreter as tbuild

V, S = 50, 16
VARIANTS = {
    "learned": dict(num_layers=2, d_model=32, num_heads=4),
    "gqa_rope": dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                     pos_type="rope"),
    "mqa_swiglu": dict(num_layers=1, d_model=32, num_heads=4,
                       num_kv_heads=1, ffn_type="swiglu", d_ff=48,
                       max_len=24),
}


def _shapes(net, B=3):
    return net.infer_shape(data=(B, S), softmax_label=(B, S))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_same_arguments_and_inferred_shapes(variant):
    kw = VARIANTS[variant]
    jnet = jmodels.transformer_lm(V, S, **kw)
    tnet = mt.models.transformer_lm(V, S, **kw)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.list_outputs() == jnet.list_outputs()
    ja, jo, jx = _shapes(jnet)
    ta, to, tx = _shapes(tnet)
    assert ta == [tuple(s) for s in ja]
    assert to == [tuple(s) for s in jo] == [(3 * S, V)]
    assert tx == [tuple(s) for s in jx]


def _forward(build, net, params, data, lab, torch_side):
    run, names, _ = build(net)
    vals = [data if n == "data" else lab if n == "softmax_label"
            else params[n] for n in names]
    if torch_side:
        return run([torch.from_numpy(v) for v in vals], [])[0][0].numpy()
    return np.asarray(run([jnp.asarray(v) for v in vals], [],
                          jax.random.PRNGKey(0), False)[0][0])


def _params(net, seed=0):
    rng = np.random.RandomState(seed)
    shapes = dict(zip(net.list_arguments(), _shapes(net)[0]))
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


@pytest.mark.parametrize("variant", ["learned", "gqa_rope"])
def test_json_loads_across_packages_both_ways(variant):
    kw = VARIANTS[variant]
    jnet = jmodels.transformer_lm(V, S, **kw)
    tnet = mt.models.transformer_lm(V, S, **kw)
    t_from_j = tsym.load_json(jnet.tojson())
    j_from_t = jsym.load_json(tnet.tojson())
    for a, b in ((t_from_j, jnet), (j_from_t, tnet), (t_from_j, tnet)):
        assert a.list_arguments() == b.list_arguments()
        assert [tuple(s) for s in _shapes(a)[0]] == \
            [tuple(s) for s in _shapes(b)[0]]
    # the loaded graphs compute what the built ones do
    params = _params(tnet)
    rng = np.random.RandomState(1)
    data = rng.randint(0, V, (3, S)).astype(np.float32)
    lab = np.zeros((3, S), np.float32)
    ref = _forward(tbuild, tnet, params, data, lab, True)
    np.testing.assert_allclose(
        _forward(tbuild, t_from_j, params, data, lab, True), ref,
        rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(
        _forward(jbuild, j_from_t, params, data, lab, False), ref,
        rtol=1e-4, atol=1e-6)


def test_compose_names_overloads_and_group():
    x = tsym.Variable("x")
    y = tsym.Variable("y", shape=(2, 3))
    fc = tsym.FullyConnected(x, num_hidden=4, name="fc")
    assert fc.list_arguments() == ["x", "fc_weight", "fc_bias"]
    nb = tsym.FullyConnected(x, num_hidden=4, no_bias=True, name="nb")
    assert nb.list_arguments() == ["x", "nb_weight"]
    ln = tsym.LayerNorm(x, name="ln")
    assert ln.list_outputs() == ["ln_output"] and len(ln) == 1
    z = (y * 2.0 + y - 1.0) / 4.0
    z = 3.0 - z
    ops = [n.op for n in z.nodes() if not n.is_variable]
    assert ops == ["_mul_scalar", "broadcast_add", "_minus_scalar",
                   "_div_scalar", "_rminus_scalar"]
    g = tsym.Group([fc, z])
    assert len(g) == 2 and g.list_arguments() == [
        "x", "fc_weight", "fc_bias", "y"]
    assert g.infer_shape(x=(5, 7))[1] == [(5, 4), (2, 3)]
    assert tsym.contrib.FlashAttention is tsym._contrib_FlashAttention


def test_infer_shape_errors():
    net = mt.models.transformer_lm(V, S, num_layers=1, d_model=32,
                                   num_heads=4)
    # the label reaches SoftmaxOutput through Reshape, so it cannot be
    # inferred from the data alone — the JAX package raises as well
    with pytest.raises(mt.MXNetError, match="insufficient information"):
        net.infer_shape(data=(2, S))
    with pytest.raises(JMXNetError):
        jmodels.transformer_lm(V, S, num_layers=1, d_model=32,
                               num_heads=4).infer_shape(data=(2, S))
    with pytest.raises(mt.MXNetError, match="infer_shape"):
        net.infer_shape(data=(2, S + 1), softmax_label=(2, S + 1))


def test_unported_model_options_raise_with_roadmap_item():
    with pytest.raises(mt.MXNetError, match="ROADMAP"):
        mt.models.transformer_lm(V, S, moe_experts=4)
    with pytest.raises(mt.MXNetError, match="ROADMAP"):
        mt.models.transformer_lm(V, S, loss_type="chunked_ce")
