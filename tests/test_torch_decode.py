"""KV-cache decode and beam search: the PyTorch port against the JAX
package, and the ops the decode graph adds (``batch_dot``, ``repeat``,
``SwapAxis``/``swapaxes``, ``take``, ``arange``).

The decode step is ``transformer_decode_step`` driven through
``Module(state_names=...)``: ``forward``, ``get_outputs``,
``set_states(outputs[1:])``, as ``benchmark/decode_bench.py`` drives it.
Both packages start from the same numpy weights and see the same tokens.
These tests port ``tests/test_transformer.py:174-460`` to the port.

Tolerances (float32):
* ops, forward and ``jax.vjp`` against the port's autograd: 1e-5
  relative and 1e-6 absolute (products of 4-8 terms of order 1, summed
  in another order);
* decode logits, port against JAX, over 8 steps: 1e-4 relative and
  1e-5 absolute (one layer stack of f32 products over d 32 and a softmax
  over 8 cache slots; the packages sum in other orders, measured about
  1e-6);
* decode against the teacher-forced LM, as next-token probabilities: 2e-5
  absolute, the JAX package's own bound (its test_transformer.py:209);
* beam scores against the JAX package's: 1e-4 (sums of 6 f32
  log-probabilities of order 1); the sequences must be equal;
* a beam's score against its re-scoring by the decode module: 1e-4, as
  the JAX package's test_transformer.py:336.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

OP_TOL = dict(rtol=1e-5, atol=1e-6)


def _op_pair(name, args, attrs, diff=None):
    """Forward of op ``name`` in both packages, and the gradient of
    sum(out * w) for a fixed random w with respect to the inputs at
    ``diff`` (default: every float input; ``jax.vjp`` against
    autograd)."""
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn
    jout = jfn(*[jnp.asarray(a) for a in args], **attrs)
    if diff is None:
        diff = [i for i, a in enumerate(args) if a.dtype == np.float32]
    tins = [torch.tensor(a, requires_grad=i in diff)
            for i, a in enumerate(args)]
    tout = tfn(*tins, **attrs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **OP_TOL)
    w = np.random.RandomState(9).randn(*tout.shape).astype(np.float32)

    def f(*xs):
        full = [jnp.asarray(a) for a in args]
        for i, x in zip(diff, xs):
            full[i] = x
        return jfn(*full, **attrs)
    _, vjp = jax.vjp(f, *[jnp.asarray(args[i]) for i in diff])
    jgrads = vjp(jnp.asarray(w))
    tgrads = torch.autograd.grad(tout, [tins[i] for i in diff],
                                 torch.from_numpy(w))
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **OP_TOL)


@pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_batch_dot_matches_jax(ta, tb):
    rng = np.random.RandomState(0)
    a = rng.randn(3, 5, 4).astype(np.float32)
    b = rng.randn(3, 4, 6).astype(np.float32)
    if ta:
        a = np.ascontiguousarray(a.transpose(0, 2, 1))
    if tb:
        b = np.ascontiguousarray(b.transpose(0, 2, 1))
    _op_pair("batch_dot", [a, b], dict(transpose_a=ta, transpose_b=tb))


@pytest.mark.parametrize("repeats,axis", [(2, 1), (3, 0), (2, None)])
def test_repeat_matches_jax(repeats, axis):
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    _op_pair("repeat", [x], dict(repeats=repeats, axis=axis))


def test_swapaxes_matches_jax_under_both_names():
    x = np.random.RandomState(2).randn(2, 3, 4).astype(np.float32)
    _op_pair("swapaxes", [x], dict(dim1=1, dim2=2))
    _op_pair("SwapAxis", [x], dict(dim1=0, dim2=2))
    assert treg.get("swapaxes") is treg.get("SwapAxis")


@pytest.mark.parametrize("mode", ["clip", "wrap"])
@pytest.mark.parametrize("axis", [0, 1])
def test_take_matches_jax(mode, axis):
    """Float indices truncate; out-of-range ones clip or wrap."""
    rng = np.random.RandomState(3)
    a = rng.randn(5, 4, 3).astype(np.float32)
    idx = np.array([[0.0, 2.7, -1.0], [4.2, 7.0, 1.9]], np.float32)
    _op_pair("take", [a, idx], dict(axis=axis, mode=mode), diff=[0])


def test_arange_alias_matches_jax():
    assert treg.get("arange") is treg.get("_arange")
    for kw in (dict(start=0, stop=5), dict(start=2.0, stop=8.0, step=1.5),
               dict(start=0, stop=3, repeat=2)):
        got = treg.get("arange").fn(**kw).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jreg.get("_arange").fn(**kw)))


def test_nd_take_runs_on_the_arrays_device_without_autograd():
    a = mt.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3),
                    ctx=mt.cpu())
    got = mt.nd.take(a, mt.nd.array([3.0, 0.0, 9.0], ctx=mt.cpu()))
    np.testing.assert_array_equal(got.asnumpy(),
                                  a.asnumpy()[[3, 0, 3]])
    assert got.context == mt.cpu() and not got.as_torch().requires_grad
    # basic slicing along axis 0 is a view; copy() is not
    assert a[1:3].shape == (2, 3) and a.ndim == 2
    assert a[1:3].as_torch().data_ptr() == a.as_torch()[1].data_ptr()
    # general indexing (ported with the imperative NDArray): a row
    np.testing.assert_array_equal(a[2].asnumpy(), a.asnumpy()[2])
    c = a.copy()
    assert c.as_torch().data_ptr() != a.as_torch().data_ptr()


# --------------------------------------------------------------------------
# the decode step
# --------------------------------------------------------------------------
def _lm_params(net, V, S, seed, scale=0.3):
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(1, S),
                                      softmax_label=(1, S))[0]))
    rng = np.random.RandomState(seed)
    out = {}
    for n, s in shapes.items():
        if n in ("data", "softmax_label"):
            continue
        x = (rng.randn(*s) * scale).astype(np.float32)
        if n.endswith("_gamma"):
            x += np.float32(1.0)
        out[n] = x
    return out


def _state_names(num_layers):
    return [f"layer{i}_{kv}_cache" for i in range(num_layers)
            for kv in ("k", "v")] + ["cur_pos"]


def _decode_module(pkg, V, L, B, kw, params, compute_dtype=None):
    dec = (jmodels if pkg is mx else mt.models).transformer_decode_step(
        V, L, B, **kw)
    extra = {} if compute_dtype is None else {"compute_dtype":
                                              compute_dtype}
    dmod = pkg.mod.Module(dec, context=pkg.cpu(), data_names=("data",),
                          label_names=None,
                          state_names=_state_names(kw["num_layers"]),
                          **extra)
    dmod.bind(data_shapes=[("data", (B,))], for_training=False)
    dmod.init_params(arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                                 for n, v in params.items()})
    dmod.set_states(value=0)
    return dmod


def _step(pkg, dmod, tok):
    dmod.forward(pkg.io.DataBatch([pkg.nd.array(tok, ctx=pkg.cpu())], []))
    res = dmod.get_outputs()
    dmod.set_states(states=res[1:])
    return res


FORMS = {
    "learned_gelu": dict(num_layers=2, d_model=32, num_heads=4),
    "rope_gqa_swiglu": dict(num_layers=2, d_model=32, num_heads=4,
                            num_kv_heads=2, pos_type="rope",
                            ffn_type="swiglu"),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_decode_matches_jax_for_8_steps(form):
    kw = FORMS[form]
    V, L, B = 30, 8, 3
    params = _lm_params(jmodels.transformer_lm(V, L, **kw), V, L, 0)
    toks = np.random.RandomState(1).randint(0, V, (L, B)).astype(np.float32)
    logits, states = {}, {}
    for name, pkg in (("jax", mx), ("port", mt)):
        dmod = _decode_module(pkg, V, L, B, kw, params)
        outs = [_step(pkg, dmod, toks[t]) for t in range(L)]
        logits[name] = [o[0].asnumpy() for o in outs]
        states[name] = [s.asnumpy() for s in dmod.get_states()]
    for t in range(L):
        np.testing.assert_allclose(logits["port"][t], logits["jax"][t],
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"step {t}")
    for a, b in zip(states["port"], states["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(states["port"][-1], np.full(B, L))


@pytest.mark.parametrize("form", sorted(FORMS))
def test_decode_matches_teacher_forced_lm(form):
    """The same weights through the port's LM (all positions at once)
    and token by token through its rolled cache give the same next-token
    distributions."""
    kw = FORMS[form]
    V, S, B = 30, 8, 3
    net = mt.models.transformer_lm(V, S, **kw)
    params = _lm_params(net, V, S, 4)
    toks = np.random.RandomState(5).randint(0, V, (B, S)).astype(np.float32)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B, S))], for_training=False)
    mod.init_params(arg_params=params)
    mod.forward(mt.io.DataBatch([mt.nd.array(toks, ctx=mt.cpu())],
                                [mt.nd.zeros((B, S), ctx=mt.cpu())]),
                is_train=False)
    probs_tf = mod.get_outputs()[0].asnumpy().reshape(B, S, V)
    dmod = _decode_module(mt, V, S, B, kw, params)
    for t in range(S):
        logits = _step(mt, dmod, toks[:, t])[0].asnumpy()
        e = np.exp(logits - logits.max(1, keepdims=True))
        np.testing.assert_allclose(e / e.sum(1, keepdims=True),
                                   probs_tf[:, t], atol=2e-5,
                                   err_msg=f"position {t}")


def test_decode_past_max_len_clamps_not_errors():
    """Positions past max_len clamp to the last positional embedding (the
    Embedding op clips), as in the JAX package; the counter keeps
    counting."""
    V, L, B = 10, 4, 2
    kw = dict(num_layers=1, d_model=16, num_heads=2)
    params = _lm_params(mt.models.transformer_lm(V, L, **kw), V, L, 6)
    dmod = _decode_module(mt, V, L, B, kw, params)
    tok = np.zeros(B, np.float32)
    logits = [_step(mt, dmod, tok)[0].asnumpy() for _ in range(L + 3)]
    assert all(np.isfinite(x).all() for x in logits)
    assert float(dmod.get_states()[-1].asnumpy()[0]) == L + 3


def test_jax_lm_checkpoint_loads_into_the_decode_module(tmp_path):
    """A checkpoint of the JAX package's trained-graph Module (the LM)
    loads into the port's decode Module by name, through
    ``convert.params_from_numpy``, and decodes as the JAX decode step
    with the same weights."""
    kw = FORMS["rope_gqa_swiglu"]
    V, L, B = 24, 8, 2
    jnet = jmodels.transformer_lm(V, L, **kw)
    jmod = mx.mod.Module(jnet, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (B, L))],
              label_shapes=[("softmax_label", (B, L))])
    mx.random.seed(11)
    jmod.init_params(mx.initializer.Xavier())
    prefix = str(tmp_path / "lm")
    jmod.save_checkpoint(prefix, 1)
    _, args, auxs = mt.model.load_checkpoint(prefix, 1)
    dec = mt.models.transformer_decode_step(V, L, B, **kw)
    names = _state_names(kw["num_layers"])
    targs, taux = mt.params_from_numpy(
        {n: a.asnumpy() for n, a in args.items()},
        {n: a.asnumpy() for n, a in auxs.items()}, mt.cpu(), dec,
        {"data": (B,), "cur_pos": (B,),
         **{n: (B, 2, L, 8) for n in names[:-1]}})   # 2 kv heads of 8
    dmod = mt.mod.Module(dec, context=mt.cpu(), label_names=None,
                         state_names=names)
    dmod.bind(data_shapes=[("data", (B,))], for_training=False)
    dmod.init_params(arg_params=targs, aux_params=taux)
    dmod.set_states(value=0)
    jargs = {n: a.asnumpy() for n, a in jmod.get_params()[0].items()}
    jdec = _decode_module(mx, V, L, B, kw, jargs)
    toks = np.random.RandomState(2).randint(0, V, (4, B)).astype(np.float32)
    for t in range(4):
        np.testing.assert_allclose(_step(mt, dmod, toks[t])[0].asnumpy(),
                                   _step(mx, jdec, toks[t])[0].asnumpy(),
                                   rtol=1e-4, atol=1e-5)


def test_bf16_decode_position_stalls_at_256():
    """Reference fault, kept (ROADMAP §3): under a bf16 compute_dtype the
    decode graph's ``cur_pos + 1`` is an ordinary elementwise op, so it
    runs in bf16, whose integers stop being exact past 256 (257 rounds to
    256).  From position 254 the counter reads 255, 256, 256, 256 in both
    packages; decode in fp32."""
    V, L, B = 20, 300, 2
    kw = dict(num_layers=1, d_model=16, num_heads=2)
    params = _lm_params(mt.models.transformer_lm(V, L, **kw), V, L, 8)
    seen = {}
    for name, pkg, cd in (("jax", mx, jnp.bfloat16),
                          ("port", mt, "bfloat16")):
        dmod = _decode_module(pkg, V, L, B, kw, params, compute_dtype=cd)
        st = dmod.get_states()
        start = pkg.nd.array(np.full(B, 254.0, np.float32), ctx=pkg.cpu())
        dmod.set_states(states=st[:-1] + [start])
        pos = []
        for _ in range(4):
            _step(pkg, dmod, np.zeros(B, np.float32))
            pos.append(float(dmod.get_states()[-1].asnumpy()[0]))
        seen[name] = pos
    assert seen["port"] == seen["jax"] == [255.0, 256.0, 256.0, 256.0]


# --------------------------------------------------------------------------
# beam search
# --------------------------------------------------------------------------
BEAM_KW = dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2)


def _beam_params(V, L, seed):
    return _lm_params(jmodels.transformer_lm(V, L, **BEAM_KW), V, L, seed,
                      scale=0.5)


@pytest.mark.parametrize("beam,eos,penalty", [(3, None, 1.0),
                                              (2, 0, 0.0),
                                              (4, None, 0.6)])
def test_beam_search_matches_jax(beam, eos, penalty):
    V, L, gen = 20, 8, 6
    prompts = np.array([2, 7])
    params = _beam_params(V, L, 13)
    res = {}
    for name, pkg, beam_search in (("jax", mx, jmodels.beam_search),
                                   ("port", mt, mt.models.beam_search)):
        dmod = _decode_module(pkg, V, L, len(prompts) * beam, BEAM_KW,
                              params)
        res[name] = beam_search(dmod, prompts, beam_size=beam, gen_len=gen,
                                eos=eos, length_penalty=penalty)
    (ps, psc), (js, jsc) = res["port"], res["jax"]
    assert ps.shape == (2, beam, gen + 1) and ps.dtype == np.int32
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_allclose(psc, jsc, rtol=1e-4, atol=1e-4)
    assert np.all(np.diff(psc, axis=1) <= 0)     # best first


def test_beam1_equals_greedy():
    V, L, gen = 20, 8, 6
    prompts = np.array([2, 7, 11])
    params = _beam_params(V, L, 5)
    dmod = _decode_module(mt, V, L, len(prompts), BEAM_KW, params)
    tok, greedy = prompts.astype(np.float32), [prompts.copy()]
    for _ in range(gen):
        tok = _step(mt, dmod, tok)[0].asnumpy().argmax(1).astype(np.float32)
        greedy.append(tok.astype(np.int64))
    seqs, scores = mt.models.beam_search(dmod, prompts, beam_size=1,
                                         gen_len=gen)
    np.testing.assert_array_equal(seqs[:, 0, :], np.stack(greedy, 1))
    assert np.isfinite(scores).all()


def _seq_logprob(dmod, seq):
    B = dmod.data_shapes[0].shape[0]
    dmod.set_states(value=0)
    total = 0.0
    for t in range(1, len(seq)):
        logits = _step(mt, dmod, np.full(B, seq[t - 1], np.float32))[0]
        x = logits.asnumpy()[0].astype(np.float64)
        logp = x - x.max() - np.log(np.exp(x - x.max()).sum())
        total += float(logp[int(seq[t])])
    return total


def test_beam_scores_equal_a_rescoring_and_beat_greedy():
    V, L, gen = 20, 8, 5
    params = _beam_params(V, L, 9)
    prompts = np.array([4])
    s1, _ = mt.models.beam_search(_decode_module(mt, V, L, 1, BEAM_KW,
                                                 params),
                                  prompts, beam_size=1, gen_len=gen)
    s3, sc3 = mt.models.beam_search(_decode_module(mt, V, L, 3, BEAM_KW,
                                                   params),
                                    prompts, beam_size=3, gen_len=gen,
                                    length_penalty=0.0)
    scorer = _decode_module(mt, V, L, 1, BEAM_KW, params)
    lp_beam = [_seq_logprob(scorer, s3[0, k]) for k in range(3)]
    np.testing.assert_allclose(lp_beam, sc3[0], rtol=1e-4, atol=1e-4)
    assert lp_beam[0] >= _seq_logprob(scorer, s1[0, 0]) - 1e-4


def test_beam_search_eos_pins_finished_beams():
    V, L = 12, 8
    params = _beam_params(V, L, 3)
    dmod = _decode_module(mt, V, L, 4, BEAM_KW, params)
    seqs, _ = mt.models.beam_search(dmod, np.array([1, 2]), beam_size=2,
                                    gen_len=6, eos=0)
    for b in range(2):
        for k in range(2):
            s = seqs[b, k, 1:]
            hits = np.where(s == 0)[0]
            if hits.size:
                assert np.all(s[hits[0]:] == 0), s


def test_beam_search_refuses_a_module_of_another_batch():
    V, L = 12, 8
    dmod = _decode_module(mt, V, L, 3, BEAM_KW, _beam_params(V, L, 3))
    with pytest.raises(mt.MXNetError, match="n_prompts"):
        mt.models.beam_search(dmod, np.array([1, 2]), beam_size=2,
                              gen_len=2)


def test_moe_decode_step_raises():
    """The MoE decode step raised until the MoE op was ported (C1.b.2);
    now it builds with the JAX decode step's argument names and shapes,
    and only an unknown option still raises
    (``tests/test_torch_moe.py`` holds its values against the JAX
    package)."""
    kw = dict(num_layers=1, d_model=16, num_heads=2, moe_experts=4,
              moe_k=2)
    dec = mt.models.transformer_decode_step(10, 4, 2, **kw)
    jdec = jmodels.transformer_decode_step(10, 4, 2, **kw)
    assert dec.list_arguments() == jdec.list_arguments()
    assert "layer0_expert_w1_weight" in dec.list_arguments()
    with pytest.raises(ValueError, match="swiglu"):
        mt.models.transformer_decode_step(10, 4, 2, ffn_type="swiglu", **kw)
