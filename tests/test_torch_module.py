"""Training the transformer LM through ``Module``: the PyTorch port
against the JAX package, and the port's versions of the training cases
of ``tests/test_transformer.py``.

The LM is the one of ``tests/test_torch_model.py`` (2 layers, d 32, 4
heads, 2 KV heads, seq 16, vocab 50), with learned or rotary positions
and the gelu or SwiGLU FFN.  Both packages start from the same numpy
weights (``init_params(arg_params=...)``) and see the same batches.

Tolerances (float32 unless said):
* outputs and gradients after one forward/backward: 1e-4 relative and
  1e-6 absolute (both compute in f32 and differ in summation order;
  gradients sum over 48 tokens);
* parameters after 3 updates: SGD with momentum 1e-5; Adam 1e-4.  Adam
  runs with epsilon 1e-4 here: the gradient of the key bias is zero in
  exact arithmetic (a softmax does not change when every key score of a
  query moves by the same q . b_k), so both packages hold f32 rounding
  noise of order 1e-9 there, and Adam's m / (sqrt(v) + epsilon) turns
  noise into full-size steps of opposite sign when epsilon is 1e-8;
* bfloat16 compute: the per-step loss within 0.05 nats of the JAX run —
  both cast every op input to bf16 (2**-8 relative) but round at other
  points inside fused ops (measured about 0.01).
The JAX package's own Module tests cover its side; the flash-attention
kernels themselves run only on the card."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

V, S, B = 50, 16, 3
KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2)


def _params(net, seed=0, scale=0.3):
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(B, S), softmax_label=(B, S))[0]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * scale).astype(np.float32)
            for n, s in shapes.items() if n not in ("data", "softmax_label")}


def _batches(n, seed=1):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, (B, S)).astype(np.float32),
             rng.randint(0, V, (B, S)).astype(np.float32))
            for _ in range(n)]


def _module(pkg, net, params, compute_dtype=None, optimizer=None,
            opt_params=None):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(net, context=ctx, compute_dtype=compute_dtype)
    mod.bind(data_shapes=[("data", (B, S))],
             label_shapes=[("softmax_label", (B, S))])
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                for n, v in params.items()})
    if optimizer:
        mod.init_optimizer(optimizer=optimizer,
                           optimizer_params=opt_params)
    return mod


def _batch(pkg, x, y):
    ctx = pkg.cpu()
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                            [pkg.nd.array(y, ctx=ctx)])


def _nets(pos_type="learned", ffn_type="gelu"):
    return (jmodels.transformer_lm(V, S, pos_type=pos_type,
                                   ffn_type=ffn_type, **KW),
            mt.models.transformer_lm(V, S, pos_type=pos_type,
                                     ffn_type=ffn_type, **KW))


@pytest.mark.parametrize("pos_type,ffn_type", [("learned", "gelu"),
                                               ("rope", "swiglu")])
def test_outputs_and_grads_match_jax(pos_type, ffn_type):
    jnet, tnet = _nets(pos_type, ffn_type)
    params = _params(jnet)
    (x, y), = _batches(1)
    res = {}
    for name, pkg, net in (("jax", mx, jnet), ("port", mt, tnet)):
        mod = _module(pkg, net, params)
        mod.forward(_batch(pkg, x, y), is_train=True)
        mod.backward()
        grads = {n: mod._exec.grad_dict[n].asnumpy() for n in params}
        res[name] = (mod.get_outputs()[0].asnumpy(), grads)
    np.testing.assert_allclose(res["port"][0], res["jax"][0], rtol=1e-4,
                               atol=1e-6)
    for n in params:
        np.testing.assert_allclose(res["port"][1][n], res["jax"][1][n],
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    # the loss head's gradient reached every parameter
    assert all(np.abs(g).max() > 0 for g in res["port"][1].values())


@pytest.mark.parametrize("optimizer,opt_params,tol", [
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-3}, 1e-5),
    ("adam", {"learning_rate": 3e-3, "epsilon": 1e-4}, 1e-4)])
def test_params_after_updates_match_jax(optimizer, opt_params, tol):
    jnet, tnet = _nets()
    params = _params(jnet)
    batches = _batches(3)
    res = {}
    for name, pkg, net in (("jax", mx, jnet), ("port", mt, tnet)):
        mod = _module(pkg, net, params, optimizer=optimizer,
                      opt_params=opt_params)
        for x, y in batches:
            mod.forward(_batch(pkg, x, y), is_train=True)
            mod.backward()
            mod.update()
        res[name] = {n: a.asnumpy() for n, a in mod.get_params()[0].items()}
    for n in params:
        assert not np.array_equal(res["port"][n], params[n]), n
        np.testing.assert_allclose(res["port"][n], res["jax"][n], rtol=tol,
                                   atol=tol, err_msg=n)


def _nll(probs, y):
    lab = y.reshape(-1).astype(int)
    return float(-np.log(np.maximum(probs[np.arange(len(lab)), lab],
                                    1e-9)).mean())


def test_bf16_loss_trajectory_matches_jax():
    jnet, tnet = _nets()
    params = _params(jnet)
    batches = _batches(2)
    losses = {}
    for name, pkg, net, cd in (("jax", mx, jnet, jnp.bfloat16),
                               ("port", mt, tnet, "bfloat16")):
        mod = _module(pkg, net, params, compute_dtype=cd, optimizer="sgd",
                      opt_params={"learning_rate": 0.02, "momentum": 0.9})
        losses[name] = []
        for step in range(6):
            x, y = batches[step % 2]
            mod.forward(_batch(pkg, x, y), is_train=True)
            losses[name].append(_nll(mod.get_outputs()[0].asnumpy(), y))
            mod.update()
    np.testing.assert_allclose(losses["port"], losses["jax"], atol=0.05)
    assert losses["port"][-1] < losses["port"][0]


def test_update_without_backward_computes_grads_once():
    """``forward(is_train=True)`` then ``update()``: the gradients are
    computed inside update, one backward per step; an inference forward
    records no graph."""
    _, tnet = _nets()
    params = _params(tnet)
    (x, y), = _batches(1)
    mod = _module(mt, tnet, params, optimizer="sgd",
                  opt_params={"learning_rate": 0.1})
    mt.profiler.reset_dispatch_counts()
    b = _batch(mt, x, y)
    mod.forward(b, is_train=True)
    mod.update()
    counts = mt.profiler.dispatch_counts()
    assert counts["module.backward"] == 1 and counts["module.update"] == 1
    mod.forward(b, is_train=False)
    assert mod._exec._graph is None
    assert mod.get_outputs()[0].as_torch().grad_fn is None
    mod.forward(b, is_train=True)
    mod.backward()
    mod.update()
    assert mt.profiler.dispatch_counts()["module.backward"] == 2


def test_bf16_float_label_trains_as_256():
    """Reference fault, kept: under ``compute_dtype=bfloat16`` the float
    label reaches ``SoftmaxOutput`` through ``Reshape``, which casts it to
    bf16, so the id 257 trains as 256 in both packages; int32 labels are
    not cast and target 257.  Read from the lm_head bias gradient, whose
    most negative entry is the target class."""
    Vb = 300
    kw = dict(num_layers=1, d_model=16, num_heads=2)
    jnet = jmodels.transformer_lm(Vb, 4, **kw)
    tnet = mt.models.transformer_lm(Vb, 4, **kw)
    shapes = dict(zip(jnet.list_arguments(),
                      jnet.infer_shape(data=(2, 4),
                                       softmax_label=(2, 4))[0]))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * 0.02).astype(np.float32)
              for n, s in shapes.items()
              if n not in ("data", "softmax_label")}
    x = rng.randint(0, Vb, (2, 4)).astype(np.int32)

    def target(pkg, net, cd, label_dtype):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(net, context=ctx, compute_dtype=cd)
        mod.bind(data_shapes=[pkg.io.DataDesc("data", (2, 4), np.int32)],
                 label_shapes=[pkg.io.DataDesc("softmax_label", (2, 4),
                                               label_dtype)])
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        y = np.full((2, 4), 257, label_dtype)
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                     [pkg.nd.array(y, ctx=ctx)]),
                    is_train=True)
        mod.backward()
        return int(np.argmin(mod._exec.grad_dict["lm_head_bias"].asnumpy()))

    assert target(mx, jnet, jnp.bfloat16, np.float32) == 256
    assert target(mt, tnet, "bfloat16", np.float32) == 256
    assert target(mt, tnet, "bfloat16", np.int32) == 257
    assert target(mx, jnet, jnp.bfloat16, np.int32) == 257
    assert target(mt, tnet, None, np.float32) == 257
    # the op itself: a bf16-rounded float label of 257 is 256
    out = torch.full((1, Vb), 1.0 / Vb)
    lab = torch.tensor([257.0]).to(torch.bfloat16)
    grad = mt.ops.nn.softmax_output_grad(out, lab)
    assert int(grad.argmin()) == 256
    lab = torch.tensor([257], dtype=torch.int32)
    grad = mt.ops.nn.softmax_output_grad(out, lab)
    assert int(grad.argmin()) == 257


# -- the training cases of tests/test_transformer.py, through the port --
def _fit_lm(net, steps=16, lr=3e-3, seq=16, vocab=50, seed=0):
    rng = np.random.RandomState(seed)
    toks = np.zeros((32, seq + 1), np.float32)
    toks[:, 0] = rng.randint(1, vocab, 32)
    for t in range(seq):
        toks[:, t + 1] = (toks[:, t] * 3 + 1) % vocab
    it = mt.io.NDArrayIter({"data": toks[:, :-1]},
                           {"softmax_label": toks[:, 1:]}, batch_size=8)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mt.random.seed(seed)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": lr})
    b = next(iter(it))
    nlls = []
    for _ in range(steps):
        mod.forward(b, is_train=True)
        probs = mod.get_outputs()[0].asnumpy()
        nlls.append(_nll(probs, b.label[0].asnumpy()))
        mod.update()
    return nlls


def test_transformer_lm_trains():
    net = mt.models.transformer_lm(vocab_size=50, seq_len=16, num_layers=2,
                                   d_model=32, num_heads=2)
    nlls = _fit_lm(net)
    assert nlls[-1] < 0.3 * nlls[0], (nlls[0], nlls[-1])


def test_transformer_gqa_trains():
    Vg, Sg = 40, 16
    net = mt.models.transformer_lm(Vg, Sg, num_layers=1, d_model=32,
                                   num_heads=4, num_kv_heads=2)
    rs = np.random.RandomState(0)
    first = rs.randint(0, Vg, (64, 1))
    seq = (first + np.arange(Sg + 1)) % Vg
    x = seq[:, :Sg].astype("float32")
    y = seq[:, 1:].astype("float32")
    it = mt.io.NDArrayIter(x, y, 16)
    mod = mt.mod.Module(net, context=mt.cpu(), data_names=("data",),
                        label_names=("softmax_label",))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.initializer.Xavier())
    # GQA qkv projection: (h + 2*hk) * hd = (4+4)*8 = 64 < 3*32
    assert mod._exec.arg_dict["layer0_qkv_weight"].shape[0] == 64
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 3e-3})
    metric = mt.metric.Perplexity(ignore_label=None)
    ppls = []
    for epoch in range(5):
        it.reset()
        metric.reset()
        for b in it:
            mod.forward(b, is_train=True)
            mod.update_metric(metric, b.label)
            mod.backward()
            mod.update()
        ppls.append(dict(metric.get_name_value())["perplexity"])
    assert ppls[-1] < ppls[0] / 1.5, ppls


def test_rope_lm_trains():
    Vr, Sr = 30, 12
    rs = np.random.RandomState(0)
    first = rs.randint(0, Vr, (128, 1))
    seq = (first + np.arange(Sr + 1)) % Vr
    x, y = seq[:, :Sr].astype("f"), seq[:, 1:].astype("f")
    net = mt.models.transformer_lm(Vr, Sr, num_layers=1, d_model=32,
                                   num_heads=4, pos_type="rope")
    mod = mt.mod.Module(net, data_names=("data",),
                        label_names=("softmax_label",), context=mt.cpu())
    np.random.seed(0)
    it = mt.io.NDArrayIter(x, y, 32, shuffle=True)
    mt.random.seed(2)
    metric = mt.metric.Perplexity(ignore_label=None)
    mod.fit(it, num_epoch=12, optimizer="adam",
            optimizer_params={"learning_rate": 5e-3},
            initializer=mt.initializer.Xavier(), eval_metric=metric)
    it.reset()
    metric.reset()
    mod.score(it, metric)
    ppl = dict(metric.get_name_value())["perplexity"]
    assert ppl < 4.0, ppl


def test_swiglu_lm_trains():
    """The training half of ``test_swiglu_decode_parity_and_training``
    (its decode half is in ``tests/test_torch_decode.py``): the fused
    gate|lin projection has both halves, and the SwiGLU + rope LM
    trains."""
    net = mt.models.transformer_lm(24, 8, num_layers=1, d_model=32,
                                   num_heads=4, pos_type="rope",
                                   ffn_type="swiglu")
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 8))],
             label_shapes=[("softmax_label", (2, 8))], for_training=False)
    mt.random.seed(23)
    mod.init_params(mt.initializer.Xavier())
    arg_params, _ = mod.get_params()
    assert arg_params["layer0_fc1_weight"].shape[0] == 2 * 4 * 32
    nlls = _fit_lm(net, steps=12, lr=5e-3, seq=8, vocab=24, seed=6)
    assert nlls[-1] < 0.5 * nlls[0], (nlls[0], nlls[-1])
