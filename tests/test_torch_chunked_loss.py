"""The chunked LM-head cross-entropy (``_contrib_ChunkedLMLoss``) of the
PyTorch port against the JAX package's ``chunked_lm_loss``, against the
softmax head it replaces, in bf16, in the transformer LM and as Gluon's
``contrib.nn.ChunkedLMHead``.

Tolerances: float32 losses and gradients within 1e-5 relative and 1e-6
absolute (both sum the same products in other orders; measured 9e-7);
with bf16 operands the float32 losses within 1e-5, the bf16 gradients
within one bf16 step (at most 2**-7 of the value: dW's float32 sums,
taken in other orders, may round to neighbouring bf16 values; measured
one step in one element of 1648); the LM's within 1e-4 relative, as
``test_torch_module.py`` holds it."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.ops import chunked_loss as jcl

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import chunked_loss as tcl
import torch_threads  # noqa: F401,E402  a worker's share of the cores

N, D = 24, 16


def _inputs(V, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, D)).astype(np.float32),
            (rng.standard_normal((V, D)) * 0.3).astype(np.float32),
            (rng.standard_normal(V) * 0.1).astype(np.float32),
            rng.integers(0, V, N).astype(np.int32),
            rng.standard_normal(N).astype(np.float32))


def _jax(h, w, b, lab, g, chunks, dtype=jnp.float32):
    loss, vjp = jax.vjp(
        lambda *a: jcl.chunked_lm_loss(*a, jnp.asarray(lab), chunks),
        *(jnp.asarray(a, dtype) for a in (h, w, b)))
    return np.asarray(loss), [np.asarray(x, np.float32)
                              for x in vjp(jnp.asarray(g))]


def _port(h, w, b, lab, g, chunks, dtype=torch.float32):
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (h, w, b)]
    loss = tcl.chunked_lm_loss(*ts, torch.tensor(lab), chunks)
    loss.backward(torch.tensor(g))
    return loss, ts


@pytest.mark.parametrize("V,chunks", [(103, 5), (96, 8), (50, 1), (7, 3)],
                         ids=["ragged", "even", "one_chunk", "tiny"])
def test_loss_and_gradients_match_jax(V, chunks):
    """A vocabulary that the chunks divide, one they do not (the JAX
    package pads its last chunk with -inf bias rows, the port's last
    chunk is shorter), one chunk, and more chunks than rows a chunk."""
    h, w, b, lab, g = _inputs(V)
    want, want_g = _jax(h, w, b, lab, g, chunks)
    loss, ts = _port(h, w, b, lab, g, chunks)
    assert loss.dtype == torch.float32 and loss.shape == (N,)
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    for t, wg, name in zip(ts, want_g, ("dh", "dW", "db")):
        np.testing.assert_allclose(t.grad.numpy(), wg, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_equals_the_softmax_head():
    """The loss is -log softmax(h W^T + b)[label], and its gradients those
    of the full-logits head (the port's ``log_softmax`` and autograd)."""
    h, w, b, lab, g = _inputs(61, seed=2)
    loss, ts = _port(h, w, b, lab, g, 4)
    hs, ws, bs = (torch.tensor(a, requires_grad=True) for a in (h, w, b))
    full = -torch.log_softmax(hs @ ws.t() + bs, dim=-1)[
        torch.arange(N), torch.tensor(lab).long()]
    full.backward(torch.tensor(g))
    np.testing.assert_allclose(loss.detach().numpy(),
                               full.detach().numpy(), rtol=1e-5, atol=1e-6)
    for t, r in zip(ts, (hs, ws, bs)):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_bf16_operands_give_float32_logits_as_the_jax_package():
    """bf16 hidden, weight and bias: float32 losses (the logits are f32
    sums of exact products, never rounded to bf16), gradients in the
    inputs' dtype."""
    h, w, b, lab, g = _inputs(103, seed=3)
    want, want_g = _jax(h, w, b, lab, g, 5, jnp.bfloat16)
    loss, ts = _port(h, w, b, lab, g, 5, torch.bfloat16)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for t, wg in zip(ts, want_g):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(t.grad.float().numpy(), wg,
                                   rtol=2 ** -7, atol=1e-6)
    # a bf16 product would round every logit to 8 bits: far off
    hb, wb = (torch.tensor(a).bfloat16() for a in (h, w))
    rounded = (hb @ wb.t()).float()
    assert (rounded - hb.float() @ wb.float().t()).abs().max() > 1e-3


def test_no_tensor_of_the_full_logits_is_made():
    """Forward and backward at N 24, V 480, 8 chunks: no tensor of N x V
    elements or more is created (the largest is a chunk's N x 60)."""
    h, w, b, lab, g = _inputs(480, seed=4)
    sizes = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for o in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(o, torch.Tensor):
                    sizes.append(o.numel())
            return out
    with Spy():
        _port(h, w, b, lab, g, 8)
    big = [s for s in sizes if s >= N * 480 and s != 480 * D]
    assert not big and max(s for s in sizes if s != 480 * D) <= N * 60


def test_nd_and_symbol_forms_match_jax():
    h, w, b, lab, _ = _inputs(40, seed=5)
    want, _ = _jax(h, w, b, lab, np.ones(N, np.float32), 3)
    got = mt.nd.chunked_lm_loss(*(mt.nd.array(a, ctx=mt.cpu())
                                  for a in (h, w, b, lab)), num_chunks=3)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-5, atol=1e-6)
    s = mt.sym.contrib.ChunkedLMLoss(mt.sym.Variable("data"),
                                     mt.sym.Variable("weight"),
                                     mt.sym.Variable("bias"),
                                     mt.sym.Variable("label"), num_chunks=3)
    _, outs, _ = s.infer_shape(data=(N, D), weight=(40, D), bias=(40,),
                               label=(N,))
    assert outs == [(N,)]


V, S, B = 50, 8, 3
LM = dict(num_layers=1, d_model=16, num_heads=2)


def test_lm_heads_share_parameters_and_agree():
    """``loss_type="chunked_ce"`` names the head's parameters as the
    softmax head does, so one set of weights runs both: the chunked
    LM's output (the mean loss) equals the mean -log p of the softmax
    LM's probabilities at the labels, in the port and in the JAX
    package."""
    nets = {(pkg, lt): (jmodels if pkg is mx else mt.models).transformer_lm(
        V, S, loss_type=lt, ce_chunks=4, **LM)
        for pkg in (mx, mt) for lt in ("softmax", "chunked_ce")}
    names = nets[(mt, "softmax")].list_arguments()
    assert nets[(mt, "chunked_ce")].list_arguments() == names
    assert nets[(mx, "chunked_ce")].list_arguments() == names
    shapes = dict(zip(names, nets[(mt, "softmax")].infer_shape(
        data=(B, S), softmax_label=(B, S))[0]))
    rng = np.random.RandomState(0)
    params = {n: (rng.randn(*s) * 0.3).astype(np.float32)
              for n, s in shapes.items() if n not in ("data",
                                                      "softmax_label")}
    x = rng.randint(0, V, (B, S)).astype(np.int32)
    y = rng.randint(0, V, (B, S)).astype(np.int32)
    out = {}
    for (pkg, lt), net in nets.items():
        ctx = pkg.cpu()
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[pkg.io.DataDesc("data", (B, S), np.int32)],
                 label_shapes=[pkg.io.DataDesc("softmax_label", (B, S),
                                               np.int32)],
                 for_training=False)
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                     [pkg.nd.array(y, ctx=ctx)]),
                    is_train=False)
        out[(pkg, lt)] = mod.get_outputs()[0].asnumpy()
    probs = out[(mt, "softmax")]
    nll = -np.log(probs[np.arange(B * S), y.reshape(-1)]).mean()
    np.testing.assert_allclose(out[(mt, "chunked_ce")], nll, rtol=1e-5)
    np.testing.assert_allclose(out[(mt, "chunked_ce")],
                               out[(mx, "chunked_ce")], rtol=1e-4)


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_gluon_chunked_lm_head_matches_jax(hybridize):
    """``gluon.contrib.nn.ChunkedLMHead`` with the JAX block's weights:
    the per-token loss and the weight's gradient."""
    h, w, b, lab, _ = _inputs(37, seed=6)
    res = {}
    for pkg in (mx, mt):
        with pkg.name.NameManager():
            head = pkg.gluon.contrib.nn.ChunkedLMHead(37, D, num_chunks=4)
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        head.initialize(**kw)
        head.weight.set_data(pkg.nd.array(w, **kw))
        head.bias.set_data(pkg.nd.array(b, **kw))
        if hybridize:
            head.hybridize()
        with pkg.autograd.record():
            loss = head(pkg.nd.array(h, **kw), pkg.nd.array(lab, **kw))
        loss.backward()
        res[pkg] = (loss.asnumpy(), head.weight.grad().asnumpy())
    np.testing.assert_allclose(res[mt][0], res[mx][0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res[mt][1], res[mx][1], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        mt.gluon.contrib.nn.ChunkedLMHead(10, 0)
