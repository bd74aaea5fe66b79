"""The ``CTCLoss`` op and ``gluon.loss.CTCLoss`` of the PyTorch port
against the JAX package: both blank conventions, data and label
lengths (with the JAX code's slot swap when only label lengths are
given), repeated labels, an infeasible alignment, and the gradient.

The port runs the same log-space forward recursion (float32, -1e30 as
log 0) as a loop over time vectorised over the batch and the states,
with ``jnp.logaddexp``'s value and gradient, so even an infeasible
sequence's loss (about 1e30) and gradient equal the JAX package's.
Tolerances: losses within 1e-5 relative (both sum the same float32
terms in the same order; measured equal), gradients within 1e-5
absolute (of order 1; measured 2.4e-7)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import sequence as jseq

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import sequence as tseq
import torch_threads  # noqa: F401,E402  a worker's share of the cores

T, N, C, L = 12, 5, 6, 4
DATA_LEN = np.array([12, 10, 3, 12, 7], np.float32)   # row 2: infeasible
LABEL_LEN = np.array([2, 3, 4, 1, 4], np.float32)


def _case(blank, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, N, C)).astype(np.float32)
    pad = 0 if blank == "first" else -1
    lo, hi = (1, C) if blank == "first" else (0, C - 1)
    lab = rng.integers(lo, hi, (N, L)).astype(np.float32)
    lab[0, 2:] = pad
    lab[1, 3:] = pad
    lab[4, :] = lab[4, 0]            # one label repeated: blanks between
    return x, lab


@pytest.mark.parametrize("lengths", ["none", "data", "label", "both"])
@pytest.mark.parametrize("blank", ["first", "last"])
def test_loss_and_gradient_match_jax(blank, lengths):
    x, lab = _case(blank)
    dl = DATA_LEN if lengths in ("data", "both") else None
    ll = LABEL_LEN if lengths in ("label", "both") else None
    kw = dict(use_data_lengths=dl is not None,
              use_label_lengths=ll is not None, blank_label=blank)
    # inputs left out are dropped, as the nd / sym frontends drop them: a
    # lone label_lengths lands in the data_lengths slot
    rest = [v for v in (dl, ll) if v is not None]
    want, vjp = jax.vjp(
        lambda d: jseq._ctc_loss(d, jnp.asarray(lab),
                                 *map(jnp.asarray, rest), **kw),
        jnp.asarray(x))
    g = np.random.default_rng(1).uniform(0.5, 1.5, N).astype(np.float32)
    want_g = np.asarray(vjp(jnp.asarray(g))[0])
    d = torch.tensor(x, requires_grad=True)
    got = tseq._ctc_loss(d, torch.tensor(lab),
                         *map(torch.tensor, rest), **kw)
    got.backward(torch.tensor(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5)
    np.testing.assert_allclose(d.grad.numpy(), want_g, atol=1e-5)
    if dl is not None:   # 4 labels in 3 steps cannot align
        assert 1e29 < float(got[2]) < np.inf
    assert np.isfinite(d.grad.numpy()).all()


def test_gluon_ctc_loss_matches_jax():
    """``gluon.loss.CTCLoss`` (NTC layout, label and prediction lengths)
    imperatively and hybridized, and its gradient, against the JAX
    package's Gluon loss."""
    x, lab = _case("first", seed=2)
    pred = np.ascontiguousarray(x.transpose(1, 0, 2))      # NTC
    res = {}
    for pkg in (mx, mt):
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        for hybrid in (False, True):
            loss_fn = pkg.gluon.loss.CTCLoss()
            if hybrid:
                loss_fn.hybridize()
            p = pkg.nd.array(pred, **kw)
            p.attach_grad()
            with pkg.autograd.record():
                loss = loss_fn(p, pkg.nd.array(lab, **kw),
                               pkg.nd.array(DATA_LEN, **kw),
                               pkg.nd.array(LABEL_LEN, **kw))
            loss.backward()
            res[(pkg, hybrid)] = (loss.asnumpy(), p.grad.asnumpy())
    for hybrid in (False, True):
        np.testing.assert_allclose(res[(mt, hybrid)][0],
                                   res[(mx, hybrid)][0], rtol=1e-5)
        np.testing.assert_allclose(res[(mt, hybrid)][1],
                                   res[(mx, hybrid)][1], atol=1e-5)


def test_ctc_through_a_module_and_its_aliases():
    """The symbolic op (alias ``_contrib_CTCLoss``) in a ``Module`` graph
    under ``MakeLoss``: its output equals the imperative op's, and
    the registry names all four aliases."""
    x, lab = _case("last", seed=3)
    data, label = mt.sym.Variable("data"), mt.sym.Variable("label")
    net = mt.sym.MakeLoss(mt.sym.contrib.CTCLoss(data, label,
                                                 blank_label="last"))
    mod = mt.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mt.cpu())
    mod.bind(data_shapes=[("data", (T, N, C))],
             label_shapes=[("label", (N, L))], for_training=False)
    mod.init_params()
    assert net.list_arguments() == ["data", "label"]
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                [mt.nd.array(lab, ctx=mt.cpu())]))
    want = mt.nd.ctc_loss(mt.nd.array(x, ctx=mt.cpu()),
                          mt.nd.array(lab, ctx=mt.cpu()),
                          blank_label="last").asnumpy()
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                               rtol=1e-6)
    for name in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                 "_contrib_ctc_loss"):
        assert mt.ops.registry.get(name).name == "CTCLoss"
