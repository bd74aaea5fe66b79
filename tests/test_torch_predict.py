"""``Module.predict`` / ``iter_predict``, ``Module`` state inputs, and the
executor's random stream (``Dropout``) in the PyTorch port.

``predict`` is held against the JAX package's ``Module.predict`` on the
same padded ``NDArrayIter`` with the same weights; the state tests port
``tests/test_module.py:506,538`` (the JAX package's use LSTM cells, which
the port does not have yet, so a one-layer tanh recurrence stands in for
them in both packages).  Dropout draws from a ``torch.Generator``, not
JAX's bits, so it is checked by statistics.

Tolerances: outputs of the two packages, float32, 1e-5 relative and
1e-6 absolute (two small products and a softmax, summed in other
orders).  Dropout's kept share: within 4 standard deviations of 1 - p
(sqrt(p (1 - p) / n) for n independent draws), a bound a correct draw
breaks about once in 16,000 runs; kept values equal 1 / (1 - p) to
float32 rounding.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

N, B, D_IN, HID, CLS = 50, 20, 6, 8, 3
TOL = dict(rtol=1e-5, atol=1e-6)


def _mlp(pkg, two_outputs=False):
    data = pkg.sym.Variable("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=HID, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=CLS, name="fc2")
    out = pkg.sym.SoftmaxOutput(fc2, name="softmax")
    return pkg.sym.Group([out, fc1]) if two_outputs else out


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": rng.randn(HID, D_IN).astype(np.float32),
            "fc1_bias": rng.randn(HID).astype(np.float32),
            "fc2_weight": rng.randn(CLS, HID).astype(np.float32),
            "fc2_bias": rng.randn(CLS).astype(np.float32)}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, D_IN).astype(np.float32),
            rng.randint(0, CLS, N).astype(np.float32))


def _module(pkg, two_outputs=False):
    mod = pkg.mod.Module(_mlp(pkg, two_outputs), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (B, D_IN))],
             label_shapes=[("softmax_label", (B,))], for_training=False)
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=pkg.cpu())
                                for n, v in _weights().items()})
    return mod


def _iter(pkg):
    x, y = _data()
    return pkg.io.NDArrayIter(x, y, batch_size=B)   # 3 batches, 10 padded


def test_predict_matches_jax_on_a_padded_iterator():
    got = _module(mt).predict(_iter(mt))
    want = _module(mx).predict(_iter(mx))
    assert isinstance(got, mt.nd.NDArray) and got.shape == (N, CLS)
    assert got.context == mt.cpu()
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **TOL)


def test_predict_reads_each_output_back_once():
    mod = _module(mt, two_outputs=True)
    before = mt.profiler.host_syncs().get("predict.readback", 0)
    outs = mod.predict(_iter(mt))
    assert mt.profiler.host_syncs()["predict.readback"] - before == 2
    want = _module(mx, two_outputs=True).predict(_iter(mx))
    assert [o.shape for o in outs] == [(N, CLS), (N, HID)]
    for g, w in zip(outs, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), **TOL)


def test_predict_options():
    mod = _module(mt)
    listed = mod.predict(_iter(mt), always_output_list=True)
    assert isinstance(listed, list) and listed[0].shape == (N, CLS)
    per_batch = mod.predict(_iter(mt), merge_batches=False)
    assert [len(b) for b in per_batch] == [1, 1, 1]
    assert [b[0].shape[0] for b in per_batch] == [B, B, N - 2 * B]
    np.testing.assert_array_equal(
        np.concatenate([b[0].asnumpy() for b in per_batch]),
        listed[0].asnumpy())
    two = mod.predict(_iter(mt), num_batch=2)
    assert two.shape == (2 * B, CLS)
    it = _iter(mt)
    for _ in it:
        pass
    assert mod.predict(it, reset=False) == []


def test_iter_predict_matches_jax():
    got = list(_module(mt).iter_predict(_iter(mt)))
    want = list(_module(mx).iter_predict(_iter(mx)))
    assert [n for _, n, _ in got] == [0, 1, 2]
    assert [b.pad for _, _, b in got] == [0, 0, 2 * B - N + B]
    for (go, _, _), (wo, _, _) in zip(got, want):
        assert go[0].shape == wo[0].shape
        np.testing.assert_allclose(go[0].asnumpy(), wo[0].asnumpy(), **TOL)


# --------------------------------------------------------------------------
# state inputs
# --------------------------------------------------------------------------
SB, SH = 4, 5


def _recurrent(pkg):
    """h' = tanh(fc(data) + h); outputs [2 h', h']."""
    data = pkg.sym.Variable("data")
    h = pkg.sym.Variable("h", shape=(SB, SH))
    new_h = pkg.sym.Activation(
        pkg.sym.FullyConnected(data, num_hidden=SH, name="fc") + h,
        act_type="tanh")
    return pkg.sym.Group([new_h * 2.0, new_h])


def _state_module(pkg, for_training=False):
    mod = pkg.mod.Module(_recurrent(pkg), context=pkg.cpu(),
                         label_names=None, state_names=["h"])
    mod.bind(data_shapes=[("data", (SB, 3))], for_training=for_training)
    rng = np.random.RandomState(2)
    mod.init_params(arg_params={
        "fc_weight": pkg.nd.array(rng.randn(SH, 3).astype(np.float32),
                                  ctx=pkg.cpu()),
        "fc_bias": pkg.nd.array(rng.randn(SH).astype(np.float32),
                                ctx=pkg.cpu())})
    return mod


def _state_batch(pkg):
    x = np.random.RandomState(3).randn(SB, 3).astype(np.float32)
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())], [])


def test_states_carry_across_forwards_as_in_jax():
    """set_states(value=) then set_states(states=outputs) over three
    forwards, in both packages (test_module.py:506's sequence)."""
    seen = {}
    for name, pkg in (("jax", mx), ("port", mt)):
        mod = _state_module(pkg)
        mod.set_states(value=1)
        st = mod.get_states()
        assert len(st) == 1 and st[0].shape == (SB, SH)
        np.testing.assert_array_equal(st[0].asnumpy(), 1.0)
        outs = []
        for _ in range(3):
            mod.forward(_state_batch(pkg))
            outs.append([o.asnumpy() for o in mod.get_outputs()])
            mod.set_states(states=mod.get_outputs()[1:])
        seen[name] = outs
    for p, j in zip(seen["port"], seen["jax"]):
        for a, b in zip(p, j):
            np.testing.assert_allclose(a, b, **TOL)
    assert np.abs(seen["port"][0][1] - seen["port"][1][1]).max() > 1e-4


def test_get_states_are_snapshots():
    """test_module.py:538: what get_states returned stays as it was after
    a later forward, set_states(value=) and set_states(states=)."""
    mod = _state_module(mt)
    mod.set_states(value=7)
    saved = mod.get_states()
    mod.forward(_state_batch(mt))
    mod.set_states(states=mod.get_outputs()[1:])
    mod.forward(_state_batch(mt))
    mod.set_states(value=0)
    np.testing.assert_array_equal(saved[0].asnumpy(), 7.0)
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(), 0.0)
    mod.set_states(states=saved)
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(), 7.0)


def test_states_get_no_gradient_and_no_update():
    mod = _state_module(mt, for_training=True)
    assert set(mod.get_params()[0]) == {"fc_weight", "fc_bias"}
    assert mod._exec.grad_req["h"] == "null"
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5})
    mod.set_states(value=0.25)
    saved = mod.get_states()
    w0 = mod.get_params()[0]["fc_weight"].asnumpy()
    mod.forward(_state_batch(mt), is_train=True)
    mod.backward()
    mod.update()
    assert mod._exec.grad_dict["h"] is None
    assert not np.array_equal(mod.get_params()[0]["fc_weight"].asnumpy(),
                              w0)
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(), 0.25)
    np.testing.assert_array_equal(saved[0].asnumpy(), 0.25)


def test_state_names_are_checked():
    with pytest.raises(ValueError, match="state_names"):
        mt.mod.Module(_recurrent(mt), context=mt.cpu(), label_names=None,
                      state_names=["nope"])
    mod = _state_module(mt)
    with pytest.raises(mt.MXNetError, match="exactly one"):
        mod.set_states()
    with pytest.raises(mt.MXNetError, match="2 states"):
        mod.set_states(states=mod.get_states() * 2)


# --------------------------------------------------------------------------
# Dropout and the executor's random stream
# --------------------------------------------------------------------------
def _dropout_exec(p, shape, axes=(), mode="training"):
    data = mt.sym.Variable("data")
    net = mt.sym.Dropout(data, p=p, axes=axes, mode=mode, name="drop")
    ex = mt.executor.Executor.simple_bind(net, ctx=mt.cpu(),
                                          grad_req={"data": "write"},
                                          shapes={"data": shape})
    ex.arg_dict["data"]._set_data(torch.full(shape, 2.0))
    return ex


@pytest.mark.parametrize("p", [0.1, 0.5, 0.8])
def test_dropout_keeps_1_minus_p_and_scales_the_kept(p):
    n = 200_000
    mt.random.seed(0)
    ex = _dropout_exec(p, (n,))
    out = ex.forward(is_train=True)[0].asnumpy()
    kept = out != 0
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs(kept.mean() - (1 - p)) < 4 * sigma, (kept.mean(), 1 - p)
    np.testing.assert_allclose(out[kept], 2.0 / (1 - p), rtol=1e-6)
    # the gradient is the mask: kept / (1 - p), dropped 0
    ex.backward(out_grads=[np.ones(n, np.float32)])
    np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(), out / 2.0,
                               rtol=1e-6)


def test_dropout_axes_share_one_draw():
    mt.random.seed(1)
    ex = _dropout_exec(0.5, (64, 7, 9), axes=(1,))
    out = ex.forward(is_train=True)[0].asnumpy()
    assert np.all(out == out[:, :1, :])        # constant along axis 1
    share = (out[:, 0, :] != 0).mean()         # 576 independent draws
    assert abs(share - 0.5) < 4 * np.sqrt(0.25 / 576)


def test_dropout_is_the_identity_at_inference_unless_always():
    mt.random.seed(2)
    ex = _dropout_exec(0.5, (1000,))
    np.testing.assert_array_equal(ex.forward(is_train=False)[0].asnumpy(),
                                  2.0)
    always = _dropout_exec(0.5, (1000,), mode="always")
    out = always.forward(is_train=False)[0].asnumpy()
    assert 0 < (out == 0).sum() < 1000
    assert set(np.unique(out)) == {0.0, 4.0}


def test_dropout_draws_repeat_after_the_same_seed():
    def draws(seed):
        mt.random.seed(seed)
        ex = _dropout_exec(0.5, (4096,))
        return [ex.forward(is_train=True)[0].asnumpy() for _ in range(2)]
    a, b, c = draws(5), draws(5), draws(6)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])       # each forward draws anew
    assert not np.array_equal(a[0], c[0])


def test_graph_without_dropout_leaves_the_seeded_stream_alone():
    """Binding a graph that draws nothing takes nothing from the
    package's generator, so initializers give the same numbers."""
    mt.random.seed(4)
    first = torch.rand(3, generator=mt.random.generator())
    mt.random.seed(4)
    _module(mt)
    np.testing.assert_array_equal(
        torch.rand(3, generator=mt.random.generator()).numpy(),
        first.numpy())


def test_bucketed_predictor_draws_from_the_seeded_stream():
    """A served graph that draws (``mode="always"``) gets its own
    generator, seeded from the package's as an Executor's is: the same
    ``mt.random.seed`` gives the same replies."""
    from mxnet_tpu_torch.serving.bucketed import BucketedPredictor
    data = mt.sym.Variable("data")
    fc = mt.sym.FullyConnected(data, num_hidden=64, name="fc")
    net = mt.sym.Dropout(fc, p=0.5, mode="always", name="drop")
    rng = np.random.RandomState(3)
    params = {"fc_weight": rng.randn(64, 5).astype(np.float32),
              "fc_bias": np.ones(64, np.float32)}
    x = {"data": rng.randn(3, 5).astype(np.float32)}

    def replies(seed):
        mt.random.seed(seed)
        pred = BucketedPredictor(net, {"data": (5,)}, params, {},
                                 buckets=[4], ctx=mt.cpu())
        return [pred.predict(x)[1][0] for _ in range(2)]
    a, b, c = replies(7), replies(7), replies(8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert not np.array_equal(a[0], a[1])       # each predict draws anew
    assert not np.array_equal(a[0], c[0])
    assert 0 < (a[0] == 0).sum() < a[0].size
