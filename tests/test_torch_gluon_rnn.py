"""Gluon's recurrent blocks of the PyTorch port against the JAX package:
the fused ``gluon.rnn.RNN`` / ``LSTM`` / ``GRU`` layers, the cells and
modifiers of ``gluon.rnn``, the convolutional cells and
``VariationalDropoutCell`` of ``gluon.contrib.rnn``, and a small Gluon
LSTM language model trained a step through ``gluon.Trainer``,
imperatively and hybridized.  Parameters go from the JAX package's
initialized block to the port's by ``convert.gluon_params_to_numpy`` /
``gluon_params_from_numpy``; inputs come from numpy seeds.  The cases of
``tests/test_rnn.py:184-230`` and ``tests/test_gluon_contrib.py``'s rnn
cases are mirrored in the port.

Tolerances (float32): 1e-5 relative and absolute for forwards, input
and parameter gradients and SGD steps (the same recurrences at H <= 16
over T <= 6, summed in another order: about 1e-7 a step); dropout masks
draw from torch generators, not the JAX package's, so they are checked
by their values (0 or 1 / (1 - p)) and by being the same at every step.
"""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, autograd, nd
from mxnet_tpu_torch.gluon import contrib
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CPU = mt.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_default():
    with CPU:
        yield


@contextlib.contextmanager
def _fresh_names():
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def _pair(make, init=None):
    """The same block in both packages (``make(pkg)``), the JAX one
    initialized (Xavier), the port's given its values once the JAX one
    has run; returns (jax block, port block)."""
    with _fresh_names():
        jb, tb = make(mx), make(mt)
    jb.collect_params().initialize(init or mx.initializer.Xavier())
    tb.collect_params().initialize()
    return jb, tb


def _carry(jb, tb):
    mt.convert.gluon_params_from_numpy(
        tb.collect_params(),
        mt.convert.gluon_params_to_numpy(jb.collect_params()))


def _grads(block):
    return {n: p.grad().asnumpy() for n, p in
            block.collect_params().items() if p.grad_req != 'null'}


def _run(pkg, block, x, states, w):
    """Forward under record, loss sum(out * w), backward; returns
    (outputs as numpy, input gradient)."""
    x = pkg.nd.array(x)
    x.attach_grad()
    st = [pkg.nd.array(s) for s in states] if states is not None else None
    with pkg.autograd.record():
        out = block(x, st) if st is not None else block(x)
        outs = [out[0]] + list(out[1]) if st is not None else [out]
        loss = pkg.nd.sum(outs[0] * pkg.nd.array(w))
    loss.backward()
    return [o.asnumpy() for o in outs], x.grad.asnumpy()


@pytest.mark.parametrize("cls,extra", [
    ("LSTM", {}), ("GRU", {}), ("RNN", {"activation": "tanh"}),
    ("RNN", {"activation": "relu"})])
@pytest.mark.parametrize("layout,bidir,with_states", [
    ("TNC", False, False), ("NTC", True, True), ("TNC", True, False)])
@pytest.mark.parametrize("hybridize", [False, True])
def test_rnn_layer_matches_jax(cls, extra, layout, bidir, with_states,
                               hybridize):
    """Output, final states, input and parameter gradients of the fused
    layers (two layers), with and without begin states."""
    def make(pkg):
        return getattr(pkg.gluon.rnn, cls)(8, num_layers=2, layout=layout,
                                           bidirectional=bidir,
                                           prefix='rnn_', **extra)
    jb, tb = _pair(make)
    rng = np.random.RandomState(0)
    T, N, I = 5, 3, 6
    x = rng.randn(*((T, N, I) if layout == 'TNC' else (N, T, I))) \
        .astype(np.float32)
    d = 2 if bidir else 1
    states = None
    if with_states:
        n_st = 2 if cls == "LSTM" else 1
        states = [rng.randn(2 * d, N, 8).astype(np.float32) * 0.5
                  for _ in range(n_st)]
    w = rng.randn(*(x.shape[:2] + (8 * d,))).astype(np.float32)
    j_outs, j_dx = _run(mx, jb, x, states, w)
    _carry(jb, tb)
    if hybridize:
        tb.hybridize()
    t_outs, t_dx = _run(mt, tb, x, states, w)
    assert len(t_outs) == len(j_outs)
    for t, j in zip(t_outs, j_outs):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t_dx, j_dx, **TOL)
    jg, tg = _grads(jb), _grads(tb)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)


def test_lstm_layer_states_and_grad():
    """Mirrors test_rnn.py:184 in the port."""
    x = nd.array(np.random.RandomState(0).randn(5, 3, 8).astype('float32'))
    lstm = gluon.rnn.LSTM(16, num_layers=2, bidirectional=True)
    lstm.initialize(mt.init.Xavier())
    assert lstm(x).shape == (5, 3, 32)
    st = lstm.begin_state(batch_size=3, ctx=CPU)
    out, st2 = lstm(x, st)
    assert out.shape == (5, 3, 32)
    assert [tuple(s.shape) for s in st2] == [(4, 3, 16), (4, 3, 16)]
    with autograd.record():
        loss = nd.sum(lstm(x))
    loss.backward()
    assert float(lstm.l0_i2h_weight.grad().asnumpy().std()) > 0


def test_fused_layer_matches_cell():
    """Mirrors test_rnn.py:201: the fused layer equals the LSTMCell
    unrolled over the same weights."""
    x = nd.array(np.random.RandomState(1).randn(5, 3, 8).astype('float32'))
    lstm = gluon.rnn.LSTM(6, num_layers=1)
    lstm.initialize(mt.init.Xavier())
    ref = lstm(x).asnumpy()
    cell = gluon.rnn.LSTMCell(6)
    cell.initialize()
    cell(x[0], cell.begin_state(batch_size=3, ctx=CPU))
    for nm in ['i2h_weight', 'h2h_weight', 'i2h_bias', 'h2h_bias']:
        getattr(cell, nm).set_data(getattr(lstm, f'l0_{nm}').data())
    outs, _ = cell.unroll(5, x, layout='TNC', merge_outputs=True)
    np.testing.assert_allclose(outs.asnumpy(), ref, rtol=1e-5, atol=1e-6)


def _cell_run(pkg, cell, x, layout, T):
    x = pkg.nd.array(x)
    x.attach_grad()
    with pkg.autograd.record():
        out, states = cell.unroll(T, x, layout=layout, merge_outputs=True)
        loss = pkg.nd.sum(out * out) + sum(pkg.nd.sum(s) for s in states)
    loss.backward()
    return [out.asnumpy()] + [s.asnumpy() for s in states], \
        x.grad.asnumpy()


@pytest.mark.parametrize("kind", ["rnn", "lstm", "gru", "stack", "bi"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_cells_unroll_matches_jax(kind, layout):
    def make(pkg):
        r = pkg.gluon.rnn
        if kind == "rnn":
            return r.RNNCell(6, prefix='c_')
        if kind == "lstm":
            return r.LSTMCell(6, prefix='c_')
        if kind == "gru":
            return r.GRUCell(6, prefix='c_')
        if kind == "bi":
            return r.BidirectionalCell(r.LSTMCell(5, prefix='l_'),
                                       r.GRUCell(5, prefix='r_'))
        stack = r.SequentialRNNCell(prefix='s_')
        with stack.name_scope():
            stack.add(r.GRUCell(6, prefix='g0_'))
            stack.add(r.ResidualCell(r.LSTMCell(6, prefix='g1_')))
            stack.add(r.DropoutCell(0.0))
        return stack
    T = 4
    x = np.random.RandomState(2).randn(
        *((3, T, 6) if layout == 'NTC' else (T, 3, 6))).astype(np.float32)
    jb, tb = _pair(make)
    j_outs, j_dx = _cell_run(mx, jb, x, layout, T)
    _carry(jb, tb)
    t_outs, t_dx = _cell_run(mt, tb, x, layout, T)
    for t, j in zip(t_outs, j_outs):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t_dx, j_dx, **TOL)
    jg, tg = _grads(jb), _grads(tb)
    assert sorted(jg) == sorted(tg)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)


def test_zoneout_cell_by_statistics():
    """Gluon's ZoneoutCell keeps the previous output (zeros at the first
    step) with probability p in training and is the base cell outside."""
    p = 0.4
    base = gluon.rnn.RNNCell(40, input_size=5)
    cell = gluon.rnn.ZoneoutCell(base, zoneout_outputs=p)
    cell.collect_params().initialize(mt.init.Xavier())
    x = nd.array(np.random.RandomState(3).randn(30, 2, 5)
                 .astype(np.float32))
    infer, _ = cell.unroll(2, x, layout='NTC', merge_outputs=True)
    with autograd.record():
        train, _ = cell.unroll(2, x, layout='NTC', merge_outputs=True)
    t0, i0 = train.asnumpy()[:, 0], infer.asnumpy()[:, 0]
    zeroed = (t0 == 0) & (i0 != 0)
    assert np.all((t0 == i0) | zeroed)
    share = zeroed.mean()
    assert abs(share - p) < 4 * (p * (1 - p) / t0.size) ** 0.5


@pytest.mark.parametrize("cls,dims", [
    ("Conv1DRNNCell", 1), ("Conv2DRNNCell", 2), ("Conv3DRNNCell", 3),
    ("Conv1DLSTMCell", 1), ("Conv2DLSTMCell", 2), ("Conv3DLSTMCell", 3),
    ("Conv1DGRUCell", 1), ("Conv2DGRUCell", 2), ("Conv3DGRUCell", 3)])
def test_conv_cells_match_jax(cls, dims):
    """Mirrors test_gluon_contrib.py:11-53 against the JAX package: two
    steps from the begin state, and the unrolled gradient.  The JAX
    block's Xavier weights are drawn after seeding the JAX package's
    generator here, so that they do not depend on which tests ran before
    in the worker: the 3-D cells' weight gradients are sums of up to
    5^3 x 27 products reaching 46 in magnitude, whose float32 rounding in
    the two packages' orders took 0.36 to 1.33 of the 1e-5 budget over
    twelve seeds of that generator."""
    mx.random.seed(0)
    N, C, hid, T = 2, 3, 4, 2
    spatial = (5,) * dims

    def make(pkg):
        return getattr(pkg.gluon.contrib.rnn, cls)(
            input_shape=(C,) + spatial, hidden_channels=hid, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1, prefix='cc_')
    jb, tb = _pair(make)
    x = np.random.RandomState(0).randn(N, T, C, *spatial) \
        .astype(np.float32)
    j_outs, j_dx = _cell_run(mx, jb, x, 'NTC', T)
    _carry(jb, tb)
    t_outs, t_dx = _cell_run(mt, tb, x, 'NTC', T)
    assert t_outs[0].shape == (N, T, hid) + spatial
    for t, j in zip(t_outs, j_outs):
        np.testing.assert_allclose(t, j, **TOL)
    np.testing.assert_allclose(t_dx, j_dx, **TOL)
    jg, tg = _grads(jb), _grads(tb)
    for n in jg:
        np.testing.assert_allclose(tg[n], jg[n], **TOL, err_msg=n)


def test_variational_dropout_mask_constant_across_steps():
    """Mirrors test_gluon_contrib.py:56."""
    N, I, hid, T = 3, 8, 6, 5
    base = gluon.rnn.RNNCell(hid, input_size=I)
    cell = contrib.rnn.VariationalDropoutCell(base, drop_inputs=0.5,
                                              drop_outputs=0.5)
    cell.collect_params().initialize()
    x = nd.array(np.ones((N, T, I), 'float32'))
    with autograd.record():
        outputs, _ = cell.unroll(T, x, layout='NTC', merge_outputs=False)
    m_in = cell.drop_inputs_mask.asnumpy()
    assert set(np.unique(m_in.round(4))) <= {0.0, 2.0}
    m_out = cell.drop_outputs_mask.asnumpy()
    assert m_out.shape == (N, hid)
    outs = np.stack([o.asnumpy() for o in outputs], axis=1)
    killed = m_out == 0.0
    assert killed.any()
    assert np.allclose(outs[np.broadcast_to(killed[:, None, :],
                                            outs.shape)], 0.0)


def test_variational_dropout_eval_mode_identity():
    """Mirrors test_gluon_contrib.py:81."""
    base = gluon.rnn.RNNCell(4, input_size=3)
    cell = contrib.rnn.VariationalDropoutCell(base, drop_inputs=0.9,
                                              drop_outputs=0.9)
    cell.collect_params().initialize()
    x = nd.array(np.random.RandomState(3).randn(2, 4, 3).astype('float32'))
    outputs, _ = cell.unroll(4, x, layout='NTC', merge_outputs=True)
    base2 = gluon.rnn.RNNCell(4, input_size=3,
                              params=base.collect_params())
    cell.reset()
    ref, _ = base2.unroll(4, x, layout='NTC', merge_outputs=True)
    np.testing.assert_allclose(outputs.asnumpy(), ref.asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_chunked_lm_head_raises_naming_its_item():
    """ChunkedLMHead raised until its op was ported (C1.b.2); now it
    computes the JAX block's per-token loss from the same weights, and
    raises only for a width it cannot take (``tests/
    test_torch_chunked_loss.py`` holds its gradient)."""
    rng = np.random.RandomState(0)
    h = rng.randn(6, 8).astype(np.float32)
    w = (rng.randn(100, 8) * 0.3).astype(np.float32)
    lab = rng.randint(0, 100, 6).astype(np.float32)
    losses = []
    for pkg, cn in ((mx, mx.gluon.contrib), (mt, contrib)):
        kw = {"ctx": mt.cpu()} if pkg is mt else {}
        with pkg.name.NameManager():
            head = cn.nn.ChunkedLMHead(100, 8, num_chunks=3)
        head.initialize(**kw)
        head.weight.set_data(pkg.nd.array(w, **kw))
        losses.append(head(pkg.nd.array(h, **kw),
                           pkg.nd.array(lab, **kw)).asnumpy())
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="in_units"):
        contrib.nn.ChunkedLMHead(100, 0)


# --------------------------------------------------------------------------
# a Gluon LSTM language model: Embedding -> LSTM -> Dense, a Trainer step
# --------------------------------------------------------------------------
def _lm(pkg, V, E, H, L):
    net = pkg.gluon.nn.HybridSequential(prefix='lm_')
    with net.name_scope():
        net.add(pkg.gluon.nn.Embedding(V, E))
        net.add(pkg.gluon.rnn.LSTM(H, num_layers=L, layout='NTC'))
        net.add(pkg.gluon.nn.Dense(V, flatten=False))
    return net


def _lm_step(pkg, net, x, y, steps=2):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                {'learning_rate': 0.5, 'momentum': 0.9})
    losses = []
    for _ in range(steps):
        with pkg.autograd.record():
            loss = loss_fn(net(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(loss.asnumpy())
    return losses


@pytest.mark.parametrize("hybridize", [False, True])
def test_gluon_lstm_lm_trainer_steps_match_jax(hybridize):
    V, E, H, L, N, T = 30, 8, 12, 2, 4, 6
    rng = np.random.RandomState(4)
    x = rng.randint(0, V, (N, T)).astype(np.int32)
    y = rng.randint(0, V, (N, T)).astype(np.int32)
    jb, tb = _pair(lambda pkg: _lm(pkg, V, E, H, L))
    jb(mx.nd.array(x))  # finish the deferred shapes
    _carry(jb, tb)
    if hybridize:
        jb.hybridize()
        tb.hybridize()
    j_losses = _lm_step(mx, jb, x, y)
    t_losses = _lm_step(mt, tb, x, y)
    for t, j in zip(t_losses, j_losses):
        np.testing.assert_allclose(t, j, **TOL)
    assert t_losses[1].mean() < t_losses[0].mean()
    jp = mt.convert.gluon_params_to_numpy(jb.collect_params())
    tp = mt.convert.gluon_params_to_numpy(tb.collect_params())
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], **TOL, err_msg=n)


def test_gluon_lstm_lm_hybridized_equals_imperative():
    V, E, H, L = 30, 8, 12, 2
    x = np.random.RandomState(5).randint(0, V, (3, 5)).astype(np.int32)
    with _fresh_names():
        net = _lm(mt, V, E, H, L)
    net.initialize(mt.init.Xavier())
    imp = net(nd.array(x)).asnumpy()
    net.hybridize()
    hyb = net(nd.array(x)).asnumpy()
    np.testing.assert_allclose(hyb, imp, rtol=1e-6, atol=1e-6)
