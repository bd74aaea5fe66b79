"""The RNN slice of the PyTorch port against the JAX package: the fused
``RNN`` op, the sequence ops, the ``LSTMBias`` / ``FusedRNN``
initializers, the symbolic cells (``mxnet_tpu_torch.rnn``),
``BucketSentenceIter`` and ``BucketingModule``.  The cases of
``tests/test_rnn.py:11-346`` that concern these modules are mirrored
here; the Gluon ones are in ``test_torch_gluon_rnn.py``.

Inputs come from numpy seeds and go through both packages.  Tolerances
(float32):
* the ``RNN`` op forward at T <= 8, H <= 16: 1e-5 relative and absolute
  (the same recurrence; the port's PyTorch loop and the JAX scan sum the
  gate products in other orders, about 1e-7 a step);
* its gradients (``jax.vjp`` against autograd): 1e-5 of the largest
  gradient of each input (a backward through T steps adds the rounding
  of every step; relative to each element would ask more of elements
  near 0 than f32 holds);
* the sequence ops and initializers: exact or 1e-6 (no arithmetic
  beyond one division);
* symbolic cells, unrolled forwards and gradients: 1e-5 (the cells are
  the same graphs of FullyConnected and elementwise ops);
* ``BucketingModule`` SGD steps over several buckets: 1e-5 relative and
  absolute on every parameter after each epoch (a few steps of small
  products).
Dropout, zoneout and the RNN op's dropout between layers draw from
torch generators, whose bits are not the JAX package's, so they are
checked by statistics: the kept share within 4 standard deviations of
1 - p, and the kept values scaled by 1 / (1 - p).
"""
import json
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn as trnn
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CPU = mt.cpu()
FWD = dict(rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the fused RNN op
# --------------------------------------------------------------------------
def _rnn_inputs(mode, L, bidir, T=6, N=3, I=5, H=7, seed=0):
    rng = np.random.RandomState(seed)
    d = 2 if bidir else 1
    n = trnn.rnn_param_size(L, I, H, bidir, mode)
    x = rng.randn(T, N, I).astype(np.float32)
    p = rng.uniform(-0.4, 0.4, (n,)).astype(np.float32)
    h0 = rng.randn(L * d, N, H).astype(np.float32) * 0.5
    c0 = rng.randn(L * d, N, H).astype(np.float32) * 0.5
    return x, p, h0, c0


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("L,bidir", [(1, False), (2, False), (1, True),
                                     (2, True)])
def test_rnn_op_matches_jax(mode, L, bidir):
    """Forward (output and final states) and gradients of every input,
    ``jax.vjp`` against autograd."""
    from mxnet_tpu.ops import rnn as jrnn
    assert trnn.rnn_param_size(L, 5, 7, bidir, mode) == \
        jrnn.rnn_param_size(L, 5, 7, bidir, mode)
    x, p, h0, c0 = _rnn_inputs(mode, L, bidir)
    lstm = mode == "lstm"
    attrs = dict(state_size=7, num_layers=L, bidirectional=bidir, mode=mode,
                 state_outputs=True, is_train=True)
    args = [x, p, h0] + ([c0] if lstm else [])

    def jf(*a):
        return jreg.get("RNN").fn(jax.random.PRNGKey(0), *a, **attrs)
    jout, vjp = jax.vjp(jf, *[jnp.asarray(a) for a in args])
    tins = [torch.tensor(a, requires_grad=True) for a in args]
    tout = treg.get("RNN").fn(*tins, **attrs)
    assert len(tout) == len(jout) == (3 if lstm else 2)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **FWD)
    rng = np.random.RandomState(9)
    ws = [rng.randn(*t.shape).astype(np.float32) for t in tout]
    jgrads = vjp(tuple(jnp.asarray(w) for w in ws))
    tgrads = torch.autograd.grad(tout, tins,
                                 [torch.from_numpy(w) for w in ws])
    for tg, jg in zip(tgrads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(tg.numpy(), jg, rtol=0,
                                   atol=1e-5 * np.abs(jg).max())


@pytest.mark.parametrize("mode", ["lstm", "gru"])
def test_rnn_op_batch1_begin_state_broadcasts(mode):
    """Begin states of batch 1 (``sym.zeros`` with the unknown batch dim
    as 1) are expanded to the batch, as the JAX op broadcasts them."""
    x, p, _, _ = _rnn_inputs(mode, 2, True, N=4)
    z = np.zeros((4, 1, 7), np.float32)
    attrs = dict(state_size=7, num_layers=2, bidirectional=True, mode=mode,
                 state_outputs=True, is_train=False)
    args = [x, p, z] + ([z] if mode == "lstm" else [])
    jout = jreg.get("RNN").fn(jax.random.PRNGKey(0),
                              *[jnp.asarray(a) for a in args], **attrs)
    tout = treg.get("RNN").fn(*[torch.from_numpy(a) for a in args],
                              **attrs)
    assert tout[1].shape == (4, 4, 7)
    for t, j in zip(tout, jout):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **FWD)


@pytest.mark.parametrize("mode", ["gru", "rnn_tanh"])
def test_rnn_state_outputs_count_without_a_cell_state(mode):
    """A GRU or vanilla ``RNN`` with ``state_outputs`` has two outputs
    (out, h).  The JAX package lists three (its node_num_outputs counts
    an LSTM's cell state for every mode), and binding them all fails
    there on the missing third: a reference fault the port does not
    copy (ROADMAP §3)."""
    shapes = {'data': (3, 2, 5)}
    outs = {}
    for pkg in (mx, mt):
        outs[pkg] = pkg.sym.RNN(pkg.sym.Variable('data'), state_size=4,
                                mode=mode, state_outputs=True, name='r')
    assert len(outs[mx].list_outputs()) == 3
    with pytest.raises(KeyError):
        mx.Executor.simple_bind(outs[mx], shapes=shapes).forward()
    assert outs[mt].list_outputs() == ['r_output0', 'r_output1']
    ex = mt.executor.Executor.simple_bind(outs[mt], ctx=CPU, shapes=shapes)
    assert [o.shape for o in ex.forward()] == [(3, 2, 4), (1, 2, 4)]


def test_rnn_op_dropout_between_layers_by_statistics():
    """``p`` drops the first layer's output on its way into the second,
    from the generator, in training only.  A second layer that passes
    its input through (W_x = I, W_h = 0, no bias, relu of a relu output)
    shows the mask: each value is 0 or the first layer's / (1 - p)."""
    T, N, H, p = 8, 64, 16, 0.3
    rng = np.random.RandomState(0)
    n1 = trnn.rnn_param_size(1, H, H, False, "rnn_relu")
    w1 = rng.uniform(-0.5, 0.5, (n1,)).astype(np.float32)
    ws1, bs1 = w1[:2 * H * H], w1[2 * H * H:]
    ws2 = np.concatenate([np.eye(H, dtype=np.float32).ravel(),
                          np.zeros(H * H, np.float32)])
    flat = np.concatenate([ws1, ws2, bs1, np.zeros(2 * H, np.float32)])
    x = torch.from_numpy(rng.randn(T, N, H).astype(np.float32))
    h0 = torch.zeros(2, N, H)
    op = treg.get("RNN").fn
    first = op(x, torch.from_numpy(w1), h0[:1], state_size=H,
               mode="rnn_relu", is_train=False)[0]
    gen = torch.Generator().manual_seed(0)
    out = op(x, torch.from_numpy(flat), h0, state_size=H, num_layers=2,
             mode="rnn_relu", p=p, is_train=True, generator=gen)[0]
    pos = first > 0
    kept = (out != 0) & pos
    share = kept.sum().item() / pos.sum().item()
    sigma = (p * (1 - p) / pos.sum().item()) ** 0.5
    assert abs(share - (1 - p)) < 4 * sigma, share
    np.testing.assert_allclose(out[kept].numpy(),
                               (first[kept] / (1 - p)).numpy(), rtol=1e-6)
    again = op(x, torch.from_numpy(flat), h0, state_size=H, num_layers=2,
               mode="rnn_relu", p=p, is_train=True,
               generator=torch.Generator().manual_seed(0))[0]
    assert torch.equal(out, again)
    infer = op(x, torch.from_numpy(flat), h0, state_size=H, num_layers=2,
               mode="rnn_relu", p=p, is_train=False)[0]
    torch.testing.assert_close(infer, first, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# sequence ops
# --------------------------------------------------------------------------
@pytest.mark.parametrize("op,attrs", [
    ("SequenceMask", dict(use_sequence_length=True, value=-2.0)),
    ("SequenceMask", dict(use_sequence_length=True, axis=1)),
    ("SequenceMask", dict()),
    ("SequenceLast", dict(use_sequence_length=True)),
    ("SequenceLast", dict(use_sequence_length=True, axis=1)),
    ("SequenceLast", dict()),
    ("SequenceReverse", dict(use_sequence_length=True)),
    ("SequenceReverse", dict()),
])
def test_sequence_ops_match_jax(op, attrs):
    rng = np.random.RandomState(0)
    x = rng.randn(5, 4, 3).astype(np.float32)
    # one length per batch row: the batch axis is 1, or 0 when axis=1
    lens = (np.array([4, 1, 3, 4, 2], np.float32) if attrs.get("axis")
            else np.array([5, 1, 3, 4], np.float32))
    args = [x, lens] if attrs.get("use_sequence_length") else [x]
    jout = np.asarray(jreg.get(op).fn(*[jnp.asarray(a) for a in args],
                                      **attrs))
    tins = [torch.tensor(a, requires_grad=(i == 0))
            for i, a in enumerate(args)]
    tout = treg.get(op).fn(*tins, **attrs)
    np.testing.assert_array_equal(tout.detach().numpy(), jout)
    w = rng.randn(*tout.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda d: jreg.get(op).fn(
        d, *[jnp.asarray(a) for a in args[1:]], **attrs), jnp.asarray(x))
    (tg,) = torch.autograd.grad(tout, [tins[0]], torch.from_numpy(w))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(vjp(w)[0]))


def test_sequence_ops_no_phantom_length_arg():
    """Mirrors test_rnn.py:324: without ``use_sequence_length`` no
    length argument appears; with it, the given one is used."""
    d = mt.sym.Variable('d')
    for op in ('SequenceReverse', 'SequenceMask', 'SequenceLast'):
        s = getattr(mt.sym, op)(d)
        assert s.list_arguments() == ['d'], (op, s.list_arguments())
        s2 = getattr(mt.sym, op)(d, mt.sym.Variable('len'),
                                 use_sequence_length=True)
        assert 'len' in s2.list_arguments(), (op, s2.list_arguments())
    cell = mt.rnn.BidirectionalCell(mt.rnn.LSTMCell(4, prefix='l_'),
                                    mt.rnn.LSTMCell(4, prefix='r_'))
    out, _ = cell.unroll(5, inputs=mt.sym.Variable('data'),
                         merge_outputs=True, layout='NTC')
    assert not any('sequence_length' in a for a in out.list_arguments())


def test_ctc_loss_raises_naming_its_item():
    """CTCLoss raised until it was ported (C1.b.2); now uniform
    activations over 3 classes (blank 0) and the label [1] over 2 steps
    give -log of the 3 alignments' probability (1, b1, 1b, each 1/9), as
    the JAX op gives (``tests/test_torch_ctc.py`` holds the rest)."""
    got = treg.get("CTCLoss").fn(torch.zeros(2, 1, 3), torch.ones(1, 1))
    want = mx.nd.CTCLoss(mx.nd.zeros((2, 1, 3)), mx.nd.ones((1, 1)))
    np.testing.assert_allclose(got.numpy(), -np.log([3 / 9]), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), want.asnumpy(), rtol=1e-6)


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------
def test_lstm_bias_initializer_matches_jax():
    ja = mx.nd.zeros((16,))
    mx.initializer.LSTMBias(forget_bias=2.5)(mx.initializer.InitDesc('x_i2h_bias'), ja)
    ta = mt.nd.zeros((16,), ctx=CPU)
    mt.init.LSTMBias(forget_bias=2.5)(mt.init.InitDesc('x_i2h_bias'), ta)
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
    assert mt.init.LSTMBias(2.5).dumps() == mx.initializer.LSTMBias(2.5).dumps()


@pytest.mark.parametrize("mode,bidir", [("lstm", False), ("gru", True),
                                        ("rnn_tanh", False)])
def test_fused_rnn_initializer_matches_jax(mode, bidir):
    """With a deterministic inner initializer the packed vectors are
    equal: weights by the weight rule, biases 0, forget biases set."""
    n = trnn.rnn_param_size(2, 5, 6, bidir, mode)
    ja = mx.nd.zeros((n,))
    mx.initializer.FusedRNN(mx.initializer.Constant(0.25), 6, 2, mode, bidir, 3.0)(
        mx.initializer.InitDesc('rnn_parameters'), ja)
    ta = mt.nd.zeros((n,), ctx=CPU)
    init = mt.init.FusedRNN(mt.init.Constant(0.25), 6, 2, mode, bidir, 3.0)
    init(mt.init.InitDesc('rnn_parameters'), ta)
    np.testing.assert_array_equal(ta.asnumpy(), ja.asnumpy())
    # the string form round-trips through the variable's __init__ attr
    klass, kwargs = json.loads(init.dumps())
    again = mt.init.create(klass, **kwargs)
    tb = mt.nd.zeros((n,), ctx=CPU)
    again(mt.init.InitDesc('rnn_parameters'), tb)
    np.testing.assert_array_equal(tb.asnumpy(), ja.asnumpy())


def test_fused_pack_weights_roundtrip_and_init():
    """Mirrors test_rnn.py:296 in the port: the FusedRNN initializer
    under a global Xavier fills the weights, zeroes the biases and sets
    every forget bias; unpack then pack gives the vector back."""
    H = 8
    cell = mt.rnn.FusedRNNCell(H, num_layers=2, mode='lstm',
                               prefix='lstm_', forget_bias=2.0)
    out, _ = cell.unroll(3, mt.sym.Variable('data'), merge_outputs=True,
                         layout='TNC')
    ex = mt.executor.Executor.simple_bind(out, ctx=CPU,
                                          shapes={'data': (3, 2, 5)})
    arr = ex.arg_dict['lstm_parameters']
    mt.init.FusedRNN(None, H, 2, 'lstm', False, 2.0)(
        mt.init.InitDesc('lstm_parameters',
                         global_init=mt.init.Xavier()), arr)
    p = arr.asnumpy()
    assert (p != 0).mean() > 0.5
    args = cell.unpack_weights({'lstm_parameters': mt.nd.array(p, ctx=CPU)})
    np.testing.assert_allclose(args['lstm_l0_i2h_f_bias'].asnumpy(), 2.0)
    np.testing.assert_allclose(args['lstm_l1_h2h_f_bias'].asnumpy(), 2.0)
    np.testing.assert_allclose(args['lstm_l1_h2h_o_bias'].asnumpy(), 0.0)
    assert np.abs(args['lstm_l1_i2h_c_weight'].asnumpy()).max() > 0
    rt = cell.pack_weights(args)['lstm_parameters'].asnumpy()
    np.testing.assert_array_equal(rt, p)


def test_variable_init_attr_reaches_module_init_params():
    """A cell's ``Variable(init=...)`` is kept as ``__init__`` and
    ``Module.init_params`` applies it (LSTMCell's forget bias)."""
    cell = mt.rnn.LSTMCell(4, prefix='c_', forget_bias=1.5)
    out, _ = cell.unroll(2, mt.sym.Variable('data'), merge_outputs=True)
    attrs = out.attr_dict()
    assert attrs['c_i2h_bias']['__init__'] == \
        mx.initializer.LSTMBias(forget_bias=1.5).dumps()
    mod = mt.mod.Module(out, data_names=['data'], label_names=None,
                        context=CPU)
    mod.bind(data_shapes=[('data', (3, 2, 5))], for_training=False)
    mod.init_params(mt.init.Xavier())
    b = mod.get_params()[0]['c_i2h_bias'].asnumpy()
    np.testing.assert_array_equal(b, np.r_[np.zeros(4), np.full(4, 1.5),
                                           np.zeros(8)])


# --------------------------------------------------------------------------
# symbolic cells
# --------------------------------------------------------------------------
def _bind(pkg, sym, shapes):
    if pkg is mx:
        return mx.Executor.simple_bind(sym, shapes=shapes, grad_req='write')
    return mt.executor.Executor.simple_bind(sym, ctx=CPU, shapes=shapes,
                                            grad_req='write')


def _run_cells(build, shapes, seed=0, scale=0.3):
    """Build the unrolled symbol in both packages, give every argument
    the same seeded values, run a training forward and a backward seeded
    with ones; compare outputs and gradients."""
    syms = {pkg: build(pkg) for pkg in (mx, mt)}
    assert syms[mx].list_arguments() == syms[mt].list_arguments()
    exs = {pkg: _bind(pkg, s, shapes) for pkg, s in syms.items()}
    rng = np.random.RandomState(seed)
    vals = {n: rng.uniform(-scale, scale, a.shape).astype(np.float32)
            if n not in shapes else rng.randn(*a.shape).astype(np.float32)
            for n, a in exs[mx].arg_dict.items()}
    outs = {}
    for pkg, ex in exs.items():
        for n, v in vals.items():
            ex.arg_dict[n]._set_data(np.asarray(v) if pkg is mx
                                     else torch.from_numpy(v))
        outs[pkg] = [o.asnumpy() for o in ex.forward(is_train=True)]
        ex.backward()
    for t, j in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(t, j, **FWD)
    for n in vals:
        g_j = exs[mx].grad_dict[n]
        if g_j is not None:
            np.testing.assert_allclose(exs[mt].grad_dict[n].asnumpy(),
                                       g_j.asnumpy(), **FWD)
    return outs[mt]


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
@pytest.mark.parametrize("layout", ["NTC", "TNC"])
def test_unfused_cell_unroll_matches_jax(cell, layout):
    def build(pkg):
        c = {"rnn": lambda: pkg.rnn.RNNCell(6, prefix='c_'),
             "lstm": lambda: pkg.rnn.LSTMCell(6, prefix='c_'),
             "gru": lambda: pkg.rnn.GRUCell(6, prefix='c_')}[cell]()
        out, states = c.unroll(4, pkg.sym.Variable('data'),
                               merge_outputs=True, layout=layout)
        return pkg.sym.Group([out] + states)
    shape = (3, 4, 5) if layout == 'NTC' else (4, 3, 5)
    outs = _run_cells(build, {'data': shape})
    assert outs[0].shape == shape[:2] + (6,)


@pytest.mark.parametrize("mode", ["lstm", "gru", "rnn_tanh", "rnn_relu"])
@pytest.mark.parametrize("bidir", [False, True])
def test_fused_cell_unroll_matches_jax(mode, bidir):
    def build(pkg):
        c = pkg.rnn.FusedRNNCell(6, num_layers=2, mode=mode,
                                 bidirectional=bidir, prefix='f_',
                                 get_next_state=True)
        out, states = c.unroll(4, pkg.sym.Variable('data'),
                               merge_outputs=True, layout='NTC')
        return pkg.sym.Group([out] + states)
    outs = _run_cells(build, {'data': (3, 4, 5)})
    d = 2 if bidir else 1
    assert outs[0].shape == (3, 4, 6 * d)
    assert outs[1].shape == (2 * d, 3, 6)
    assert len(outs) == (3 if mode == "lstm" else 2)


def test_fused_matches_unfused():
    """Mirrors test_rnn.py:24: the fused op against its unfuse() stack,
    with the fused parameters unpacked into the unfused names."""
    T, N, I, H = 5, 3, 8, 10
    fused = mt.rnn.FusedRNNCell(H, num_layers=2, mode='lstm',
                                prefix='lstm_')
    data = mt.sym.Variable('data')
    f_out, _ = fused.unroll(T, inputs=data, merge_outputs=True,
                            layout='TNC')
    f_ex = mt.executor.Executor.simple_bind(f_out, ctx=CPU,
                                            shapes={'data': (T, N, I)})
    stack = fused.unfuse()
    u_out, _ = stack.unroll(T, inputs=data, merge_outputs=True,
                            layout='TNC')
    u_ex = mt.executor.Executor.simple_bind(u_out, ctx=CPU,
                                            shapes={'data': (T, N, I)})
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(T, N, I).astype('float32'))
    psize = f_ex.arg_dict['lstm_parameters'].shape[0]
    params = rng.uniform(-0.1, 0.1, (psize,)).astype('float32')
    f_ex.arg_dict['lstm_parameters']._set_data(torch.from_numpy(params))
    unpacked = stack.pack_weights(fused.unpack_weights(
        {'lstm_parameters': mt.nd.array(params, ctx=CPU)}))
    for k, v in unpacked.items():
        if k in u_ex.arg_dict:
            u_ex.arg_dict[k]._set_data(v._data)
    f_res = f_ex.forward(data=x)[0].asnumpy()
    u_res = u_ex.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(f_res, u_res, rtol=1e-4, atol=1e-5)


def test_stacked_residual_bidirectional_cells_match_jax():
    def build(pkg):
        stack = pkg.rnn.SequentialRNNCell()
        stack.add(pkg.rnn.GRUCell(5, prefix='g0_'))
        stack.add(pkg.rnn.ResidualCell(pkg.rnn.GRUCell(5, prefix='g1_')))
        stack.add(pkg.rnn.BidirectionalCell(
            pkg.rnn.LSTMCell(4, prefix='l_'),
            pkg.rnn.LSTMCell(4, prefix='r_')))
        out, states = stack.unroll(3, pkg.sym.Variable('data'),
                                   merge_outputs=True)
        return pkg.sym.Group([out] + states)
    outs = _run_cells(build, {'data': (2, 3, 5)})
    assert outs[0].shape == (2, 3, 8)


def test_dropout_cell_by_statistics():
    p = 0.25
    stack = mt.rnn.SequentialRNNCell()
    stack.add(mt.rnn.DropoutCell(p))
    out, _ = stack.unroll(5, mt.sym.Variable('data'), merge_outputs=True)
    ex = mt.executor.Executor.simple_bind(out, ctx=CPU, grad_req='null',
                                          shapes={'data': (40, 5, 20)})
    x = torch.rand(40, 5, 20) + 0.5
    y = ex.forward(is_train=True, data=x)[0]._data
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) < 4 * (p * (1 - p) / y.numel()) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / (1 - p))
    torch.testing.assert_close(ex.forward(is_train=False, data=x)[0]._data,
                               x)


def test_zoneout_cell_by_statistics():
    """Zoneout keeps the previous output (zeros at the first step) with
    probability p; at inference it is the base cell."""
    p = 0.4
    z = mt.rnn.ZoneoutCell(mt.rnn.RNNCell(30, prefix='z_'),
                           zoneout_outputs=p, zoneout_states=0.0)
    out, _ = z.unroll(3, mt.sym.Variable('data'), merge_outputs=True)
    ex = mt.executor.Executor.simple_bind(out, ctx=CPU, grad_req='null',
                                          shapes={'data': (50, 3, 8)})
    rng = np.random.RandomState(0)
    for n, a in ex.arg_dict.items():
        a._set_data(torch.from_numpy(
            rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)))
    train = ex.forward(is_train=True)[0]._data
    infer = ex.forward(is_train=False)[0]._data
    t0, i0 = train[:, 0], infer[:, 0]
    zeroed = (t0 == 0) & (i0 != 0)
    assert torch.all((t0 == i0) | zeroed)
    share = zeroed.float().mean().item()
    assert abs(share - p) < 4 * (p * (1 - p) / t0.numel()) ** 0.5


@pytest.mark.parametrize("cls,nstates", [
    ("ConvRNNCell", 1), ("ConvLSTMCell", 2), ("ConvGRUCell", 1)])
def test_conv_rnn_cells_match_jax(cls, nstates):
    """Mirrors test_rnn.py:245-293 against the JAX package."""
    T, N, C, H, W = 3, 2, 4, 6, 6

    def build(pkg):
        cell = getattr(pkg.rnn, cls)(input_shape=(N, C, H, W), num_hidden=5,
                                     prefix=cls + '_')
        out, states = cell.unroll(T, inputs=pkg.sym.Variable('data'),
                                  merge_outputs=True, layout='NTC')
        assert len(states) == nstates
        return pkg.sym.sum(out)
    _run_cells(build, {'data': (N, T, C, H, W)}, scale=0.1)


def test_lstm_cell_unroll_shapes():
    """Mirrors test_rnn.py:11."""
    cell = mt.rnn.LSTMCell(num_hidden=16, prefix='lstm_')
    outputs, _ = cell.unroll(4, inputs=mt.sym.Variable('data'),
                             merge_outputs=True, layout='NTC')
    assert {'lstm_i2h_weight', 'lstm_i2h_bias', 'lstm_h2h_weight',
            'lstm_h2h_bias'} <= set(outputs.list_arguments())
    ex = mt.executor.Executor.simple_bind(outputs, ctx=CPU,
                                          shapes={'data': (2, 4, 8)})
    assert ex.forward()[0].shape == (2, 4, 16)


# --------------------------------------------------------------------------
# BucketSentenceIter and BucketingModule
# --------------------------------------------------------------------------
def _sentences(seed=0, n=64, V=20):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start, ln = rng.randint(1, V), rng.randint(3, 10)
        out.append([(start + k) % (V - 1) + 1 for k in range(ln)])
    return out


def _seed_all(seed):
    random.seed(seed)
    np.random.seed(seed)


@pytest.mark.parametrize("layout", ["NT", "TN"])
def test_bucket_sentence_iter_matches_jax(layout):
    """The same seeds give the same batches, in the same order, in both
    packages (both shuffle with ``random`` and the global np.random)."""
    sents = _sentences()
    batches = {}
    for pkg in (mx, mt):
        _seed_all(3)
        it = pkg.rnn.BucketSentenceIter(sents, batch_size=4, buckets=[5, 10],
                                        invalid_label=0, layout=layout)
        batches[pkg] = [(b.bucket_key, b.data[0].asnumpy(),
                         b.label[0].asnumpy(), b.provide_data[0].shape)
                        for b in it]
        assert it.default_bucket_key == 10
    assert len(batches[mt]) == len(batches[mx]) > 4
    for t, j in zip(batches[mt], batches[mx]):
        assert t[0] == j[0] and t[3] == j[3]
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_array_equal(t[2], j[2])


def test_bucket_iter_int32_and_empty_bucket():
    """Mirrors test_rnn.py:232; ``dtype="int32"`` gives int32 batches and
    descriptions (ids under a bf16 compute dtype)."""
    it = mt.rnn.BucketSentenceIter([[1, 2], [2, 3], [1, 3], [3, 1]],
                                   batch_size=2, buckets=[4, 8],
                                   invalid_label=0, dtype='int32')
    batch = next(iter(it))
    assert batch.bucket_key == 4
    assert batch.data[0].dtype == np.int32
    assert batch.provide_data[0].dtype == np.int32
    assert batch.data[0].context == CPU
    np.testing.assert_array_equal(batch.label[0].asnumpy()[:, :-1],
                                  batch.data[0].asnumpy()[:, 1:])


def _lm_sym_gen(pkg, V, E, H, fused=False):
    if fused:
        cell = pkg.rnn.FusedRNNCell(H, num_layers=1, mode='lstm',
                                    prefix='lstm_')
    else:
        cell = pkg.rnn.SequentialRNNCell()
        cell.add(pkg.rnn.LSTMCell(num_hidden=H, prefix='lstm_l0_'))

    def sym_gen(seq_len):
        data = pkg.sym.Variable('data')
        label = pkg.sym.Variable('softmax_label')
        embed = pkg.sym.Embedding(data, input_dim=V, output_dim=E,
                                  name='embed')
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = pkg.sym.Reshape(outputs, shape=(-1, H))
        pred = pkg.sym.FullyConnected(pred, num_hidden=V, name='pred')
        label_r = pkg.sym.Reshape(label, shape=(-1,))
        pred = pkg.sym.SoftmaxOutput(pred, label_r, name='softmax')
        return pred, ('data',), ('softmax_label',)
    return sym_gen


@pytest.mark.parametrize("fused", [False, True])
def test_bucketing_module_sgd_matches_jax(fused):
    """SGD with momentum over two epochs of batches from two buckets:
    every parameter equals the JAX BucketingModule's after each epoch;
    every bucket holds the default bucket's arrays and binds once."""
    V, E, H = 20, 8, 12
    sents = _sentences(1)
    rng = np.random.RandomState(2)
    sym0 = _lm_sym_gen(mx, V, E, H, fused)(10)[0]
    shapes = dict(zip(sym0.list_arguments(), sym0.infer_shape(
        data=(8, 10), softmax_label=(8, 10))[0]))
    init = {n: rng.uniform(-0.2, 0.2, s).astype(np.float32)
            for n, s in shapes.items()
            if n not in ('data', 'softmax_label')}
    got = {}
    for pkg in (mx, mt):
        _seed_all(5)
        it = pkg.rnn.BucketSentenceIter(sents, batch_size=8,
                                        buckets=[5, 10], invalid_label=0)
        kw = {} if pkg is mx else dict(context=CPU)
        mod = pkg.mod.BucketingModule(_lm_sym_gen(pkg, V, E, H, fused),
                                      default_bucket_key=10, **kw)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        mod.init_params(arg_params={n: pkg.nd.array(v, **(
            {} if pkg is mx else dict(ctx=CPU))) for n, v in init.items()})
        mod.init_optimizer(optimizer='sgd', optimizer_params={
            'learning_rate': 0.5, 'momentum': 0.9})
        epochs, execs = [], []
        for _ in range(2):
            it.reset()
            for batch in it:
                mod.forward(batch, is_train=True)
                mod.backward()
                mod.update()
            epochs.append({n: a.asnumpy()
                           for n, a in mod.get_params()[0].items()})
            execs.append({k: m._exec for k, m in mod._buckets.items()})
        got[pkg] = epochs
        assert sorted(mod._buckets) == [5, 10]
        if pkg is mt:
            # a revisited bucket keeps its executor (test_rnn.py:346)
            assert all(execs[1][k] is e for k, e in execs[0].items())
            p5 = mod._buckets[5]._exec.arg_dict
            p10 = mod._buckets[10]._exec.arg_dict
            assert all(p5[n] is p10[n] for n in init)
            assert mod._buckets[5]._updater is mod._buckets[10]._updater
    for t, j in zip(got[mt], got[mx]):
        for n in init:
            np.testing.assert_allclose(t[n], j[n], **FWD, err_msg=n)
        assert any(np.abs(t[n] - init[n]).max() > 1e-3 for n in init)


def test_bucketing_module_trains():
    """Mirrors test_rnn.py:116 in the port: perplexity drops by 20% over
    four epochs of Adam through two buckets."""
    _seed_all(0)
    mt.random.seed(0)
    V, E, H = 20, 8, 16
    it = mt.rnn.BucketSentenceIter(_sentences(), batch_size=8,
                                   buckets=[5, 10], invalid_label=0,
                                   dtype='int32')
    mod = mt.mod.BucketingModule(_lm_sym_gen(mt, V, E, H),
                                 default_bucket_key=it.default_bucket_key,
                                 context=CPU)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer='adam',
                       optimizer_params={'learning_rate': 0.02})
    metric = mt.metric.Perplexity(0)

    def run_epoch():
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.update_metric(metric, batch.label)
            mod.backward()
            mod.update()
        return metric.get()[1]
    first = run_epoch()
    for _ in range(3):
        last = run_epoch()
    assert last < first * 0.8, (first, last)
    assert len(mod._buckets) == 2


def test_bucketing_module_carries_states_across_buckets():
    """State inputs (``state_names``) carry across a switch: the state a
    bucket's forward leaves is the next bucket's begin state."""
    H = 4

    def sym_gen(seq_len):
        data = mt.sym.Variable('data')
        h = mt.sym.Variable('h0', shape=(2, H))
        cell = mt.rnn.RNNCell(H, prefix='r_')
        out, states = cell.unroll(seq_len, data, begin_state=[h],
                                  merge_outputs=True)
        return mt.sym.Group([mt.sym.sum(out), states[0]]), ('data',), ()

    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=4,
                                 state_names=['h0'], context=CPU)
    mod.bind(data_shapes=[('data', (2, 4, 3))], for_training=False)
    mod.init_params(mt.init.Xavier())
    mod.set_states(value=0.5)
    batch = mt.io.DataBatch([mt.nd.ones((2, 2, 3), ctx=CPU)], None,
                            bucket_key=2,
                            provide_data=[('data', (2, 2, 3))])
    mod.forward(batch, is_train=False)
    assert mod._curr_bucket_key == 2
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(), 0.5)
    last = mod.get_outputs()[1]
    mod.set_states(states=[last])
    batch4 = mt.io.DataBatch([mt.nd.ones((2, 4, 3), ctx=CPU)], None,
                             bucket_key=4,
                             provide_data=[('data', (2, 4, 3))])
    mod.forward(batch4, is_train=False)
    np.testing.assert_array_equal(mod.get_states()[0].asnumpy(),
                                  last.asnumpy())
