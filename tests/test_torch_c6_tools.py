"""The port's visualization, ``test_utils``, notebook callbacks and
``contrib`` (autograd, tensorboard, the torch bridge) against the JAX
package: the cases of ``tests/test_viz.py``, ``tests/test_aux.py`` and
``tests/test_contrib.py``.

Tables, graphs and event files are compared exactly (the TensorBoard
files byte for byte, under a fixed clock and process id); numbers made
by both packages' float32 arithmetic within 1e-5 (a few float32
roundings of values of order 1)."""
import os
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

RTOL = 1e-5
PKGS = (mx, mt)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _net(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=16, name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.BatchNorm(net, name="bn1")
    net = pkg.sym.Convolution(pkg.sym.Reshape(net, shape=(-1, 1, 4, 4),
                                              name="as_image"),
                              num_filter=2, kernel=(3, 3), name="conv1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


# -- visualization -----------------------------------------------------------
@pytest.mark.parametrize("shape", [None, {"data": (2, 8)}])
def test_print_summary_equals_the_jax_package(capsys, shape):
    got = mt.viz.print_summary(_net(mt), shape=shape)
    want = mx.viz.print_summary(_net(mx), shape=shape)
    assert got == want
    assert "Total params" in got
    if shape is not None:
        assert "144" in got        # fc1: 8 x 16 weights + 16 biases
    with pytest.raises(TypeError):
        mt.visualization.print_summary("not a symbol")


def test_plot_network_is_the_jax_package_graph():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="graphviz"):
            mt.viz.plot_network(_net(mt))
        return
    got = mt.viz.plot_network(_net(mt), shape={"data": (2, 8)})
    want = mx.viz.plot_network(_net(mx), shape={"data": (2, 8)})
    assert got.source == want.source
    assert "fc1" in got.source and "softmax" in got.source


# -- test_utils --------------------------------------------------------------
def test_check_numeric_gradient_and_symbolic_checks():
    data = mt.sym.Variable("data")
    x = np.random.RandomState(0).randn(3, 4).astype("float32")
    mt.test_utils.check_numeric_gradient(mt.sym.sum(data * data),
                                         {"data": x})
    sq = mt.sym.square(data)
    got = mt.test_utils.check_symbolic_forward(sq, [x], [x * x])
    want = mx.test_utils.check_symbolic_forward(
        mx.sym.square(mx.sym.Variable("data")), [x], [x * x])
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL)
    grads = mt.test_utils.check_symbolic_backward(
        sq, [x], [np.ones_like(x)], [2 * x])
    np.testing.assert_allclose(grads["data"], 2 * x, rtol=RTOL)
    with pytest.raises(AssertionError):
        mt.test_utils.check_symbolic_forward(sq, [x], [x * x + 1])


def test_check_consistency_over_two_cpu_contexts_and_dtypes():
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=5, name="fc")
    net = mt.sym.SoftmaxOutput(net, name="softmax")
    res = mt.test_utils.check_consistency(net, [
        {"ctx": mt.cpu(0), "data": (4, 10),
         "type_dict": {"data": np.float32}},
        {"ctx": mt.cpu(1), "data": (4, 10),
         "type_dict": {"data": np.float64}}])
    assert len(res) == 2 and set(res[0]["grads"]) >= {"fc_weight"}


def test_default_context_follows_the_current_context():
    tu = mt.test_utils
    assert tu.default_context() == mt.cpu()
    with mt.gpu(0):
        assert tu.default_context() == mt.gpu(0)
    tu.set_default_context(mt.cpu(1))
    try:
        with mt.gpu(0):
            assert tu.default_context() == mt.cpu(1)
    finally:
        tu.set_default_context(None)
    a = tu.rand_ndarray((3, 4))
    assert a.context == mt.cpu() and a.shape == (3, 4)
    r = tu.rand_ndarray((6, 2), stype="row_sparse", density=0.5)
    assert r.stype == "row_sparse" and r.context == mt.cpu()
    assert tu.same_array(a, a) and not tu.same_array(a, a.copy())
    tu.assert_almost_equal(np.array([1.0, 2.0], "f"),
                           np.array([1.0, 2.0], "f") + 1e-7)
    with pytest.raises(AssertionError):
        tu.assert_almost_equal(np.array([1.0], "f"), np.array([1.01], "f"))
    out = tu.simple_forward(mt.sym.square(mt.sym.Variable("x")),
                            x=np.array([3.0], "f"))
    np.testing.assert_array_equal(out, [9.0])


# -- notebook ----------------------------------------------------------------
def _fit_with(pkg, args, epochs=2):
    net = pkg.sym.SoftmaxOutput(
        pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=3),
        name="softmax")
    x = np.random.RandomState(0).randn(32, 6).astype("float32")
    y = (np.arange(32) % 3).astype("float32")
    mod = pkg.mod.Module(net, context=pkg.cpu(0))
    mod.fit(pkg.io.NDArrayIter(x, y, 8), pkg.io.NDArrayIter(x, y, 8),
            num_epoch=epochs, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1},
            initializer=pkg.initializer.Xavier(), eval_metric="acc",
            **args)


def test_pandas_logger_and_live_curve_match_the_jax_package():
    logs = {}
    for pkg in PKGS:
        logger = pkg.notebook.callback.PandasLogger(batch_size=8,
                                                    frequent=1)
        curve = pkg.notebook.callback.LiveLearningCurve("accuracy",
                                                        frequent=1)
        _fit_with(pkg, logger.callback_args())
        _fit_with(pkg, curve.callback_args())
        logs[pkg] = (logger, curve)
    (tl, tc), (jl, jc) = logs[mt], logs[mx]
    assert list(tl.train_df.columns) == list(jl.train_df.columns)
    assert len(tl.train_df) == len(jl.train_df) > 0
    assert len(tl.eval_df) == len(jl.eval_df) > 0
    assert tl.train_df["epoch"].max() == 1
    assert [r[:2] for r in tc.train_data] == [r[:2] for r in jc.train_data]
    assert len(tc.eval_data) == len(jc.eval_data) > 0


# -- contrib.tensorboard -----------------------------------------------------
def _tfrecords(path, masked_crc):
    out = []
    with open(path, "rb") as f:
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            (ln,) = struct.unpack("<Q", hdr)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == masked_crc(hdr)
            payload = f.read(ln)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == masked_crc(payload)
            out.append(payload)
    return out


def test_tensorboard_files_are_byte_identical_under_a_fixed_clock(
        tmp_path, monkeypatch):
    from mxnet_tpu.contrib import tensorboard as jtb
    from mxnet_tpu_torch.contrib import tensorboard as ttb
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    monkeypatch.setattr(os, "getpid", lambda: 4242)
    files = {}
    for name, tb, pkg in (("jax", jtb, mx), ("port", ttb, mt)):
        monkeypatch.setattr(tb.SummaryWriter, "_counter", 0)
        d = tmp_path / name
        w = tb.SummaryWriter(str(d))
        w.add_scalar("loss", 1.5, 1)
        w.add_scalar("loss", 0.5, -2)
        w.close()
        metric = pkg.metric.Accuracy()
        metric.update([pkg.nd.array([0.0, 1.0])],
                      [pkg.nd.array([[0.9, 0.1], [0.2, 0.8]])])
        cb = tb.LogMetricsCallback(str(d), prefix="train")

        class P:
            eval_metric = metric
        cb(P())
        cb.summary_writer.close()
        files[name] = {f: open(os.path.join(str(d), f), "rb").read()
                       for f in sorted(os.listdir(str(d)))}
    assert files["port"] == files["jax"]
    assert len(files["port"]) == 2
    first = sorted(files["port"])[0]
    recs = _tfrecords(os.path.join(str(tmp_path / "port"), first),
                      ttb._masked_crc)
    assert len(recs) == 3 and b"brain.Event:2" in recs[0]
    assert struct.pack("<f", 1.5) in recs[1]
    assert ttb._varint(-1) == b"\xff" * 9 + b"\x01"


# -- contrib.torch -----------------------------------------------------------
def test_torch_function_hands_tensors_over_without_a_copy():
    a = mt.nd.array(np.array([[1.0, -2.0], [3.0, -4.0]], "f"))
    out = mt.contrib.torch.torch_function(lambda t: t.view(-1), a)
    assert out._data.data_ptr() == a._data.data_ptr()
    np.testing.assert_array_equal(
        mt.contrib.torch.torch_function(torch.abs, a).asnumpy(),
        mx.contrib.torch.torch_function(
            torch.abs, mx.nd.array(a.asnumpy())).asnumpy())
    outs = mt.contrib.torch.torch_function(torch.sort, a)
    np.testing.assert_array_equal(outs[0].asnumpy(), np.sort(a.asnumpy()))
    t = torch.ones(3)
    assert mt.contrib.torch.torch_function(torch.neg, t).asnumpy().sum() == -3


@pytest.mark.parametrize("crit,target", [
    ("mse_loss", np.array([0.0, 0.5, -1.0], "f")),
    ("cross_entropy", np.array([0, 2], np.int64))])
def test_torch_loss_matches_the_jax_package(crit, target):
    import torch.nn.functional as F
    p = (np.array([1.0, 2.0, 3.0], "f") if crit == "mse_loss"
         else np.array([[2.0, 0.0, 0.0], [0.0, 2.0, 1.0]], "f"))
    res = {}
    for pkg in PKGS:
        pred, tgt = pkg.nd.array(p), pkg.nd.array(target)
        pred.attach_grad()
        loss_fn = pkg.contrib.torch.TorchLoss(getattr(F, crit))
        with pkg.autograd.record():
            loss = loss_fn(pred, tgt)
        loss.backward()
        res[pkg] = (loss.asnumpy(), pred.grad.asnumpy())
    for a, b in zip(res[mt], res[mx]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-7)


# -- contrib.autograd --------------------------------------------------------
def test_contrib_autograd_matches_the_jax_package():
    out = {}
    for pkg in PKGS:
        cag = pkg.contrib.autograd
        x = pkg.nd.array(np.array([1.0, 2.0, 3.0], "float32"))
        grads, loss = cag.grad_and_loss(lambda v: v * v + 2 * v)(x)
        g2 = cag.grad(lambda v: pkg.nd.sum(v * v))(x)
        y = pkg.nd.array(np.array([2.0], "float32"))
        gy = pkg.nd.zeros((1,))
        cag.mark_variables([y], [gy])
        prev = cag.set_is_training(True)
        try:
            z = y * y * y
            cag.compute_gradient([z])
        finally:
            cag.set_is_training(prev)
        assert not pkg.autograd.is_recording()
        out[pkg] = [loss.asnumpy(), grads[0].asnumpy(), g2[0].asnumpy(),
                    gy.asnumpy()]
        with pkg.autograd.record(train_mode=False):
            with cag.test_section():
                assert not pkg.autograd.is_recording()
            assert pkg.autograd.is_recording()
            assert not pkg.autograd.is_training()
        with cag.train_section():
            assert pkg.autograd.is_training()
    for a, b in zip(out[mt], out[mx]):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    np.testing.assert_allclose(out[mt][3], [12.0])
