"""The Monitor in the PyTorch port against the JAX package: the same
symbol with the same parameters and batch, observed through
``Module.install_monitor``, ``Executor.set_monitor_callback``,
``Module.fit(monitor=)`` and ``FeedForward.fit(monitor=)``.

The output names must be the JAX package's, in its order.  The default
statistic, mean(|x|) in float32, is computed on the port's device and
read back once a ``toc``; against the JAX package's host numpy mean it
agrees within 1e-5 of its value (both reduce float32 values in another
order; a forward of a few hundred elements of either package differs
from float64 by about 1e-7 relatively, so 1e-5 leaves room without
hiding a wrong statistic)."""
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
    fc1 = pkg.sym.FullyConnected(data, num_hidden=6, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    parts = pkg.sym.SliceChannel(act, num_outputs=2, axis=1, name="split")
    cat = pkg.sym.Concat(parts[1], parts[0], dim=1, name="cat")
    bn = pkg.sym.BatchNorm(cat, name="bn")
    fc2 = pkg.sym.FullyConnected(bn, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(fc2, name="softmax")


def _params(seed=0):
    rng = np.random.RandomState(seed)
    return ({"fc1_weight": rng.randn(6, 5).astype("f") * 0.5,
             "fc1_bias": rng.randn(6).astype("f") * 0.1,
             "bn_gamma": rng.rand(6).astype("f") + 0.5,
             "bn_beta": rng.randn(6).astype("f") * 0.1,
             "fc2_weight": rng.randn(3, 6).astype("f") * 0.5,
             "fc2_bias": np.zeros(3, "f")},
            {"bn_moving_mean": np.zeros(6, "f"),
             "bn_moving_var": np.ones(6, "f")})


def _batch(pkg, seed=1, n=4):
    rng = np.random.RandomState(seed)
    return pkg.io.DataBatch([pkg.nd.array(rng.randn(n, 5).astype("f"))],
                            [pkg.nd.array(rng.randint(0, 3, n).astype("f"))])


def _module(pkg, mon=None, pattern=".*"):
    mod = pkg.mod.Module(_net(pkg), context=pkg.cpu())
    mod.bind(data_shapes=[("data", (4, 5))],
             label_shapes=[("softmax_label", (4,))])
    args, aux = _params()
    mod.init_params(arg_params={k: pkg.nd.array(v) for k, v in args.items()},
                    aux_params={k: pkg.nd.array(v) for k, v in aux.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    if mon is not None:
        mod.install_monitor(mon)
    return mod


def _observe(pkg, is_train, **kw):
    mon = pkg.monitor.Monitor(1, **kw)
    mod = _module(pkg, mon)
    mon.tic()
    mod.forward(_batch(pkg), is_train=is_train)
    mod.get_outputs()[0].asnumpy()
    return mon.toc()


@pytest.mark.parametrize("is_train", [True, False])
def test_monitor_outputs_match_the_jax_package(is_train):
    got = _observe(mt, is_train)
    want = _observe(mx, is_train)
    assert [(s, n) for s, n, _ in got] == [(s, n) for s, n, _ in want]
    names = [n for _, n, _ in got]
    assert names == ["fc1_output", "relu1_output", "split_output0",
                     "split_output1", "cat_output", "bn_output",
                     "fc2_output", "softmax_output"]
    for (_, n, g), (_, _, w) in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=RTOL, err_msg=n)


def test_pattern_sort_and_interval():
    for pkg in PKGS:
        mon = pkg.monitor.Monitor(2, pattern=".*fc.*", sort=True)
        mod = _module(pkg, mon)
        seen = []
        for step in range(4):
            mon.tic()
            mod.forward(_batch(pkg, seed=step), is_train=True)
            mod.backward()
            mod.update()
            seen.append(mon.toc())
        assert [len(s) for s in seen] == [2, 0, 2, 0]
        assert [n for _, n, _ in seen[2]] == ["fc1_output", "fc2_output"]
        assert [s for s, _, _ in seen[2]] == [3, 3]


def test_toc_reads_the_statistics_back_once():
    mon = mt.monitor.Monitor(1)
    mod = _module(mt, mon)
    before = mt.profiler.host_syncs().get("monitor.toc", 0)
    mon.tic()
    mod.forward(_batch(mt), is_train=True)
    assert all(isinstance(v, torch.Tensor) for _, _, v in mon.queue)
    res = mon.toc()
    assert len(res) == 8
    assert mt.profiler.host_syncs()["monitor.toc"] == before + 1
    # a user statistic that returns a list is joined, as in the JAX
    # package
    mon2 = mt.monitor.Monitor(1, stat_func=lambda x: [1, 2],
                              pattern="fc2.*")
    mod.install_monitor(mon2)
    mon2.tic()
    mod.forward(_batch(mt), is_train=False)
    assert mon2.toc() == [(1, "fc2_output", "1 2")]


def test_executor_callback_sees_every_node_before_it_is_dropped():
    """The callback gets each op node's outputs as the interpreter makes
    them, intermediate values included, detached from autograd."""
    ex = mt.Executor.simple_bind(_net(mt), ctx=mt.cpu(),
                                 shapes={"data": (4, 5),
                                         "softmax_label": (4,)})
    args, aux = _params()
    ex.copy_params_from(args, aux)
    seen = {}
    ex.set_monitor_callback(lambda n, a: seen.setdefault(n, a.asnumpy()))
    x = np.random.RandomState(2).randn(4, 5).astype("f")
    ex.forward(is_train=True, data=x, softmax_label=np.zeros(4, "f"))
    assert list(seen) == ["fc1_output", "relu1_output", "split_output0",
                          "split_output1", "cat_output", "bn_output",
                          "fc2_output", "softmax_output"]
    fc1 = x @ args["fc1_weight"].T + args["fc1_bias"]
    np.testing.assert_allclose(seen["fc1_output"], fc1, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(seen["relu1_output"],
                                  np.maximum(seen["fc1_output"], 0))
    ex.backward()       # the detached copies did not cut the graph
    assert np.abs(ex.grad_dict["fc1_weight"].asnumpy()).sum() > 0
    ex.set_monitor_callback(None)
    seen.clear()
    ex.forward(is_train=False, data=x)
    assert seen == {}


def test_fit_and_feedforward_take_a_monitor(caplog):
    rng = np.random.RandomState(3)
    X = rng.randn(16, 5).astype("f")
    Y = rng.randint(0, 3, 16).astype("f")
    mon = mt.monitor.Monitor(2, pattern="fc2.*")
    mod = mt.mod.Module(_net(mt), context=mt.cpu())
    import logging
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=4), num_epoch=1,
                monitor=mon, initializer=mt.initializer.Xavier())
    lines = [r.getMessage() for r in caplog.records
             if r.getMessage().startswith("Batch:")]
    assert len(lines) == 2 and all("fc2_output" in ln for ln in lines)
    mon2 = mt.monitor.Monitor(1, pattern="fc1.*")
    ff = mt.model.FeedForward(_net(mt), ctx=mt.cpu(), num_epoch=1,
                              numpy_batch_size=4, learning_rate=0.1)
    ff.fit(X, Y, monitor=mon2)
    assert mon2.step == 4 and mon2.exes
    assert mt.Monitor is mt.monitor.Monitor
