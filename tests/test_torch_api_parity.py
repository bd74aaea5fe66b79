"""The public calls the port restored, each against the JAX package's on
the same inputs (on the CPU): ``Symbol.bind`` / ``eval`` / ``grad``,
``simple_bind``'s keywords, the ``Executor``'s ``args_grad``,
``output_dict``, ``symbol``, ``debug_str`` and ``backward(is_train=)``,
the device-resident metric API (the value of the device path against the
host path and the JAX package's, one readback at ``sync``, a bad label
raising at ``sync``), ``Optimizer.set_learning_rate``,
``Updater.sync_state_context``, ``DataDesc.get_batch_axis`` /
``get_list``, ``NDArrayIter.hard_reset``, ``prepare`` in ``fit``,
``Module.bump_serving_version`` over an in-process server, the context
ids, ``Initializer.set_verbosity``, ``name.Prefix``, the modules' state
defaults and ``models.transformer.get_symbol``."""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401  a worker's share of the cores

PKGS = {"jax": mx, "port": mt}
CPU = mt.cpu()


def _kw(pkg):
    return {} if pkg is mx else dict(ctx=CPU)


def _fc(pkg):
    x = pkg.sym.Variable("x")
    return pkg.sym.FullyConnected(x, num_hidden=3, name="fc")


def _args(pkg, rng):
    return {"x": pkg.nd.array(rng.randn(2, 4).astype("f"), **_kw(pkg)),
            "fc_weight": pkg.nd.array(rng.randn(3, 4).astype("f"),
                                      **_kw(pkg)),
            "fc_bias": pkg.nd.array(rng.randn(3).astype("f"), **_kw(pkg))}


def test_bind_and_eval_give_the_jax_packages_outputs_and_gradients():
    outs, grads = {}, {}
    for key, pkg in PKGS.items():
        ctx = pkg.cpu()
        args = _args(pkg, np.random.RandomState(0))
        outs[key] = _fc(pkg).eval(ctx, **args)[0].asnumpy()
        g = pkg.nd.zeros((3, 4), **_kw(pkg))
        ex = _fc(pkg).bind(ctx, dict(args), args_grad={"fc_weight": g},
                           group2ctx={"dev1": ctx}, shared_exec=None)
        ex.forward(is_train=True)
        ex.backward(out_grads=[pkg.nd.ones((2, 3), **_kw(pkg))],
                    is_train=True)
        assert ex.grad_dict["fc_weight"] is g
        grads[key] = g.asnumpy()
        assert ex.symbol is not None
        assert list(ex.output_dict) == ["fc_output"]
        np.testing.assert_array_equal(ex.output_dict["fc_output"].asnumpy(),
                                      ex.outputs[0].asnumpy())
        assert ex.debug_str().splitlines() == [
            "Symbol outputs: ['fc_output']", "Variable:x",
            "Variable:fc_weight", "Variable:fc_bias",
            "Op:FullyConnected, Name=fc"]
        with pytest.raises(pkg.base.MXNetError, match="not supported"):
            _fc(pkg).grad(["x"])
    # float32 products of 4 terms: the two packages' CPU GEMMs may round
    # the last place differently
    np.testing.assert_allclose(outs["port"], outs["jax"], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(grads["port"], grads["jax"], rtol=1e-6,
                               atol=1e-6)


def test_simple_bind_keywords_are_parameters_never_input_shapes():
    """A keyword that names no input is ignored in both packages; the
    reference's group2ctx, shared_exec, shared_arg_names and
    shared_buffer are parameters in the port, never input shapes, so
    its ``**shapes`` cannot swallow them."""
    import inspect
    sig = inspect.signature(mt.sym.Symbol.simple_bind).parameters
    for p in ("group2ctx", "shared_exec", "shared_arg_names",
              "shared_buffer"):
        assert p in sig and sig[p].kind == sig[p].POSITIONAL_OR_KEYWORD, p
    shapes = {}
    for key, pkg in PKGS.items():
        ctx = pkg.cpu()
        first = _fc(pkg).simple_bind(ctx, x=(2, 4), bogus=(1,))
        ex = _fc(pkg).simple_bind(
            ctx, x=(2, 4), group2ctx={"dev1": ctx}, shared_exec=first,
            shared_arg_names=["fc_weight"], shared_buffer={})
        shapes[key] = {n: a.shape for n, a in ex.arg_dict.items()}
        assert "bogus" not in shapes[key]
        assert set(shapes[key]) == {"x", "fc_weight", "fc_bias"}
    assert shapes["port"] == shapes["jax"]


METRICS = {
    "acc": (lambda p: p.metric.Accuracy(),
            lambda r: (r.randint(0, 5, (16,)), r.rand(16, 5))),
    "top_k": (lambda p: p.metric.TopKAccuracy(top_k=3),
              lambda r: (r.randint(0, 5, (16,)), r.rand(16, 5))),
    "f1": (lambda p: p.metric.F1(),
           lambda r: (r.randint(0, 2, (16,)), r.rand(16, 2))),
    "perplexity": (lambda p: p.metric.Perplexity(ignore_label=0),
                   lambda r: (r.randint(0, 5, (16,)),
                              r.dirichlet(np.ones(5), 16))),
    "mae": (lambda p: p.metric.MAE(), lambda r: (r.rand(16), r.rand(16))),
    "rmse": (lambda p: p.metric.RMSE(), lambda r: (r.rand(16), r.rand(16))),
    "ce": (lambda p: p.metric.CrossEntropy(),
           lambda r: (r.randint(0, 5, (16,)), r.dirichlet(np.ones(5), 16))),
    "nll": (lambda p: p.metric.NegativeLogLikelihood(),
            lambda r: (r.randint(0, 5, (16,)), r.dirichlet(np.ones(5), 16))),
    "loss": (lambda p: p.metric.Loss(), lambda r: (r.rand(16), r.rand(16))),
}


def _feed(pkg, metric, mode, batches):
    for lab, pred in batches:
        labs = [pkg.nd.array(lab.astype("f"), **_kw(pkg))]
        preds = [pkg.nd.array(pred.astype("f"), **_kw(pkg))]
        getattr(metric, mode)(labs, preds)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_device_metric_equals_the_jax_packages_device_and_host_paths(name):
    """The device path folds each batch's term into a float32 sum, as the
    JAX package's does, and reads back once, at sync.  Every path is
    within 1e-6 of the JAX package's host value: the terms are float32
    reductions of 16 values, which XLA and torch sum in other orders
    (a few ulp), and the host paths add them in float64."""
    make, gen = METRICS[name]
    rng = np.random.RandomState(7)
    batches = [gen(rng) for _ in range(4)]
    got = {}
    for key, pkg in PKGS.items():
        for mode in ("update", "accumulate"):
            m = make(pkg)
            assert m.device_capable and m.device_enabled()
            before = dict(mt.profiler.host_syncs())
            _feed(pkg, m, mode, batches)
            if pkg is mt:
                after = dict(mt.profiler.host_syncs())
                assert after == before     # nothing read back per batch
            got[key, mode] = m.get()[1]
            if pkg is mt and mode == "accumulate":
                syncs = mt.profiler.host_syncs()
                assert syncs.get("metric.sync", 0) == \
                    before.get("metric.sync", 0) + 1
                assert syncs.get("metric.update", 0) == \
                    before.get("metric.update", 0)
    for k, v in got.items():
        np.testing.assert_allclose(v, got["jax", "update"], rtol=1e-6,
                                   err_msg=str(k))


def test_device_metric_functional_form_and_composite_match():
    rng = np.random.RandomState(3)
    batches = [METRICS["ce"][1](rng) for _ in range(3)]
    vals = {}
    for key, pkg in PKGS.items():
        m = pkg.metric.CrossEntropy()
        st = m.device_init()
        for lab, pred in batches:
            st = m.device_update_dict(st, {"l": _dev(pkg, lab)},
                                      {"p": _dev(pkg, pred)})
        m.sync(st)
        c = pkg.metric.CompositeEvalMetric(["acc", "ce"])
        assert c.device_capable
        _feed(pkg, c, "accumulate", batches)
        vals[key] = (m.get()[1], c.get()[1])
    # float32 sums of float32 terms in other orders (XLA's eager and
    # jitted folds differ between themselves by an ulp): 1e-6
    np.testing.assert_allclose(vals["port"][0], vals["jax"][0], rtol=1e-6)
    np.testing.assert_allclose(vals["port"][1], vals["jax"][1], rtol=1e-6)


def _dev(pkg, a):
    """A batch array in the form each package's functional device_update
    takes: a jax array in the JAX package, a tensor in the port."""
    a = np.asarray(a, np.float32)
    if pkg is mx:
        import jax.numpy as jnp
        return jnp.asarray(a)
    import torch
    return torch.from_numpy(a)


def test_bad_label_raises_at_sync_in_both_packages():
    for pkg in PKGS.values():
        m = pkg.metric.CrossEntropy()
        pred = np.full((2, 5), 0.2, np.float32)
        _feed(pkg, m, "accumulate", [(np.array([7, 1]), pred)])
        with pytest.raises(IndexError, match="out of range"):
            m.sync()
        with pytest.raises(IndexError):     # sticky until reset
            m.get()
        m.reset()
        assert np.isnan(m.get()[1])


def test_device_metrics_knob_restores_the_host_path(monkeypatch):
    monkeypatch.setenv("MXNET_DEVICE_METRICS", "0")
    m = mt.metric.Accuracy()
    assert not m.device_enabled()
    before = mt.profiler.host_syncs().get("metric.update", 0)
    _feed(mt, m, "accumulate", [(np.array([0, 1]), np.eye(2))] * 3)
    assert m._device_state is None and m.get()[1] == 1.0
    assert mt.profiler.host_syncs().get("metric.update", 0) == before + 3


def test_set_learning_rate_as_in_the_jax_package():
    for pkg in PKGS.values():
        o = pkg.optimizer.SGD(learning_rate=0.1)
        o.set_learning_rate(0.25)
        assert o.lr == 0.25
        s = pkg.optimizer.SGD(learning_rate=0.1,
                              lr_scheduler=pkg.lr_scheduler.FactorScheduler(
                                  step=2))
        with pytest.raises(UserWarning, match="LRScheduler"):
            s.set_learning_rate(0.5)


def test_updater_sync_state_context_moves_states():
    upd = mt.optimizer.get_updater(mt.optimizer.SGD(momentum=0.9))
    a = mt.nd.array(np.ones(3, "f"), ctx=CPU)
    moved = upd.sync_state_context((a, None, [a]), CPU)
    assert moved[0] is a and moved[1] is None and moved[2][0] is a
    assert upd.sync_state_context(5, CPU) == 5


def test_data_desc_helpers_and_hard_reset_as_in_the_jax_package():
    for pkg in PKGS.values():
        D = pkg.io.DataDesc
        assert [D.get_batch_axis(x) for x in (None, "NCHW", "TNC")] == \
            [0, 0, 1]
        descs = D.get_list([("a", (2, 3)), ("b", (4,))],
                           [("a", np.int32), ("b", np.float16)])
        assert [(d.name, d.shape, d.dtype) for d in descs] == \
            [("a", (2, 3), np.int32), ("b", (4,), np.float16)]
        assert D.get_list([("a", (1,))], None)[0].dtype == np.float32
    seen = {}
    for key, pkg in PKGS.items():
        x = np.arange(10, dtype="f").reshape(5, 2)
        it = pkg.io.NDArrayIter(x, batch_size=2,
                                last_batch_handle="roll_over")
        first = [b.data[0].asnumpy().tolist() for b in it]
        it.reset()
        after_reset = next(iter(it)).data[0].asnumpy().tolist()
        it.hard_reset()
        after_hard = next(iter(it)).data[0].asnumpy().tolist()
        seen[key] = (first, after_reset, after_hard)
    assert seen["port"] == seen["jax"]
    assert seen["port"][2] == seen["port"][0][0]


def _mlp(pkg):
    x = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(x, num_hidden=4, name="fc1")
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        h, num_hidden=2, name="fc2"), name="softmax")


def test_fit_prepares_each_next_batch_as_in_the_jax_package():
    seen = {}
    for key, pkg in PKGS.items():
        rng = np.random.RandomState(0)
        it = pkg.io.NDArrayIter(rng.randn(8, 3).astype("f"),
                                rng.randint(0, 2, 8).astype("f"),
                                batch_size=2)
        kw = {} if pkg is mx else dict(context=CPU)
        mod = pkg.mod.Module(_mlp(pkg), **kw)
        prepared = []
        mod.prepare = lambda b, p=prepared: p.append(
            b.data[0].asnumpy()[0, 0])
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
        seen[key] = prepared
    assert len(seen["port"]) == 3          # batches 2-4, not the first
    np.testing.assert_array_equal(seen["port"], seen["jax"])


def test_module_state_defaults_as_in_the_jax_package():
    for pkg in PKGS.values():
        kw = {} if pkg is mx else dict(context=CPU)
        seq = pkg.mod.SequentialModule()
        seq.add(pkg.mod.Module(_mlp(pkg), **kw), take_labels=True)
        seq.bind(data_shapes=[("data", (2, 3))],
                 label_shapes=[("softmax_label", (2,))])
        seq.init_params()
        assert seq.get_states() == []
        seq.set_states()
        seq.prepare(None)
        loss = pkg.mod.PythonLossModule()
        with pytest.raises(NotImplementedError):
            pkg.mod.BaseModule.data_names.fget(loss)


def test_bump_serving_version_over_an_in_process_server(monkeypatch):
    """Module.bump_serving_version publishes through the servers in both
    packages: versions 1, 2, then 7, read back from the version key; a
    Module without a dist store refuses."""
    from mxnet_tpu_torch.serving import VERSION_KEY
    for key, pkg in PKGS.items():
        srv = pkg.kvstore_server.KVStoreServer(num_workers=1)
        srv.start_background()
        monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")
        monkeypatch.setenv("DMLC_NUM_WORKER", "1")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        try:
            kw = {} if pkg is mx else dict(context=CPU)
            mod = pkg.mod.Module(_mlp(pkg), **kw)
            mod.bind(data_shapes=[("data", (2, 3))],
                     label_shapes=[("softmax_label", (2,))])
            mod.init_params()
            if pkg is mt:
                with mt.cpu():
                    mod.init_optimizer(kvstore="dist_async")
            else:
                mod.init_optimizer(kvstore="dist_async")
            got = [mod.bump_serving_version(), mod.bump_serving_version(),
                   mod.bump_serving_version(7)]
            out = pkg.nd.zeros((1,), dtype="float64", **_kw(pkg))
            mod._kvstore.pull(VERSION_KEY, out=out)
            assert got == [1, 2, 7] and float(out.asnumpy()[0]) == 7.0
            mod._kvstore.close(stop_servers=True)
        finally:
            srv.stop()
        local = pkg.mod.Module(_mlp(pkg), **kw)
        local.bind(data_shapes=[("data", (2, 3))],
                   label_shapes=[("softmax_label", (2,))])
        local.init_params()
        local.init_optimizer(kvstore="local")
        with pytest.raises(pkg.base.MXNetError, match="dist"):
            local.bump_serving_version()


def test_context_ids_as_in_the_jax_package():
    for t in ("cpu", "gpu", "cpu_pinned"):
        assert mt.Context(t).device_typeid == mx.Context(t).device_typeid
        assert mt.Context.devid2type[mx.Context.devtype2id[t]] == t
    mt.cpu().empty_cache()     # the host has no cache to drop


def test_set_verbosity_prefix_and_get_symbol(caplog):
    for pkg in PKGS.values():
        with caplog.at_level(logging.INFO):
            init = pkg.initializer.Constant(0.5).set_verbosity(True)
            a = pkg.nd.zeros((2, 2), **_kw(pkg))
            init("fc_weight", a)
        assert "Initialized fc_weight as weight" in caplog.text
        caplog.clear()
        with pkg.name.Prefix("m_"):
            s = pkg.sym.FullyConnected(pkg.sym.Variable("x"), num_hidden=2)
        assert s.name == "m_fullyconnected0"
    shapes = {}
    for key, pkg in PKGS.items():
        net = pkg.models.transformer.get_symbol(
            vocab_size=50, seq_len=8, num_layers=1, d_model=16,
            num_heads=2)
        shapes[key] = net.infer_shape(data=(2, 8),
                                      softmax_label=(2, 8))[0]
    assert shapes["port"] == shapes["jax"]
