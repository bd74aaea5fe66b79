"""The port's drivers over ``dist_async`` against the JAX package's: the
Gluon Trainer cases of ``tests/test_kvstore.py`` (update-on-kvstore, the
servers' weights authoritative at init, compression, coalesced steps,
resume), ``Module.fit`` and the chunked ``run_steps`` / ``step_k``
drivers of ``tests/test_fused_dist.py`` (staleness 0 equal to the eager
loop, staleness 1 equal to the analytic golden, one dispatch a chunk,
striped keys, a mid-window connection kill, the overlap clocks, no
pickled bytes in steady state).  Data, weights and the learning rate are
small integers and powers of two, so every quantity is an exact dyadic
and the comparisons are exact."""
import math
import os
import tempfile
import time
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from torch_dist import PKGS, cluster, nd
import torch_threads  # noqa: F401,E402  a worker's share of the cores

K, BATCH, NIN, NH = 6, 2, 3, 2
LR = 0.25


def _dense(pkg, w0, prefix):
    net = pkg.gluon.nn.Dense(w0.shape[0], use_bias=False,
                             in_units=w0.shape[1], prefix=prefix)
    net.initialize()
    net.weight.set_data(nd(pkg, w0))
    return net


def _gluon_step(pkg, net, tr, x, batch):
    with pkg.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    tr.step(batch_size=batch)


def test_gluon_trainer_dist_async(monkeypatch):
    """The optimizer runs on the server; step pushes the gradient and
    pulls the weight; two steps equal the JAX package's."""
    w0 = np.array([[0.5, -1.0, 2.0]], np.float32)
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch):
            net = _dense(pkg, w0, "gd_")
            tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': LR, 'momentum': 0.0,
                                    'wd': 0.0}, kvstore='dist_async')
            x = nd(pkg, np.ones((2, 3)))
            ws = []
            for _ in range(2):
                _gluon_step(pkg, net, tr, x, 2)
                ws.append(net.weight.data().asnumpy().copy())
            assert tr._update_on_kvstore
            tr._kvstore.close(stop_servers=True)
            got[name] = ws
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(a, b)
    w1 = w0 - LR * (2 * 2 * w0.sum() * np.ones((1, 3))) / 2
    np.testing.assert_array_equal(got["port"][0], w1.astype(np.float32))


def test_gluon_trainer_dist_async_states_and_init_pull(monkeypatch):
    """The server's value wins at init; momentum states checkpoint from
    the servers; a hyperparameter change after the first step warns."""
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch), tempfile.TemporaryDirectory() as d:
            seed = pkg.kv.create('dist_async')
            seed.init('sp_weight', nd(pkg, np.ones((1, 3)) * 7))
            seed.close()
            net = _dense(pkg, np.ones((1, 3), np.float32), "sp_")
            tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': 0.125,
                                    'momentum': 0.5, 'wd': 0.0},
                                   kvstore='dist_async')
            x = nd(pkg, np.ones((2, 3)))
            _gluon_step(pkg, net, tr, x, 2)
            w = net.weight.data().asnumpy().copy()
            fname = os.path.join(d, "s")
            tr.save_states(fname)
            up = mx.optimizer.get_updater(mx.optimizer.SGD(momentum=0.5))
            with open(fname, 'rb') as f:
                up.set_states(f.read())
            tr.load_states(fname)
            tr.set_learning_rate(0.01)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                _gluon_step(pkg, net, tr, x, 2)
            assert any("pickle-time snapshot" in str(r.message)
                       for r in rec)
            tr._kvstore.close(stop_servers=True)
            mom = up.states['sp_weight']
            mom = mom[0] if isinstance(mom, tuple) else mom
            got[name] = [w, np.asarray(mom.asnumpy())]
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(a, b)
    # the gradient was taken at the local ones, applied to the server's 7s
    np.testing.assert_array_equal(got["port"][0], 7 - 0.125 * 6.0)


def test_gluon_trainer_compression_plumb_through(monkeypatch):
    """compression_params reach the store before the first push (a
    residual exists); a bad config fails at construction."""
    with pytest.raises(mt.MXNetError, match="type"):
        mt.gluon.Trainer([], 'sgd', {}, compression_params={'type': 'bad'})
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch):
            net = _dense(pkg, np.ones((1, 3), np.float32), "gcp_")
            tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': 0.1, 'momentum': 0.0,
                                    'wd': 0.0}, kvstore='dist_async',
                                   compression_params={'type': '2bit',
                                                       'threshold': 0.5})
            _gluon_step(pkg, net, tr, nd(pkg, np.ones((2, 3))), 2)
            gc = tr._kvstore._gcompress
            assert (gc.type, gc.threshold) == ('2bit', 0.5)
            got[name] = [np.asarray(tr._kvstore._gc_residual['gcp_weight']),
                         net.weight.data().asnumpy()]
            tr._kvstore.close(stop_servers=True)
    for a, b in zip(got["jax"], got["port"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["jax", "port"])
def test_gluon_trainer_step_coalesces_small_pushes(monkeypatch, name):
    """A steady-state step over four small parameters is one coalesced
    push and four pulls: five envelopes."""
    pkg = PKGS[name]
    with cluster(pkg, monkeypatch):
        net = pkg.gluon.nn.Sequential()
        net.add(pkg.gluon.nn.Dense(2, in_units=3))
        net.add(pkg.gluon.nn.Dense(1, in_units=2))
        net.initialize()
        tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.1}, kvstore='dist_async')
        x = nd(pkg, np.ones((2, 3)))
        _gluon_step(pkg, net, tr, x, 2)
        conn = tr._kvstore._conns[0]
        seq = conn._next_seq
        _gluon_step(pkg, net, tr, x, 2)
        assert conn._next_seq - seq == 5
        tr._kvstore.close(stop_servers=True)


def test_gluon_trainer_dist_async_resume_rescale(monkeypatch):
    """save / load states before the first step do not ship the
    optimizer with rescale_grad 1.0: the first step applies lr * g /
    batch."""
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch), tempfile.TemporaryDirectory() as d:
            net = _dense(pkg, np.full((1, 3), 2.0, np.float32), "rsm_")
            tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': LR, 'momentum': 0.0,
                                    'wd': 0.0}, kvstore='dist_async')
            fname = os.path.join(d, "s")
            tr.save_states(fname)
            tr.load_states(fname)
            assert not tr._kv_opt_sent
            _gluon_step(pkg, net, tr, nd(pkg, np.ones((2, 3))), 2)
            got[name] = net.weight.data().asnumpy()
            tr._kvstore.close(stop_servers=True)
    np.testing.assert_array_equal(got["jax"], got["port"])
    np.testing.assert_array_equal(got["port"], 2 - LR * 24 / 2)


def test_gluon_trainer_dist_async_resume_preserves_server_states(
        monkeypatch):
    """Resume against live servers: interrupted (step, save, a new
    Trainer loads, step) equals continuous (step, step) with momentum,
    in both packages."""
    x0 = np.array([[1., 2., 3.], [4., 5., 6.]], np.float32)

    def make(pkg):
        net = _dense(pkg, np.full((1, 3), 0.5, np.float32), "resume_")
        tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.125, 'momentum': 0.5,
                                'wd': 0.0}, kvstore='dist_async')
        return net, tr

    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch):
            net, tr = make(pkg)
            for _ in range(2):
                _gluon_step(pkg, net, tr, nd(pkg, x0), 2)
            want = net.weight.data().asnumpy().copy()
            tr._kvstore.close(stop_servers=True)
        with cluster(pkg, monkeypatch), tempfile.TemporaryDirectory() as d:
            net, tr = make(pkg)
            _gluon_step(pkg, net, tr, nd(pkg, x0), 2)
            fname = os.path.join(d, "s")
            tr.save_states(fname)
            net3, tr3 = make(pkg)
            tr3.load_states(fname)
            _gluon_step(pkg, net3, tr3, nd(pkg, x0), 2)
            np.testing.assert_array_equal(net3.weight.data().asnumpy(),
                                          want)
            tr3._kvstore.close(stop_servers=True)
        got[name] = want
    np.testing.assert_array_equal(got["jax"], got["port"])


# -- Module over dist_async: fit and the chunked run_steps ------------------
def _int_data(seed=0, k=K):
    rs = np.random.RandomState(seed)
    data = rs.randint(-1, 2, (k, BATCH, NIN)).astype(np.float32)
    label = rs.randint(-2, 3, (k, BATCH, NH)).astype(np.float32)
    w0 = rs.randint(-2, 3, (NH, NIN)).astype(np.float32)
    return data, label, w0


def _make_module(pkg, w0, kvstore='dist_async'):
    data = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(data, num_hidden=NH, no_bias=True,
                                 name='fc')
    sym = pkg.sym.LinearRegressionOutput(net, name='lro')
    kw = {"context": mt.cpu()} if pkg is mt else {}
    mod = pkg.mod.Module(sym, data_names=('data',),
                         label_names=('lro_label',), **kw)
    mod.bind(data_shapes=[('data', (BATCH, NIN))],
             label_shapes=[('lro_label', (BATCH, NH))])
    mod.init_params(arg_params={'fc_weight': nd(pkg, w0)})
    mod.init_optimizer(
        kvstore=kvstore, optimizer='sgd',
        optimizer_params={'learning_rate': LR, 'momentum': 0.0,
                          'wd': 0.0, 'rescale_grad': 1.0})
    return mod


def _run_module(pkg, monkeypatch, w0, data, label, staleness, chunk,
                fused=True, n_servers=1):
    with cluster(pkg, monkeypatch, n=n_servers,
                 MXNET_KVSTORE_FUSED="1" if fused else "0",
                 MXNET_KVSTORE_FUSED_STALENESS=staleness,
                 MXNET_KVSTORE_FUSED_CHUNK=chunk):
        mod = _make_module(pkg, w0)
        pkg.profiler.reset_dispatch_counts()
        outs = mod.run_steps(data, label, k=data.shape[0])
        w = mod.get_params()[0]['fc_weight'].asnumpy().copy()
        counts = pkg.profiler.dispatch_counts()
        mod._kvstore.close(stop_servers=True)
        assert outs[0].shape == (data.shape[0], BATCH, NH)
        return w, counts


def _simulate_chunked(w0, data, label, lr, chunk, staleness):
    """The numpy twin of the chunked driver (tests/test_fused_dist.py):
    chunk j adopts the servers' state after chunk j-1-S's pushes; the
    final pull is the state after every push."""
    k = data.shape[0]
    srv = w0.astype(np.float32).copy()
    local = srv.copy()
    pulls = {}
    for j in range(math.ceil(k / chunk)):
        due = j - 1 - staleness
        if due in pulls:
            local = pulls.pop(due).copy()
        for s in range(j * chunk, min(k, (j + 1) * chunk)):
            g = ((data[s] @ local.T - label[s]).T @ data[s]).astype(
                np.float32)
            local = local - np.float32(lr) * g
            srv = srv - np.float32(lr) * g
        pulls[j] = srv.copy()
    return srv


@pytest.mark.parametrize("staleness,n_servers,bound", [
    (0, 1, None), (1, 1, None), (0, 2, 4)],
    ids=["staleness0", "staleness1", "striped"])
def test_run_steps_dist_matches_golden_and_the_jax_package(
        monkeypatch, staleness, n_servers, bound):
    """run_steps over dist_async, chunk 2: the weights equal the JAX
    package's fused driver and the analytic golden, bit for bit (a
    striped layout included); staleness 0 also equals the per-step
    loop; one ``run_steps.dist_chunk`` dispatch a chunk."""
    if bound:
        monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", str(bound))
    data, label, w0 = _int_data(seed=1 + staleness)
    w_port, counts = _run_module(mt, monkeypatch, w0, data, label,
                                 staleness, 2, n_servers=n_servers)
    w_jax, _ = _run_module(mx, monkeypatch, w0, data, label, staleness, 2,
                           n_servers=n_servers)
    np.testing.assert_array_equal(w_port, w_jax)
    np.testing.assert_array_equal(
        w_port, _simulate_chunked(w0, data, label, LR, 2, staleness))
    assert counts.get("run_steps.dist_chunk") == math.ceil(K / 2)
    if staleness == 0:
        w_eager, eager_counts = _run_module(
            mt, monkeypatch, w0, data, label, 0, 2, fused=False,
            n_servers=n_servers)
        np.testing.assert_array_equal(w_port, w_eager)
        assert "run_steps.dist_chunk" not in eager_counts
        assert eager_counts.get("module.update") == K


def test_run_steps_dist_mid_window_kill_bit_identical(monkeypatch):
    """A connection kill with unacked envelopes in flight rides the
    window replay and the server's dedup under the chunked driver: the
    weights equal an uninterrupted run's."""
    def run(kill):
        data, label, w0 = _int_data(seed=5)
        with cluster(mt, monkeypatch, MXNET_KVSTORE_FUSED_STALENESS=1,
                     MXNET_KVSTORE_FUSED_CHUNK=2):
            mod = _make_module(mt, w0)
            mt.profiler.reset_channel_counts()
            if kill:
                with mt.faultinject.kill_when_unacked(3):
                    mod.run_steps(data, label, k=K)
            else:
                mod.run_steps(data, label, k=K)
            stats = dict(mt.profiler.channel_counts())
            w = mod.get_params()[0]['fc_weight'].asnumpy().copy()
            mod._kvstore.close(stop_servers=True)
            return w, stats
    w_clean, _ = run(False)
    w_killed, stats = run(True)
    assert stats.get("kvstore.reconnect", 0) >= 1
    assert stats.get("kvstore.replay", 0) >= 1
    np.testing.assert_array_equal(w_killed, w_clean)


def test_module_fit_dist_async_2bit_matches_the_jax_package(monkeypatch):
    """Module.fit over dist_async with 2-bit pushes: the servers' SGD on
    the decompressed quanta, the weights pulled back, two epochs; the
    port's weights and residuals equal the JAX package's."""
    data, label, w0 = _int_data(seed=6)
    x = data.reshape(-1, NIN)
    y = label.reshape(-1, NH)
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch, n=2,
                     MXNET_KVSTORE_BIGARRAY_BOUND=4):
            it = pkg.io.NDArrayIter(x, y, batch_size=BATCH,
                                    label_name='lro_label')
            kv = pkg.kv.create('dist_async')
            kv.set_gradient_compression({'type': '2bit', 'threshold': 2.0})
            mod = _make_module(pkg, w0, kvstore=kv)
            mod.fit(it, num_epoch=2, kvstore=kv, optimizer='sgd',
                    optimizer_params={'learning_rate': LR},
                    eval_metric='mse')
            got[name] = [mod.get_params()[0]['fc_weight'].asnumpy(),
                         {k: np.asarray(v)
                          for k, v in kv._gc_residual.items()}]
            kv.close(stop_servers=True)
    np.testing.assert_array_equal(got["jax"][0], got["port"][0])
    assert set(got["jax"][1]) == set(got["port"][1]) == {
        'fc_weight@s0', 'fc_weight@s1'}
    for k in got["jax"][1]:
        np.testing.assert_array_equal(got["jax"][1][k], got["port"][1][k])
    assert not np.array_equal(got["port"][0], w0)


def test_trainer_step_k_dist_fused_matches_eager(monkeypatch):
    """step_k on dist_async runs chunked (one ``step_k.dist_chunk`` a
    chunk) and at staleness 0 equals K eager steps, and the JAX
    package's step_k, bit for bit."""
    rs = np.random.RandomState(7)
    data = rs.randint(-1, 2, (K, BATCH, NIN)).astype(np.float32)
    label = rs.randint(-2, 3, (K, BATCH, 1)).astype(np.float32)
    w0 = rs.randint(-2, 3, (1, NIN)).astype(np.float32)

    def run(pkg, fused):
        with cluster(pkg, monkeypatch, MXNET_KVSTORE_FUSED_STALENESS=0,
                     MXNET_KVSTORE_FUSED_CHUNK=2):
            net = _dense(pkg, w0, "skd_")
            tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                   {'learning_rate': LR, 'momentum': 0.0,
                                    'wd': 0.0}, kvstore='dist_async')

            def loss_fn(xb, yb):
                d = net(xb) - yb
                return (d * d).sum()
            pkg.profiler.reset_dispatch_counts()
            if fused:
                losses = tr.step_k(loss_fn, nd(pkg, data), nd(pkg, label),
                                   batch_size=1)
                assert losses.shape == (K,)
            else:
                for j in range(K):
                    with pkg.autograd.record():
                        loss = loss_fn(nd(pkg, data[j]), nd(pkg, label[j]))
                    loss.backward()
                    tr.step(batch_size=1)
            counts = pkg.profiler.dispatch_counts()
            w = net.weight.data().asnumpy().copy()
            tr._kvstore.close(stop_servers=True)
            return w, counts
    w_eager, _ = run(mt, False)
    w_fused, counts = run(mt, True)
    np.testing.assert_array_equal(w_fused, w_eager)
    assert counts.get("step_k.dist_chunk") == math.ceil(K / 2)
    np.testing.assert_array_equal(w_fused, run(mx, True)[0])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_drive_chunked_dist_overlap_accounting(name):
    """The wire-overlap clocks around the driver: with a 60 ms round and
    30 ms chunks, staleness 1 hides part of each round (less wait, more
    overlap than staleness 0), and adoptions follow the exact lag."""
    pkg = PKGS[name]
    prof = pkg.profiler
    COMPUTE, RTT = 0.03, 0.06

    class _Handle:
        def __init__(self):
            self._t0 = time.monotonic()
            self._done = False

        def wait(self):
            if self._done:
                return {}
            t_wait = time.monotonic()
            time.sleep(max(0.0, self._t0 + RTT - t_wait))
            t1 = time.monotonic()
            prof.record_wire_wait(t1 - t_wait)
            prof.record_wire_round(t1 - self._t0)
            self._done = True
            return {}

    def run(staleness):
        prof.reset_wire_counters()
        adoptions = []

        def dispatch(j, lo, hi, adopted):
            adoptions.append(adopted is not None)
            time.sleep(COMPUTE)
            return [None]
        pkg.executor.drive_chunked_dist(6, 1, staleness, dispatch,
                                        lambda j, g: _Handle())
        assert prof.wire_rounds() == 6
        return prof.wire_wait_ms(), prof.wire_overlap_pct(), adoptions
    wait0, overlap0, adopt0 = run(0)
    wait1, overlap1, adopt1 = run(1)
    assert adopt0 == [False] + [True] * 5
    assert adopt1 == [False, False] + [True] * 4
    assert wait1 < wait0 and overlap1 > overlap0
    assert overlap1 > 25.0 > overlap0


def test_fused_epoch_serializes_zero_pickled_bytes(monkeypatch):
    """With the binary codec negotiated, a steady-state chunked epoch
    records no pickled bytes: every push / pull envelope and ack rides
    the binary frame."""
    data, label, w0 = _int_data(seed=3)
    with cluster(mt, monkeypatch, MXNET_KVSTORE_CODEC="binary",
                 MXNET_KVSTORE_FUSED_STALENESS=0,
                 MXNET_KVSTORE_FUSED_CHUNK=2):
        mod = _make_module(mt, w0)
        mod.run_steps(data, label, k=K)
        mt.profiler.reset_serialization()
        mod.run_steps(data, label, k=K)
        counts = mt.profiler.serialization_counts()
        assert counts.get("pickle_bytes", 0) == 0, counts
        assert counts.get("codec_bytes", 0) > 0, counts
        mod._kvstore.close(stop_servers=True)
