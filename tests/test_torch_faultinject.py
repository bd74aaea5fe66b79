"""The port's fault-tolerant kvstore transport, driven by its copy of
``faultinject``: the cases of ``tests/test_faultinject.py`` through the
port (reconnect and replay, the server's dedup window, bounded retries,
refused connects and accepts, delayed acks, heartbeats feeding
``num_dead_nodes``, a barrier naming its missing rank, the pipelined
window's replay, an IO-thread crash poisoning the channel, the reply
blackhole).  Values are small integers and powers of two, exact in
float32; a run under a fault equals the uninterrupted run bit for bit,
and the uninterrupted Module run equals the JAX package's within 1e-6
(float32 sums in another order)."""
import contextlib
import socket
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import faultinject, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore_server import (KVStoreServer, _recv_msg,
                                            _send_msg)
from torch_dist import cluster, nd, pulled, zeros
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (2, 3)
K, BATCH, NIN, NCLASS = 6, 4, 6, 3


@pytest.fixture(autouse=True)
def _clean_plans(monkeypatch):
    """No fault plan leaks across tests; millisecond backoff; heartbeat
    off unless a test opts in; window 1 (stop-and-wait) unless a test
    opts in, as in the JAX package's tests."""
    faultinject.reset()
    profiler.reset_channel_counts()
    for k, v in (("MXNET_KVSTORE_RETRY_MAX", "8"),
                 ("MXNET_KVSTORE_RETRY_INITIAL_MS", "10"),
                 ("MXNET_KVSTORE_RETRY_MAX_MS", "50"),
                 ("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0"),
                 ("MXNET_KVSTORE_WINDOW", "1")):
        monkeypatch.setenv(k, v)
    yield
    faultinject.reset()


def test_kill_before_send_reconnects_and_replays(monkeypatch):
    with cluster(mt, monkeypatch) as (srv,):
        kv = mt.kv.create('dist_async')
        kv.init('w', nd(mt, np.ones(SHAPE)))
        with faultinject.kill_connection_after(1, point="before_send"):
            kv.push('w', nd(mt, np.ones(SHAPE) * 3))
            out = pulled(mt, kv, 'w', SHAPE)
        np.testing.assert_array_equal(out, 3.0)
        assert srv.dedup_count == 0
        assert faultinject.stats()["kills_fired"] == 1
        counts = profiler.channel_counts()
        assert counts.get("kvstore.reconnect", 0) >= 1
        assert counts.get("kvstore.replay_acked", 0) >= 1
        kv.close(stop_servers=True)


@pytest.mark.parametrize("point", ["after_send", "on_recv"])
def test_kill_after_send_dedups_replayed_push(monkeypatch, point):
    """The push reached the server, its ack was lost: the replay is
    acked from the dedup window, never applied twice."""
    with cluster(mt, monkeypatch) as (srv,):
        kv = mt.kv.create('dist_async')
        kv.init('w', nd(mt, np.ones(SHAPE)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                          wd=0.0, rescale_grad=1.0))
        with faultinject.kill_connection_after(1, point=point):
            kv.push('w', nd(mt, np.ones(SHAPE)))
            out = pulled(mt, kv, 'w', SHAPE)
        np.testing.assert_array_equal(out, 0.5)
        assert srv.dedup_count == 1
        assert faultinject.stats()["kills_fired"] == 1
        kv.close(stop_servers=True)


def _symbol(pkg):
    data = pkg.sym.Variable('data')
    net = pkg.sym.FullyConnected(data, num_hidden=8, name='fc1')
    net = pkg.sym.Activation(net, act_type='relu', name='relu1')
    net = pkg.sym.FullyConnected(net, num_hidden=NCLASS, name='fc2')
    return pkg.sym.SoftmaxOutput(net, name='softmax')


def _train(pkg, monkeypatch, kill=None, window=None, kill_unacked=None,
           delay_ack=0.0):
    """One run_steps over dist_async (server-side SGD with momentum) from
    numpy-seeded weights against a fresh server; (params, dedup)."""
    with cluster(pkg, monkeypatch) as (srv,):
        if window is not None:
            monkeypatch.setenv("MXNET_KVSTORE_WINDOW", str(window))
        rs = np.random.RandomState(11)
        data = rs.uniform(-1, 1, (K, BATCH, NIN)).astype(np.float32)
        label = rs.randint(0, NCLASS, (K, BATCH)).astype(np.float32)
        shapes = {"fc1_weight": (8, NIN), "fc1_bias": (8,),
                  "fc2_weight": (NCLASS, 8), "fc2_bias": (NCLASS,)}
        params = {n: nd(pkg, rs.normal(0, 0.5, s)) for n, s in
                  shapes.items()}
        kw = {"context": mt.cpu()} if pkg is mt else {}
        mod = pkg.mod.Module(_symbol(pkg), data_names=('data',),
                             label_names=('softmax_label',), **kw)
        mod.bind(data_shapes=[('data', (BATCH, NIN))],
                 label_shapes=[('softmax_label', (BATCH,))])
        mod.init_params(arg_params=params)
        mod.init_optimizer(kvstore='dist_async', optimizer='sgd',
                           optimizer_params={'learning_rate': 0.1,
                                             'momentum': 0.9, 'wd': 0.0})
        fi = pkg.faultinject
        with contextlib.ExitStack() as stack:
            if kill is not None:
                stack.enter_context(fi.kill_connection_after(*kill))
            if kill_unacked is not None:
                stack.enter_context(fi.delay_acks(delay_ack))
                stack.enter_context(fi.kill_when_unacked(kill_unacked))
            mod.run_steps(data, label, k=K)
        if kill is not None or kill_unacked is not None:
            assert fi.stats()["kills_fired"] == 1
        arg, _aux = mod.get_params()
        out = {k: v.asnumpy().copy() for k, v in arg.items()}
        dedup = srv.dedup_count
        mod._kvstore.close(stop_servers=True)
        return out, dedup


def test_kill_mid_run_steps_recovers_bit_identical(monkeypatch):
    """A connection killed inside run_steps, before a request leaves and
    after one was applied, recovers by reconnect and replay; the params
    equal the uninterrupted run's bit for bit, and that run equals the
    JAX package's within 1e-6."""
    baseline, dedup0 = _train(mt, monkeypatch)
    assert dedup0 == 0
    jax_params, _ = _train(mx, monkeypatch)
    for name in baseline:
        np.testing.assert_allclose(baseline[name], jax_params[name],
                                   rtol=1e-6, atol=1e-6)
    for kill, want_dedup in (((4, "before_send"), 0),
                             ((8, "after_send"), 1)):
        faultinject.reset()
        got, dedup = _train(mt, monkeypatch, kill=kill, window=1)
        for name in baseline:
            np.testing.assert_array_equal(got[name], baseline[name])
        assert dedup == want_dedup, (kill, dedup)
    faultinject.reset()
    got, _ = _train(mt, monkeypatch, window=2, kill_unacked=2,
                    delay_ack=0.01)
    for name in baseline:
        np.testing.assert_array_equal(got[name], baseline[name])
    counts = profiler.channel_counts()
    assert counts.get("kvstore.replay", 0) >= 2, counts


def test_retry_exhaustion_surfaces_hard_error(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "3")
    with cluster(mt, monkeypatch) as (srv,):
        kv = mt.kv.create('dist_async')
        kv.init('a', nd(mt, np.ones(SHAPE)))
        pulled(mt, kv, 'a', SHAPE)
        profiler.reset_channel_counts()
        srv.stop()
        with pytest.raises(MXNetError, match="3 reconnect attempts"):
            pulled(mt, kv, 'a', SHAPE)
        counts = profiler.channel_counts()
        assert counts.get("kvstore.retry") == 3, counts
        assert counts.get("kvstore.hard_fail") == 1, counts
        with pytest.raises(MXNetError, match="channel failed"):
            pulled(mt, kv, 'a', SHAPE)
        kv.close()


def test_refuse_connects_and_accepts(monkeypatch):
    with cluster(mt, monkeypatch):
        with faultinject.refuse_connects(2):
            kv = mt.kv.create('dist_async')
        assert faultinject.stats()["connects_refused"] == 2
        kv.init('a', nd(mt, np.ones(SHAPE)))
        with faultinject.refuse_accepts(1):
            with faultinject.kill_connection_after(1, point="before_send"):
                kv.push('a', nd(mt, np.ones(SHAPE) * 5))
                out = pulled(mt, kv, 'a', SHAPE)
        np.testing.assert_array_equal(out, 5.0)
        assert faultinject.stats()["accepts_refused"] == 1
        kv.close(stop_servers=True)


def test_delayed_acks_keep_fifo_semantics(monkeypatch):
    with cluster(mt, monkeypatch):
        kv = mt.kv.create('dist_async')
        with faultinject.delay_acks(0.02):
            kv.init('a', zeros(mt, SHAPE))
            kv.push('a', nd(mt, np.ones(SHAPE) * 2))
            out = pulled(mt, kv, 'a', SHAPE)
        np.testing.assert_array_equal(out, 2.0)
        kv.close(stop_servers=True)


def test_heartbeat_feeds_num_dead_nodes(monkeypatch):
    """A server that stops acking heartbeats is a dead node, for the
    store, ``distributed.num_dead_nodes`` and the health layer's
    dead-node source; a closed store stops reporting."""
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "0.5")
    with cluster(mt, monkeypatch) as (srv,):
        kv = mt.kv.create('dist_async')
        kv.init('a', nd(mt, np.ones(SHAPE)))
        assert kv.num_dead_nodes() == 0
        srv.stop()
        deadline = time.time() + 10
        while kv.num_dead_nodes() == 0 and time.time() < deadline:
            time.sleep(0.05)
        assert kv.num_dead_nodes() == 1
        assert mt.distributed.num_dead_nodes() >= 1
        assert mt.health._dead_nodes() >= 1
        assert profiler.channel_counts().get("kvstore.heartbeat_miss",
                                             0) >= 1
        kv.close()
        assert kv.num_dead_nodes() == 0


def test_barrier_timeout_names_missing_ranks(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "0.6")
    srv = KVStoreServer(server_id=0, num_workers=2, hb_timeout=0.6)
    srv.start_background()
    monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        _send_msg(s, ("ping", 1))
        assert _recv_msg(s)[0] == "ok"
        s.close()
        kv = mt.kv.create('dist_async')
        with pytest.raises(MXNetError) as ei:
            kv.barrier()
        msg = str(ei.value)
        assert "missing" in msg and "[1]" in msg, msg
        assert "arrived" in msg and "[0]" in msg, msg
        kv.close(stop_servers=True)
    finally:
        srv.stop()


def test_window_kill_with_k_unacked_replays_whole_window(monkeypatch):
    """Four envelopes unacked when the connection dies: all four replay
    in order, each applied once."""
    monkeypatch.setenv("MXNET_KVSTORE_WINDOW", "8")
    with cluster(mt, monkeypatch):
        kv = mt.kv.create('dist_async')
        kv.init('w', nd(mt, np.ones(SHAPE)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                          wd=0.0, rescale_grad=1.0))
        with faultinject.delay_acks(0.03):
            with faultinject.kill_when_unacked(4):
                for i in range(6):
                    kv.push('w', nd(mt, np.ones(SHAPE) * (i + 1)))
                out = pulled(mt, kv, 'w', SHAPE)
        np.testing.assert_array_equal(out, 1.0 - 0.5 * 21)
        assert faultinject.stats()["kills_fired"] == 1
        counts = profiler.channel_counts()
        assert counts.get("kvstore.replay", 0) == 4, counts
        assert counts.get("kvstore.replay_acked", 0) == 4, counts
        kv.close(stop_servers=True)


def test_window_one_never_fills_pipeline(monkeypatch):
    with cluster(mt, monkeypatch):
        kv = mt.kv.create('dist_async')
        kv.init('w', zeros(mt, SHAPE))
        with faultinject.delay_acks(0.02):
            with faultinject.kill_when_unacked(2):
                for i in range(4):
                    kv.push('w', nd(mt, np.ones(SHAPE) * (i + 1)))
                out = pulled(mt, kv, 'w', SHAPE)
        np.testing.assert_array_equal(out, 4.0)
        assert faultinject.stats()["kills_fired"] == 0
        kv.close(stop_servers=True)


def test_window_deep_pipeline_gluon_bit_identical(monkeypatch):
    """Window 8 under the Gluon Trainer (coalescing off, so each
    parameter is an envelope): a kill at depth 4 replays the window and
    two steps end bit-identical to the uninterrupted twin."""
    monkeypatch.setenv("MXNET_KVSTORE_COALESCE_BYTES", "0")
    x = np.array([[1., 2., 3.], [4., 5., 6.]], np.float32)

    def run(fault):
        with cluster(mt, monkeypatch):
            net = mt.gluon.nn.Dense(2, in_units=3, prefix='wdp_')
            net.initialize(mt.initializer.One())
            tr = mt.gluon.Trainer(net.collect_params(), 'sgd',
                                  {'learning_rate': 0.125,
                                   'momentum': 0.5, 'wd': 0.0},
                                  kvstore='dist_async')
            for step in range(2):
                with mt.autograd.record():
                    loss = (net(nd(mt, x)) ** 2).sum()
                loss.backward()
                if fault and step == 1:
                    with faultinject.delay_acks(0.02):
                        with faultinject.kill_when_unacked(4):
                            tr.step(batch_size=2)
                    assert faultinject.stats()["kills_fired"] == 1
                    faultinject.reset()
                else:
                    tr.step(batch_size=2)
            params = {k: v.data().asnumpy().copy()
                      for k, v in net.collect_params().items()}
            tr._kvstore.close(stop_servers=True)
            return params
    baseline = run(False)
    monkeypatch.setenv("MXNET_KVSTORE_WINDOW", "8")
    got = run(True)
    for name in baseline:
        np.testing.assert_array_equal(got[name], baseline[name])


def test_close_warns_on_stuck_io_thread(monkeypatch):
    srv = KVStoreServer(server_id=0, num_workers=2)
    srv.start_background()
    try:
        from mxnet_tpu_torch.kvstore import _ServerConn
        conn = _ServerConn(f"127.0.0.1:{srv.port}")
        conn.request(("barrier",))
        time.sleep(0.3)
        monkeypatch.setattr(conn, "flush", lambda: None)
        with pytest.warns(RuntimeWarning, match="did not stop"):
            conn.close(join_timeout=0.3)
    finally:
        srv.stop()


def test_io_thread_crash_poisons_channel_instead_of_hanging(monkeypatch):
    srv = KVStoreServer(server_id=0, num_workers=1)
    srv.start_background()
    try:
        from mxnet_tpu_torch.kvstore import _ServerConn
        conn = _ServerConn(f"127.0.0.1:{srv.port}")
        assert conn.submit(("ping", 0), wait=True) is None

        def boom(self):
            raise RuntimeError("injected pump crash")
        monkeypatch.setattr(_ServerConn, "_recv_ack", boom)
        pending = conn.request(("pull", "w"))
        assert pending.done.wait(timeout=10)
        assert "IO thread crashed" in str(pending.error)
        with pytest.raises(MXNetError, match="channel failed"):
            conn.request(("ping", 0))
        conn._thread.join(timeout=5)
        assert not conn._thread.is_alive()
    finally:
        srv.stop()


def test_blackhole_counts_filters_and_env_arming(monkeypatch):
    with faultinject.blackhole_after_replies(2):
        assert [faultinject.server_blackhole() for _ in range(4)] == \
            [False, False, True, True]
        assert faultinject.stats()["replies_blackholed"] == 2
    assert faultinject.server_blackhole() is False
    faultinject.configure(blackhole_after=0, only_server=3)
    monkeypatch.setenv("DMLC_SERVER_ID", "1")
    assert faultinject.server_blackhole() is False
    monkeypatch.setenv("DMLC_SERVER_ID", "3")
    assert faultinject.server_blackhole() is True
    faultinject.reset()
    monkeypatch.delenv("DMLC_SERVER_ID")
    monkeypatch.setenv("MXNET_FI_BLACKHOLE_AFTER", "1")
    faultinject._arm_from_env()
    assert faultinject.server_blackhole() is False
    assert faultinject.server_blackhole() is True


def test_blackholed_reply_leaves_connection_open(monkeypatch):
    """The server handles the request but the reply never leaves; the
    socket stays up and only the caller's wait sees it."""
    srv = KVStoreServer(num_workers=1)
    srv.start_background()
    try:
        from mxnet_tpu_torch.kvstore import _ServerConn
        conn = _ServerConn(f"127.0.0.1:{srv.port}")
        try:
            assert conn.submit(("ping", 0), wait=True) is None
            with faultinject.blackhole_after_replies(0):
                pending = conn.request(("pull", "nothing"))
                assert not pending.done.wait(0.4)
                assert faultinject.stats()["replies_blackholed"] >= 1
        finally:
            conn.abort()
    finally:
        srv.stop()
