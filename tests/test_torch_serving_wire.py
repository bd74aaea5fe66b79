"""The serving wire (``ServingReplica``, ``ServingClient``,
``publish_version``) in both packages: the replica and client cases of
``tests/test_serving.py:223-697`` as the JAX package's suite writes
them, each run once against the JAX package and once against the port
(on the CPU), so each package holds the same goldens.  A port replica is
the JAX package's twin over torch: its predictor runs on the card unless
given a CPU context, as here.

Tolerances: the replies are softmax probabilities of one float32 dense
layer, held against numpy's float64-free reference within rtol 1e-5 /
atol 1e-6 (float32 summation order of a 4-wide product and the exp); the
weight refresh is an SGD step of 0.1 x 1.0 on values of order 1, exact
in float32 up to one rounding, under the same tolerance."""
import os
import socket
import threading
import time

import numpy as np
import pytest

from torch_both import both_packages
import torch_threads  # noqa: F401  a worker's share of the cores

FEAT = 4
HIDDEN = 3


def _bind(p):
    return dict(
        mx=p, profiler=p.profiler, serving=p.serving,
        MXNetError=p.base.MXNetError,
        KVStoreServer=p.kvstore_server.KVStoreServer,
        _send_msg=p.kvstore_server._send_msg,
        _recv_msg=p.kvstore_server._recv_msg,
        BucketedPredictor=p.serving.BucketedPredictor,
        BusyError=p.serving.BusyError,
        DynamicBatcher=p.serving.DynamicBatcher,
        ServingClient=p.serving.ServingClient,
        ServingReplica=p.serving.ServingReplica,
        publish_version=p.serving.publish_version)


pkg = both_packages(globals(), _bind)


def _softmax_symbol():
    data = mx.sym.Variable('data')
    fc = mx.sym.FullyConnected(data, num_hidden=HIDDEN, name='fc')
    return mx.sym.SoftmaxOutput(fc, name='softmax')


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {
        'fc_weight': mx.nd.NDArray(
            rs.randn(HIDDEN, FEAT).astype(np.float32)),
        'fc_bias': mx.nd.NDArray(
            rs.randn(HIDDEN).astype(np.float32)),
    }


def _ref_softmax(x, params):
    w = np.asarray(params['fc_weight'].asnumpy())
    b = np.asarray(params['fc_bias'].asnumpy())
    logits = x @ w.T + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _make_predictor(buckets=(2, 4, 8), seed=0):
    params = _params(seed)
    pred = BucketedPredictor(_softmax_symbol(), {'data': (FEAT,)},
                             params, buckets=list(buckets))
    return pred, params




# -- admission control --------------------------------------------------------
class _BlockingPredictor:
    """Stub predictor whose forward parks on an event — makes queue
    buildup deterministic for the shedding tests."""

    buckets = [1]

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def predict(self, data):
        self.started.set()
        assert self.release.wait(30), "test never released the predictor"
        return 0, [np.asarray(data["data"])]


def test_queue_depth_shedding_returns_busy():
    """Requests past the queue-depth dial complete IMMEDIATELY with the
    typed BUSY payload — never an error, never unbounded queueing."""
    stub = _BlockingPredictor()
    b = DynamicBatcher(stub, max_wait_s=0.0, queue_depth=2)
    try:
        x = {"data": np.ones((1, 2), np.float32)}
        s1 = b.submit(x)
        assert stub.started.wait(10)     # worker is inside predict(s1)
        s2, s3 = b.submit(x), b.submit(x)
        assert b.queue_depth == 2
        s4 = b.submit(x)                 # past the dial: shed NOW
        assert s4.done.is_set()
        status, payload = s4.reply
        assert status == "ok" and payload[0] == "busy"
        assert payload[1] == {"queue_depth": 2, "limit": 2}
        assert b.shed == 1
        stub.release.set()
        for s in (s1, s2, s3):
            assert s.done.wait(10)
            assert s.reply[0] == "ok" and s.reply[1][0] == "result"
    finally:
        stub.release.set()
        b.stop()


def test_client_raises_typed_busy_error():
    """Client side of the shed: BusyError (a typed, retryable signal),
    not a generic failure.  queue_depth=0 sheds every request."""
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, _params(),
                         buckets=[1, 2], queue_depth=0, warmup=False)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        with pytest.raises(BusyError, match="shed"):
            cli.predict(np.zeros((1, FEAT), np.float32))
        assert issubclass(BusyError, MXNetError)
    finally:
        cli.close()
        rep.stop()


def test_batcher_coalesces_past_mixed_signatures():
    """Interleaved traffic with different input structures must still
    coalesce: the collect scan skips non-matching slots (they dispatch
    in their own batch) instead of fragmenting everything to batches of
    one."""

    class _Recording(_BlockingPredictor):
        def __init__(self):
            super().__init__()
            self.calls = []

        def predict(self, data):
            self.started.set()
            assert self.release.wait(30)
            arr = data["data"]
            self.calls.append((int(arr.shape[0]), str(arr.dtype)))
            return 0, [np.asarray(arr)]

    stub = _Recording()
    stub.buckets = [4]
    b = DynamicBatcher(stub, max_wait_s=0.0, queue_depth=16)
    try:
        a = {"data": np.ones((1, 2), np.float32)}
        other = {"data": np.ones((1, 2), np.float64)}   # different sig
        first = b.submit(a)              # worker grabs this immediately
        assert stub.started.wait(10)
        # queued while the worker is parked: A, OTHER, A
        s_a1, s_o, s_a2 = b.submit(a), b.submit(other), b.submit(a)
        stub.release.set()
        for s in (first, s_a1, s_o, s_a2):
            assert s.done.wait(10)
            assert s.reply[0] == "ok" and s.reply[1][0] == "result"
        # dispatch 2 coalesced BOTH float32 slots across the float64
        # slot in between; the float64 one ran alone
        assert stub.calls == [(1, "float32"), (2, "float32"),
                              (1, "float64")], stub.calls
    finally:
        stub.release.set()
        b.stop()


def test_refresh_transport_failure_does_not_advance_version(monkeypatch):
    """A transport failure mid-refresh must surface (and leave the seen
    version untouched so the next poll retries) — only a genuinely
    missing key reads as 'frozen param / not published'."""
    ps = KVStoreServer(server_id=0, num_workers=1)
    ps.start_background()
    ps_uri = f"127.0.0.1:{ps.port}"
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "10")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0")
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, _params(),
                         buckets=[2], param_servers=ps_uri,
                         max_wait_s=0.0, warmup=False)
    try:
        # nothing published: a clean no-op, not an error
        assert rep._refresh_once()["refreshed"] is False
        assert rep._seen_version is None
        # dead servers: the refresh RAISES instead of pretending the
        # version space is empty, and the next call re-dials fresh
        ps.stop()
        with pytest.raises(MXNetError):
            rep._refresh_once()
        assert rep._seen_version is None
        assert rep._ps is None    # poisoned client was dropped
    finally:
        rep.stop()
        ps.stop()


def test_batcher_crash_propagates_to_slots():
    """The sticky-error thread contract: a predictor crash fails every
    queued slot loudly and poisons later submits."""

    class _Exploding:
        buckets = [4]

        def predict(self, data):
            raise RuntimeError("boom")

    b = DynamicBatcher(_Exploding(), max_wait_s=0.0, queue_depth=8)
    try:
        s = b.submit({"data": np.ones((1, 2), np.float32)})
        assert s.done.wait(10)
        status, payload = s.reply
        assert status == "err" and "boom" in payload
    finally:
        b.stop()


# -- the 64-concurrent acceptance smoke ---------------------------------------
def test_replica_serves_64_concurrent_through_batcher():
    """One replica, 64 concurrent requests, all correct, at most
    len(buckets) compiles (the port: bucket shapes dispatched), real
    batching (fewer dispatches than requests), p50/p99/QPS exposed."""
    profiler.reset_dispatch_counts()
    profiler.reset_latency()
    params = _params()
    buckets = [1, 2, 4, 8]
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, params,
                         buckets=buckets, max_wait_s=0.05)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=64)
    try:
        rs = np.random.RandomState(5)
        x = rs.randn(8, FEAT).astype(np.float32)
        ref = _ref_softmax(x, params)
        futs = [cli.predict_async(x[i % 8:i % 8 + 1]) for i in range(64)]
        for i, fut in enumerate(futs):
            out = fut.get()
            np.testing.assert_allclose(out[0], ref[i % 8:i % 8 + 1],
                                       rtol=1e-5, atol=1e-6)
            assert fut.version == 0
        counts = profiler.dispatch_counts()
        assert counts.get("serving.predict_compile", 0) <= len(buckets), \
            counts
        st = cli.stats()
        assert st["version"] == 0 and st["shed"] == 0
        # the batcher actually coalesced: far fewer forwards than
        # requests (64 single-row requests, 50 ms fill window)
        assert 1 <= st["batches"] < 64
        lat = st["latency"]
        assert lat["count"] >= 64
        assert lat["p50_ms"] > 0 and lat["p99_ms"] >= lat["p50_ms"]
        assert lat["qps"] > 0
    finally:
        cli.close()
        rep.stop()


# -- live dist_async weight refresh -------------------------------------------
def test_weight_refresh_from_live_dist_async(monkeypatch):
    """Train-and-serve: an SGD push to the live parameter servers plus a
    version bump changes served predictions WITHOUT a replica restart
    (and without one extra compile)."""
    profiler.reset_dispatch_counts()
    ps = KVStoreServer(server_id=0, num_workers=1)
    ps.start_background()
    ps_uri = f"127.0.0.1:{ps.port}"
    monkeypatch.setenv("MXT_SERVER_URIS", ps_uri)
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    params = _params()
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, params,
                         buckets=[2, 4], param_servers=ps_uri,
                         max_wait_s=0.005)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}")
    kv = mx.kv.create('dist_async')
    try:
        x = np.random.RandomState(6).randn(3, FEAT).astype(np.float32)
        np.testing.assert_allclose(cli.predict(x)[0],
                                   _ref_softmax(x, params),
                                   rtol=1e-5, atol=1e-6)
        compiles = profiler.dispatch_counts().get(
            "serving.predict_compile", 0)

        # the trainer: init weights on the servers, install SGD, push a
        # gradient — the server-side weights are now the live weights
        w0 = np.asarray(params['fc_weight'].asnumpy())
        b0 = np.asarray(params['fc_bias'].asnumpy())
        kv.init('fc_weight', mx.nd.NDArray(w0))
        kv.init('fc_bias', mx.nd.NDArray(b0))
        kv.set_optimizer(mx.optimizer.SGD(learning_rate=0.1, momentum=0.0,
                                          wd=0.0, rescale_grad=1.0))
        grad = np.ones_like(w0)
        kv.push('fc_weight', mx.nd.NDArray(grad))
        kv.barrier()

        # no bump yet -> refresh is a no-op and predictions are stale
        assert cli.refresh()["refreshed"] is False
        assert rep.version == 0

        v = publish_version(kv)
        assert v == 1
        r = cli.refresh()
        assert r["refreshed"] is True and r["version"] == 1

        new_params = {'fc_weight': mx.nd.NDArray(w0 - 0.1 * grad),
                      'fc_bias': mx.nd.NDArray(b0)}
        fut = cli.predict_async(x)
        out = fut.get()
        np.testing.assert_allclose(out[0], _ref_softmax(x, new_params),
                                   rtol=1e-5, atol=1e-6)
        assert fut.version == 1
        # hot swap: zero additional compiles
        assert profiler.dispatch_counts().get(
            "serving.predict_compile", 0) == compiles

        # second bump via the auto-increment path
        assert publish_version(kv) == 2
        assert cli.refresh()["version"] == 2
    finally:
        cli.close()
        kv.close(stop_servers=False)
        rep.stop()
        ps.stop()


def test_assign_and_publish_version_local_store():
    """publish_version works against the local store too (single-process
    test rigs); assign never routes through the updater."""
    kv = mx.kv.create('local')
    applied = []
    kv._set_updater(lambda key, recv, stored: applied.append(key))
    assert publish_version(kv) == 1
    assert publish_version(kv) == 2
    assert publish_version(kv, version=10) == 10
    out = mx.nd.zeros((1,), dtype="float64")
    kv.pull(serving.VERSION_KEY, out=out)
    assert int(out.asnumpy()[0]) == 10
    assert applied == []   # assign bypassed the updater


# -- hostile payloads on the serving envelopes --------------------------------
def test_serving_rejects_hostile_predict_payload(tmp_path):
    """The serving envelopes decode through the SAME allowlisted
    unpickler as the gradient path: a malicious predict request is
    refused, the connection dropped, no side effect runs, and the
    replica keeps serving well-formed clients."""
    marker = tmp_path / "pwned"

    class Evil:
        def __reduce__(self):
            return (os.system, (f"touch {marker}",))

    _rio = mx.recordio

    class EvilFileWriter:
        def __reduce__(self):
            return (_rio.MXRecordIO, (str(marker), "w"))

    params = _params()
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, params,
                         buckets=[1, 2], max_wait_s=0.0, warmup=False)
    rep.start_background()
    try:
        for payload in (Evil(), EvilFileWriter()):
            # enveloped predict carrying a gadget where the tensor
            # should be: decode fails inside the allowlist, the replica
            # drops the connection before any handler runs
            s = socket.create_connection(("127.0.0.1", rep.port),
                                         timeout=5)
            _send_msg(s, ("req", (0, "cafe"), 0,
                          ("predict", {"data": payload})))
            with pytest.raises((ConnectionError, OSError)):
                _recv_msg(s)
            s.close()
        # raw (un-enveloped) form must die the same way
        s = socket.create_connection(("127.0.0.1", rep.port), timeout=5)
        _send_msg(s, ("predict", {"data": Evil()}))
        with pytest.raises((ConnectionError, OSError)):
            _recv_msg(s)
        s.close()
        assert not marker.exists(), "hostile payload executed!"
        # replica is still healthy for honest clients
        cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
        try:
            out = cli.predict(np.zeros((1, FEAT), np.float32))
            assert out[0].shape == (1, HIDDEN)
        finally:
            cli.close()
    finally:
        rep.stop()


def test_malformed_predict_is_an_error_not_a_crash():
    """Well-formed frames with BAD predict payloads (wrong feature
    shape, not a dict, empty) come back as typed per-request errors;
    the replica survives all of them."""
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, _params(),
                         buckets=[1, 2], max_wait_s=0.0, warmup=False)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        with pytest.raises(MXNetError, match="feature shape"):
            cli.predict(np.zeros((1, FEAT + 2), np.float32))
        with pytest.raises(MXNetError, match="batch axis"):
            cli.predict(np.float32(3.0))
        # still serving
        assert cli.predict(np.zeros((2, FEAT),
                                    np.float32))[0].shape == (2, HIDDEN)
    finally:
        cli.close()
        rep.stop()


@pytest.mark.parametrize("fmt", ["classic", "sharded"])
def test_replica_from_checkpoint_both_formats(tmp_path, fmt):
    """A replica serves whatever checkpoint flavor the trainer wrote:
    the classic single-file format and the sharded multi-process format
    both load through checkpoint.load_serving_params."""
    params = _params(seed=11)
    sym = _softmax_symbol()
    prefix = str(tmp_path / "model")
    if fmt == "classic":
        mx.model.save_checkpoint(prefix, 3, sym, params, {})
    else:
        save_checkpoint_sharded = mx.checkpoint.save_checkpoint_sharded
        save_checkpoint_sharded(prefix, 3, sym, params, {})
    rep = ServingReplica.from_checkpoint(
        prefix, 3, {'data': (FEAT,)}, buckets=[2, 4], max_wait_s=0.0,
        warmup=False)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        x = np.random.RandomState(12).randn(3, FEAT).astype(np.float32)
        np.testing.assert_allclose(cli.predict(x)[0],
                                   _ref_softmax(x, params),
                                   rtol=1e-5, atol=1e-6)
    finally:
        cli.close()
        rep.stop()


def test_stats_envelope_shape():
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, _params(),
                         buckets=[1, 2], max_wait_s=0.0, warmup=False)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        cli.predict(np.zeros((1, FEAT), np.float32))
        st = cli.stats()
        for key in ("version", "buckets", "queue_depth", "queue_limit",
                    "batches", "shed", "refreshes", "latency"):
            assert key in st, st
        assert st["buckets"] == [1, 2]
        assert st["latency"]["count"] >= 1
    finally:
        cli.close()
        rep.stop()


# -- health section in serving stats -------------------------------------------
def test_serving_stats_carries_health_section(monkeypatch):
    """Satellite of the health layer: the ``serving_stats`` reply — and
    the universal ``("stats",)`` payload's ``serving`` section — carry
    the replica's OK/DEGRADED/CRITICAL verdict, so a router can steer
    on serving stats alone."""
    health = mx.health
    health.reset()
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, _params(),
                         buckets=[1, 2], max_wait_s=0.0, warmup=False)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        st = cli.stats()
        assert st["health"]["status"] in ("OK", "DEGRADED", "CRITICAL")
        assert "trips" in st["health"]
        payload = rep._stats_payload()
        assert payload["serving"]["health"]["status"] \
            == payload["health"]["status"]
    finally:
        cli.close()
        rep.stop()


def test_busy_storm_flips_replica_degraded_and_back(monkeypatch):
    """BusyError storms degrade the replica and recovery runs through
    hysteresis — pinned with injected clocks so there is NO flapping
    window at all: storm → DEGRADED; sheds age out of the window →
    still DEGRADED (recovering); past recovery → OK."""
    health = mx.health
    monkeypatch.setenv("MXNET_HEALTH_BUSY_STORM", "3")
    monkeypatch.setenv("MXNET_HEALTH_BUSY_WINDOW_S", "0.5")
    monkeypatch.setenv("MXNET_HEALTH_RECOVERY_S", "2.0")
    health.reconfigure()
    health.reset()
    stub = _BlockingPredictor()
    b = DynamicBatcher(stub, max_wait_s=0.0, queue_depth=1)
    try:
        x = {"data": np.ones((1, 2), np.float32)}
        s1 = b.submit(x)
        assert stub.started.wait(10)    # worker parked inside predict
        s2 = b.submit(x)                # fills the depth-1 queue
        shed = [b.submit(x) for _ in range(3)]   # the BUSY storm
        assert all(s.done.is_set() and s.reply[1][0] == "busy"
                   for s in shed)
        assert b.shed == 3
        t_storm = time.monotonic()
        assert health.status(now=t_storm) == "DEGRADED"
        assert health.event_counts().get("busy_shed", 0) >= 3
        # sheds aged out of the 0.5s window: the storm condition is
        # gone (status would be OK without hysteresis), but the
        # recovery window holds DEGRADED — no flap
        assert health.status(now=t_storm + 0.6) == "DEGRADED"
        # past last_bad + recovery: OK again
        assert health.status(now=t_storm + 3.0) == "OK"
        stub.release.set()
        for s in (s1, s2):
            assert s.done.wait(10)
    finally:
        stub.release.set()
        b.stop()
        health.reset()
        with monkeypatch.context() as m:
            m.delenv("MXNET_HEALTH_BUSY_STORM", raising=False)
            m.delenv("MXNET_HEALTH_BUSY_WINDOW_S", raising=False)
            m.delenv("MXNET_HEALTH_RECOVERY_S", raising=False)
            health.reconfigure()


# -- binary wire codec on the serving plane -----------------------------------
def test_predict_storm_serializes_zero_pickled_bytes(monkeypatch):
    """A predict storm over a negotiated
    connection records pickle_bytes == 0 — the predict envelope and its
    ack both ride the generated binary frame (codec(binary) in the
    protocol table)."""
    monkeypatch.setenv("MXNET_KVSTORE_CODEC", "binary")
    params = _params()
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)}, params,
                         buckets=[1, 2, 4], max_wait_s=0.01)
    rep.start_background()
    cli = ServingClient(f"127.0.0.1:{rep.port}", window=16)
    try:
        rs = np.random.RandomState(7)
        x = rs.randn(4, FEAT).astype(np.float32)
        ref = _ref_softmax(x, params)
        cli.predict(x[:1])               # warm-up: compiles + hello done
        profiler.reset_serialization()
        futs = [cli.predict_async(x[i % 4:i % 4 + 1]) for i in range(32)]
        for i, fut in enumerate(futs):
            np.testing.assert_allclose(fut.get()[0],
                                       ref[i % 4:i % 4 + 1],
                                       rtol=1e-5, atol=1e-6)
        counts = profiler.serialization_counts()
        assert counts.get("pickle_bytes", 0) == 0, counts
        assert counts.get("codec_bytes", 0) > 0, counts
    finally:
        cli.close()
        rep.stop()
