"""Serving path of the PyTorch port (CPU): ``BucketedPredictor`` on the
small LM against the JAX package, and ``DynamicBatcher``'s admission,
coalescing and crash behaviour (mirroring tests/test_serving.py).

Tolerance in float32: 1e-5 in log-probability (summation order only).

The JAX ``BucketedPredictor`` slices every output to its first n rows;
the LM's output is the flattened (B*S, vocab) softmax, so its reply
holds only the first n token rows.  The port keeps whole examples (n*S
rows); the tests compare the port's full reply against the JAX forward
of the unpadded request, and its first n rows against the JAX reply."""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mxnet_tpu import models as jmodels
from mxnet_tpu.executor import build_interpreter as jbuild
from mxnet_tpu.serving import BucketedPredictor as JPredictor

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.serving import (BucketedPredictor, BusyError,
                                     DynamicBatcher, parse_buckets)
import torch_threads  # noqa: F401,E402  a worker's share of the cores

V, S = 50, 16
KW = dict(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2)
DATA_SHAPES = {"data": (S,), "softmax_label": (S,)}
LOGP_TOL = 1e-5


def _net(jax_side=False):
    return (jmodels if jax_side else mt.models).transformer_lm(V, S, **KW)


def _params(seed=0):
    net = _net()
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(1, S), softmax_label=(1, S))[0]))
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.3).astype(np.float32)
            for n, s in shapes.items()
            if n not in ("data", "softmax_label")}


def _request(n, seed):
    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, V, (n, S)).astype(np.int32),
            "softmax_label": np.zeros((n, S), np.float32)}


def _jax_forward(params, req):
    net = _net(jax_side=True)
    run, names, _ = jbuild(net)
    vals = [jnp.asarray(req[n] if n in req else params[n]) for n in names]
    return np.asarray(run(vals, [], jax.random.PRNGKey(0), False)[0][0])


def _predictor(params, buckets=(1, 2, 4)):
    args, aux = mt.params_from_numpy(params, {}, mt.cpu(), _net(),
                                     {"data": (1, S), "softmax_label": (1, S)})
    return BucketedPredictor(_net(), DATA_SHAPES, args, aux,
                             buckets=buckets,
                             data_dtypes={"data": np.int32}, ctx=mt.cpu())


def _close(got, ref):
    assert got.shape == ref.shape
    diff = np.abs(np.log(got) - np.log(ref)).max()
    assert diff <= LOGP_TOL, diff


def test_padded_rows_are_sliced_and_match_jax():
    params = _params()
    pred = _predictor(params)
    jpred = JPredictor(_net(jax_side=True), DATA_SHAPES, params,
                       buckets=[1, 2, 4], data_dtypes={"data": np.int32})
    for n, seed in ((3, 1), (1, 2), (4, 3)):
        req = _request(n, seed)
        v, outs = pred.predict(req)
        assert v == 0 and len(outs) == 1
        assert outs[0].shape == (n * S, V)        # bucket padding gone
        _close(outs[0], _jax_forward(params, req))
        _, jouts = jpred.predict(req)
        _close(outs[0][:n], jouts[0])


def test_oversize_request_chunks_and_counters_are_pinned():
    params = _params()
    tprof.reset_dispatch_counts()
    pred = _predictor(params, buckets=(1, 2, 4))
    assert pred.select_bucket(3) == 4 and pred.select_bucket(9) == 4
    req = _request(11, seed=5)
    _, outs = pred.predict(req)                  # chunks 4 + 4 + 3
    assert outs[0].shape == (11 * S, V)
    _close(outs[0], _jax_forward(params, req))
    counts = tprof.dispatch_counts()
    assert counts["serving.predict"] == 3
    assert counts["serving.predict_compile"] == 1   # only bucket 4 ran
    assert pred.warmup() == 3
    pred.predict(_request(2, seed=6))
    counts = tprof.dispatch_counts()
    assert counts["serving.predict_compile"] == 3 == len(pred.buckets)
    assert counts["serving.predict"] == 3 + 3 + 1
    assert tprof.host_syncs()["serving.predict_readback"] >= 7


def test_set_params_swaps_weights_without_rearchitecting():
    p0, p1 = _params(0), _params(1)
    pred = _predictor(p0)
    req = _request(2, seed=7)
    _close(pred.predict(req)[1][0], _jax_forward(p0, req))
    pred.set_params({k: torch.from_numpy(v) for k, v in p1.items()})
    assert pred.version == 1
    v, outs = pred.predict(req)
    assert v == 1
    _close(outs[0], _jax_forward(p1, req))
    bad = dict(p1, lm_head_bias=np.zeros(V + 1, np.float32))
    with pytest.raises(mt.MXNetError, match="re-architect"):
        pred.set_params(bad)
    missing = dict(p1)
    missing.pop("final_ln_beta")
    with pytest.raises(mt.MXNetError, match="missing"):
        pred.set_params(missing)
    assert pred.version == 1


def test_predict_validates_requests():
    pred = _predictor(_params())
    with pytest.raises(mt.MXNetError, match="missing data input"):
        pred.predict({"data": np.zeros((1, S), np.int32)})
    with pytest.raises(mt.MXNetError, match="feature shape"):
        pred.predict(_request(1, 0) | {"data": np.zeros((1, S + 1))})
    assert parse_buckets("8, 2,2,1") == [1, 2, 8]
    with pytest.raises(mt.MXNetError):
        parse_buckets("0,4")


def test_batcher_serves_concurrent_requests_like_direct_predict():
    params = _params()
    pred = _predictor(params, buckets=(1, 2, 4))
    tprof.reset_latency()
    b = DynamicBatcher(pred, max_wait_s=0.05, queue_depth=16)
    reqs = [_request(n, 10 + i) for i, n in enumerate((1, 3, 2, 1, 5))]
    slots = [None] * len(reqs)
    try:
        threads = [threading.Thread(
            target=lambda i=i: slots.__setitem__(i, b.submit(reqs[i])))
            for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        for req, slot in zip(reqs, slots):
            assert slot.done.wait(60)
            status, payload = slot.reply
            assert status == "ok" and payload[0] == "result", slot.reply
            got = payload[2][0]
            n = req["data"].shape[0]
            assert got.shape == (n * S, V)
            np.testing.assert_allclose(got, pred.predict(req)[1][0],
                                       rtol=1e-5, atol=1e-7)
        assert 1 <= b.batches < len(reqs)        # requests coalesced
        assert tprof.latency_stats("serving.request")["count"] == len(reqs)
    finally:
        b.stop()


class _BlockingPredictor:
    """Stub predictor whose forward parks on an event."""

    buckets = [1]

    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def predict(self, data):
        self.started.set()
        assert self.release.wait(30), "test never released the predictor"
        return 0, [np.asarray(data["data"])]


def test_queue_depth_shedding_returns_busy():
    stub = _BlockingPredictor()
    b = DynamicBatcher(stub, max_wait_s=0.0, queue_depth=2)
    try:
        x = {"data": np.ones((1, 2), np.float32)}
        s1 = b.submit(x)
        assert stub.started.wait(10)
        s2, s3 = b.submit(x), b.submit(x)
        assert b.queue_depth == 2
        s4 = b.submit(x)
        assert s4.done.is_set()
        status, payload = s4.reply
        assert status == "ok" and payload[0] == "busy"
        assert payload[1] == {"queue_depth": 2, "limit": 2}
        assert b.shed == 1
        assert tprof.channel_counts()["serving.busy_shed"] >= 1
        assert issubclass(BusyError, mt.MXNetError)
        stub.release.set()
        for s in (s1, s2, s3):
            assert s.done.wait(10)
            assert s.reply[0] == "ok" and s.reply[1][0] == "result"
    finally:
        stub.release.set()
        b.stop()


def test_batcher_coalesces_past_mixed_signatures():
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
        other = {"data": np.ones((1, 2), np.float64)}
        first = b.submit(a)
        assert stub.started.wait(10)
        s_a1, s_o, s_a2 = b.submit(a), b.submit(other), b.submit(a)
        stub.release.set()
        for s in (first, s_a1, s_o, s_a2):
            assert s.done.wait(10)
            assert s.reply[0] == "ok" and s.reply[1][0] == "result"
        assert stub.calls == [(1, "float32"), (2, "float32"),
                              (1, "float64")], stub.calls
    finally:
        stub.release.set()
        b.stop()


def test_predict_failure_fails_its_batch():
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


def test_worker_crash_fails_every_slot_and_later_submits():
    """A crash of the worker loop itself (not of one predict) parks the
    error: every queued slot and every later submit fail loudly."""
    go = threading.Event()

    class _Crashing:
        @property
        def buckets(self):       # read by the worker's collect loop
            assert go.wait(30)
            raise RuntimeError("collect crashed")

        def predict(self, data):
            return 0, [data["data"]]

    b = DynamicBatcher(_Crashing(), max_wait_s=0.0, queue_depth=8)
    try:
        queued = [b.submit({"data": np.ones((1, 2), np.float32)})
                  for _ in range(3)]
        assert not any(s.done.is_set() for s in queued)
        go.set()
        for s in queued:
            assert s.done.wait(10)
            assert s.reply[0] == "err" and "collect crashed" in s.reply[1]
        b._thread.join(10)
        assert not b._thread.is_alive()
        later = b.submit({"data": np.ones((1, 2), np.float32)})
        assert later.done.is_set() and later.reply[0] == "err"
        assert "batcher failed" in later.reply[1]
        bad = b.submit([1, 2])
        assert bad.reply[0] == "err" and "dict" in bad.reply[1]
    finally:
        go.set()
        b.stop()
