"""The port's ``dist_async`` store and parameter server against the JAX
package's: the non-elastic, non-hierarchical cases of
``tests/test_kvstore.py:189-1315`` at the store's level, each run
through both packages against in-process servers of the same package
(``KVStoreServer(...).start_background()``, as the JAX package's tests
run them) and compared.  The values are small integers, their sums and
products by powers of two, and 2-bit quanta, exact in float32, so the
comparisons are exact but where a test names its tolerance; wire bytes
are compared exactly too, since both packages emit the same frames."""
import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from torch_dist import PKGS, cluster, nd, pulled, zeros
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (4, 4)
BOTH = pytest.mark.parametrize("name", ["jax", "port"])


def _both(fn, monkeypatch, **kw):
    """``fn(pkg)`` through each package; their results, equal."""
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch, **kw):
            got[name] = fn(pkg)
    _assert_same(got["jax"], got["port"])
    return got["port"]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


def test_dist_async_inprocess(monkeypatch):
    """init / pull, push without an updater (assign), first init wins, a
    multi-value push reduced before the wire, the server's SGD, a
    barrier, and an application error failing one op only."""
    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        assert kv.type == 'dist_async' and kv.rank == 0 \
            and kv.num_workers == 1
        got = []
        kv.init('a', nd(pkg, np.ones(SHAPE)))
        got.append(pulled(pkg, kv, 'a', SHAPE))
        kv.push('a', nd(pkg, np.ones(SHAPE) * 3))
        got.append(pulled(pkg, kv, 'a', SHAPE))
        kv.init('a', nd(pkg, np.ones(SHAPE) * 9))
        got.append(pulled(pkg, kv, 'a', SHAPE))
        kv.push('a', [nd(pkg, np.ones(SHAPE)), nd(pkg, np.ones(SHAPE) * 2)])
        got.append(pulled(pkg, kv, 'a', SHAPE))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        kv.init('b', zeros(pkg, SHAPE))
        kv.push('b', nd(pkg, np.ones(SHAPE)))
        got.append(pulled(pkg, kv, 'b', SHAPE))
        kv.barrier()
        with pytest.raises(Exception, match="uninitialized"):
            kv.pull('nope', out=zeros(pkg, SHAPE))
        got.append(pulled(pkg, kv, 'b', SHAPE))
        kv.close(stop_servers=True)
        return got
    got = _both(scenario, monkeypatch)
    assert [float(g[0, 0]) for g in got] == [1, 3, 3, 3, -0.5, -0.5]


def test_dist_async_row_sparse_pull(monkeypatch):
    """Only the requested rows travel; dense and row-sparse outs."""
    full = np.arange(40, dtype=np.float32).reshape(10, 4)

    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        kv.init('emb', nd(pkg, full))
        rid = nd(pkg, [7, 2, 2, 5], np.int64)
        dense = zeros(pkg, (10, 4))
        kv.row_sparse_pull('emb', out=dense, row_ids=rid)
        rsp = pkg.nd.sparse.zeros('row_sparse', (10, 4))
        kv.row_sparse_pull('emb', out=rsp, row_ids=rid)
        kv.close(stop_servers=True)
        return [dense.asnumpy(), rsp.indices.asnumpy().astype(np.int64),
                rsp.data.asnumpy()]
    dense, idx, rows = _both(scenario, monkeypatch)
    np.testing.assert_array_equal(idx, [2, 5, 7])
    np.testing.assert_array_equal(rows, full[[2, 5, 7]])
    assert dense[[0, 1, 3]].sum() == 0


@BOTH
def test_dist_async_server_death_surfaces_as_error(monkeypatch, name):
    """A dead server surfaces as an MXNetError on the next op, never a
    silent hang (millisecond backoff: the error contract is under
    test)."""
    pkg = PKGS[name]
    with cluster(pkg, monkeypatch, MXNET_KVSTORE_RETRY_MAX=4,
                 MXNET_KVSTORE_RETRY_INITIAL_MS=10,
                 MXNET_KVSTORE_RETRY_MAX_MS=50) as (srv,):
        kv = pkg.kv.create('dist_async')
        kv.init('a', nd(pkg, np.ones(SHAPE)))
        pulled(pkg, kv, 'a', SHAPE)
        srv.stop()
        deadline = time.time() + 30
        with pytest.raises(pkg.base.MXNetError):
            while time.time() < deadline:
                pulled(pkg, kv, 'a', SHAPE)
        kv.close()


def test_dist_async_bigarray_striping(monkeypatch):
    """Arrays above MXNET_KVSTORE_BIGARRAY_BOUND stripe row-wise across
    every server, one server key a stripe: pull and push reassemble,
    SGD applies per stripe, row_sparse_pull routes ids to the owning
    stripes, a fresh client derives the plan from ``out``, out-of-range
    ids fail, and lr_mult keys by the BASE key."""
    big = np.arange(40, dtype=np.float32).reshape(10, 4)

    def scenario(pkg):
        srvs = scenario.srvs
        kv = pkg.kv.create('dist_async')
        kv.init('big', nd(pkg, big))
        got = [[len(s._store) for s in srvs],
               sorted(k for s in srvs for k in s._store)]
        got.append(pulled(pkg, kv, 'big', (10, 4)))
        kv.push('big', nd(pkg, big * 3))
        got.append(pulled(pkg, kv, 'big', (10, 4)))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        kv.push('big', nd(pkg, np.ones((10, 4))))
        got.append(pulled(pkg, kv, 'big', (10, 4)))
        rsp = pkg.nd.sparse.zeros('row_sparse', (10, 4))
        kv.row_sparse_pull('big', out=rsp,
                           row_ids=nd(pkg, [9, 0, 3], np.int64))
        got += [rsp.indices.asnumpy().astype(np.int64), rsp.data.asnumpy()]
        kv2 = pkg.kv.create('dist_async')
        got.append(pulled(pkg, kv2, 'big', (10, 4)))
        rsp2 = pkg.nd.sparse.zeros('row_sparse', (10, 4))
        kv2.row_sparse_pull('big', out=rsp2,
                            row_ids=nd(pkg, [8], np.int64))
        got.append(rsp2.data.asnumpy())
        kv2.close()
        with pytest.raises(pkg.base.MXNetError, match="out of range"):
            kv.row_sparse_pull('big', out=zeros(pkg, (10, 4)),
                               row_ids=nd(pkg, [0, 10], np.int64))
        opt2 = pkg.optimizer.SGD(learning_rate=1.0, momentum=0.0, wd=0.0,
                                 rescale_grad=1.0)
        opt2.set_lr_mult({'big': 0.0})
        kv.set_optimizer(opt2)
        kv.push('big', nd(pkg, np.ones((10, 4))))
        got.append(pulled(pkg, kv, 'big', (10, 4)))
        kv.close(stop_servers=True)
        return got

    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch, n=2,
                     MXNET_KVSTORE_BIGARRAY_BOUND=16) as srvs:
            scenario.srvs = srvs
            got[name] = scenario(pkg)
    _assert_same(got["jax"], got["port"])
    counts, keys, *vals = got["port"]
    assert counts == [1, 1] and keys == ['big@s0', 'big@s1']
    np.testing.assert_array_equal(vals[2], big * 3 - 0.5)
    np.testing.assert_array_equal(vals[-1], big * 3 - 0.5)


def test_dist_async_stale_checkpoint_after_load(monkeypatch):
    """save -> load -> train -> save over two servers: each key's saved
    momentum is its OWNER's fresh one (ADVICE r5), and the port's file
    loads in the JAX package's format."""
    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        keys, i = [], 0
        while len(keys) < 2:
            k = f"w{i}"
            if not keys or kv._conn_of(k) is not kv._conn_of(keys[0]):
                keys.append(k)
            i += 1
        for k in keys:
            kv.init(k, zeros(pkg, (2,)))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                           wd=0.0, rescale_grad=1.0))
        for k in keys:
            kv.push(k, nd(pkg, np.ones((2,))))
        pulled(pkg, kv, keys[0], (2,))
        fname = os.path.join(scenario.tmp, f"{pkg.__name__}.states")
        kv.save_optimizer_states(fname)
        kv.load_optimizer_states(fname)
        for k in keys:
            kv.push(k, nd(pkg, np.ones((2,))))
        pulled(pkg, kv, keys[0], (2,))
        kv.save_optimizer_states(fname)
        kv.close(stop_servers=True)
        # either package's Updater reads the file (the JAX one for both)
        up = mx.optimizer.get_updater(mx.optimizer.SGD(momentum=0.9))
        with open(fname, 'rb') as f:
            up.set_states(f.read())
        return keys, {k: np.asarray(up.states[k][0].asnumpy()
                                    if isinstance(up.states[k], tuple)
                                    else up.states[k].asnumpy())
                      for k in keys}

    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        scenario.tmp = tmp
        keys, moms = _both(scenario, monkeypatch, n=2)
    for k in keys:
        np.testing.assert_allclose(moms[k], -0.95, rtol=1e-6)


def test_assign_bypasses_updater(monkeypatch):
    """The 'assign' envelope stores verbatim, never through the server's
    optimizer, and creates missing keys."""
    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        kv.init('w', zeros(pkg, SHAPE))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.1, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        kv.push('w', nd(pkg, np.ones(SHAPE)))
        kv.assign('w', nd(pkg, np.ones(SHAPE) * 42))
        kv.assign('meta', nd(pkg, np.ones((1,)) * 5))
        got = [pulled(pkg, kv, 'w', SHAPE), pulled(pkg, kv, 'meta', (1,))]
        kv.close(stop_servers=True)
        return got
    w, meta = _both(scenario, monkeypatch)
    assert (w == 42).all() and (meta == 5).all()


def _push_bytes(pkg, monkeypatch, compression):
    # no heartbeat socket: its codec hello's reply counts as "sent" on an
    # in-process server whenever it lands
    with cluster(pkg, monkeypatch, MXNET_KVSTORE_HEARTBEAT_INTERVAL=0):
        kv = pkg.kv.create('dist_async')
        if compression:
            kv.set_gradient_compression(compression)
        kv.init('w', zeros(pkg, (256, 256)))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        pkg.profiler.reset_channel_bytes()
        kv.push('w', nd(pkg, np.ones((256, 256))))
        kv._conns[0].flush()
        sent = pkg.profiler.channel_bytes().get("sent", 0)
        kv.close(stop_servers=True)
        return sent


@pytest.mark.parametrize("compression,ratio", [
    (None, 1.0), ({'type': '2bit', 'threshold': 0.5}, 8.0),
    ({'type': 'fp16'}, 1.9)], ids=["raw", "2bit", "fp16"])
def test_dist_async_2bit_push_wire_bytes_8x(monkeypatch, compression,
                                            ratio):
    """The transport byte counters: the port's push bytes equal the JAX
    package's exactly (the same frames), and 2-bit cuts them >= 8x
    against raw fp32 (fp16 about 2x)."""
    raw = _push_bytes(mt, monkeypatch, None)
    port = _push_bytes(mt, monkeypatch, compression)
    assert port == _push_bytes(mx, monkeypatch, compression)
    assert raw > 256 * 256 * 4
    assert raw / port >= ratio, (raw, port)


def test_2bit_error_feedback_residual_drains(monkeypatch):
    """A gradient below the threshold is not lost: it accumulates in the
    worker's residual until a quantum fires; the applied total and the
    residual equal the JAX package's bit for bit."""
    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        kv.set_gradient_compression({'type': '2bit', 'threshold': 1.0})
        kv.init('w', zeros(pkg, (2, 2)))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=1.0, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        for _ in range(10):
            kv.push('w', nd(pkg, np.full((2, 2), 0.4)))
        got = [pulled(pkg, kv, 'w', (2, 2)),
               np.asarray(kv._gc_residual['w'])]
        kv.close(stop_servers=True)
        return got
    w, residual = _both(scenario, monkeypatch)
    fired = -int(w[0, 0])
    assert fired >= 3 and np.all(np.abs(residual) < 1.0)
    np.testing.assert_allclose(residual, 10 * np.float32(0.4) - fired,
                               rtol=1e-6)


def test_dist_async_2bit_convergence(monkeypatch):
    """Least squares through the server's SGD reaches the same tolerance
    with 2-bit compression as without, and each run's trajectory equals
    the JAX package's (the gradients are computed in numpy here)."""
    rs = np.random.RandomState(3)
    X = rs.normal(size=(32, 4)).astype(np.float32)
    y = X @ np.array([[1.5], [-2.0], [0.5], [3.0]], np.float32)

    def train(pkg, compress, iters=160):
        kv = pkg.kv.create('dist_async')
        if compress:
            kv.set_gradient_compression({'type': '2bit', 'threshold': 1.0})
        kv.init('w', zeros(pkg, (4, 1)))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.05, momentum=0.0,
                                           wd=0.0, rescale_grad=1.0))
        for _ in range(iters):
            w = pulled(pkg, kv, 'w', (4, 1))
            kv.push('w', nd(pkg, X.T @ (X @ w - y) / len(X)))
        w = pulled(pkg, kv, 'w', (4, 1))
        kv.close(stop_servers=True)
        return w

    for compress in (False, True):
        w = _both(lambda pkg: train(pkg, compress), monkeypatch)
        assert float(np.mean((X @ w - y) ** 2)) < 1e-3, compress


def test_dist_async_fp16_wire_mode(monkeypatch):
    """fp16 pushes: values exact in fp16 round-trip; the pull is fp32."""
    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        kv.set_gradient_compression({'type': 'fp16'})
        kv.init('w', zeros(pkg, SHAPE))
        kv.push('w', nd(pkg, np.full(SHAPE, 1.5)))
        out = pulled(pkg, kv, 'w', SHAPE)
        kv.close(stop_servers=True)
        return [out, str(out.dtype)]
    out, dtype = _both(scenario, monkeypatch)
    assert dtype == "float32" and (out == 1.5).all()


def test_dist_async_coalesced_multi_key_push(monkeypatch):
    """A LIST push of small keys bound for one server is ONE envelope;
    above MXNET_KVSTORE_COALESCE_BYTES each key is its own."""
    keys = ['ck1', 'ck2', 'ck3']

    def scenario(pkg):
        kv = pkg.kv.create('dist_async')
        for k in keys:
            kv.init(k, zeros(pkg, (2, 2)))
        seq = kv._conns[0]._next_seq
        kv.push(keys, [nd(pkg, np.ones((2, 2)) * (i + 1))
                       for i in range(3)])
        kv._conns[0].flush()
        got = [kv._conns[0]._next_seq - seq]
        got += [pulled(pkg, kv, k, (2, 2)) for k in keys]
        os.environ["MXNET_KVSTORE_COALESCE_BYTES"] = "8"
        try:
            kv2 = pkg.kv.create('dist_async')
        finally:
            del os.environ["MXNET_KVSTORE_COALESCE_BYTES"]
        seq = kv2._conns[0]._next_seq
        kv2.push(keys, [nd(pkg, np.ones((2, 2)))] * 3)
        kv2._conns[0].flush()
        got.append(kv2._conns[0]._next_seq - seq)
        kv2.close()
        kv.close(stop_servers=True)
        return got
    got = _both(scenario, monkeypatch)
    assert got[0] == 2 and got[-1] == 4


def test_pull_async_matches_pull_and_counts_one_round(monkeypatch):
    """pull_async resolves to the values a pull writes, one wire round a
    handle (a second wait is a cache hit), and observes earlier
    pushes (per-server FIFO)."""
    def scenario(pkg):
        prof = pkg.profiler
        kv = pkg.kv.create('dist_async')
        kv.init('pa1', nd(pkg, np.ones((2, 2)) * 3))
        kv.init('pa2', nd(pkg, np.ones((3,)) * 5))
        prof.reset_wire_counters()
        h = kv.pull_async(['pa1', 'pa2'], [(2, 2), (3,)])
        vals = h.wait()
        got = [vals['pa1'], vals['pa2'], prof.wire_rounds()]
        assert prof.wire_round_ms() >= prof.wire_wait_ms() >= 0.0
        assert h.wait() is vals
        got.append(prof.wire_rounds())
        kv.push('pa2', nd(pkg, np.ones((3,)) * 4))
        got.append(kv.pull_async('pa2', (3,)).wait()['pa2'])
        kv.close(stop_servers=True)
        return got
    got = _both(scenario, monkeypatch)
    assert got[2] == got[3] == 1 and (got[4] == 4).all()


@BOTH
def test_app_error_poison_still_delivers_queued_pushes(monkeypatch, name):
    """An application error on a fire-and-forget push poisons the
    channel for NEW requests, but the push queued behind it is still
    delivered (a lost gradient must not pass silently)."""
    pkg = PKGS[name]
    with cluster(pkg, monkeypatch, MXNET_KVSTORE_WINDOW=1):
        kv = pkg.kv.create('dist_async')
        kv.init('w', zeros(pkg, SHAPE))
        with pkg.faultinject.delay_acks(0.05):
            kv.push('nope', nd(pkg, np.ones(SHAPE)))
            kv.push('w', nd(pkg, np.ones(SHAPE) * 5))
        kv2 = pkg.kv.create('dist_async')
        deadline = time.time() + 10
        while time.time() < deadline:
            if pulled(pkg, kv2, 'w', SHAPE).max() == 5.0:
                break
            time.sleep(0.02)
        np.testing.assert_array_equal(pulled(pkg, kv2, 'w', SHAPE), 5.0)
        with pytest.raises(pkg.base.MXNetError, match="channel failed"):
            pulled(pkg, kv, 'w', SHAPE)
        kv2.close(stop_servers=True)
        kv.close()


class _Evil:
    marker = None

    def __reduce__(self):
        return (os.system, (f"touch {self.marker}",))


class _CustomUserOpt(mt.optimizer.SGD):
    """Module-level so pickle can name it (a user's own optimizer class
    outside the package)."""


def test_wire_rejects_hostile_pickle(monkeypatch, tmp_path):
    """The port's decoder is allowlisted as the JAX package's is: a
    callable outside the list (os.system, numpy's exec helper, a
    module-level function, a class that binds a socket) is refused, the
    server drops that connection and keeps serving."""
    from mxnet_tpu_torch.kvstore_server import (KVStoreServer,
                                                _restricted_loads,
                                                _recv_msg, _send_msg)
    marker = tmp_path / "pwned"
    _Evil.marker = marker

    class EvilNumpyGadget:
        def __reduce__(self):
            import numpy.testing
            return (numpy.testing.runstring, ("x = 1", {}))

    class EvilModuleFunc:
        def __reduce__(self):
            return (mt.optimizer.create, ("sgd",))

    class EvilSocketBinder:
        def __reduce__(self):
            return (KVStoreServer, (0, 1, "127.0.0.1", 0))

    for evil in (_Evil(), EvilNumpyGadget(), EvilModuleFunc(),
                 EvilSocketBinder()):
        with pytest.raises(pickle.UnpicklingError, match="refusing"):
            _restricted_loads(pickle.dumps(evil))
    with cluster(mt, monkeypatch) as (srv,):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        _send_msg(s, ("push", "w", _Evil()))
        with pytest.raises((ConnectionError, OSError)):
            _recv_msg(s)
        s.close()
        assert not marker.exists(), "hostile payload executed!"
        kv = mt.kv.create('dist_async')
        kv.init('ok', nd(mt, np.ones(SHAPE)))
        np.testing.assert_array_equal(pulled(mt, kv, 'ok', SHAPE), 1.0)
        kv.close(stop_servers=True)


def test_custom_optimizer_needs_env_allowlist(monkeypatch):
    """A user-defined optimizer class is refused by default and admitted
    when MXNET_KVSTORE_PICKLE_ALLOWLIST names its module; then it trains
    through a live server."""
    from mxnet_tpu_torch.kvstore_server import _restricted_loads
    blob = pickle.dumps(_CustomUserOpt(learning_rate=0.5))
    monkeypatch.delenv("MXNET_KVSTORE_PICKLE_ALLOWLIST", raising=False)
    with pytest.raises(pickle.UnpicklingError,
                       match="MXNET_KVSTORE_PICKLE_ALLOWLIST"):
        _restricted_loads(blob)
    monkeypatch.setenv("MXNET_KVSTORE_PICKLE_ALLOWLIST",
                       _CustomUserOpt.__module__)
    loaded = _restricted_loads(blob)
    assert isinstance(loaded, mt.optimizer.SGD) and loaded.lr == 0.5
    with cluster(mt, monkeypatch):
        kv = mt.kv.create('dist_async')
        kv.init('w', nd(mt, np.ones(SHAPE)))
        kv.set_optimizer(_CustomUserOpt(learning_rate=0.5, momentum=0.0,
                                        wd=0.0, rescale_grad=1.0))
        kv.push('w', nd(mt, np.ones(SHAPE)))
        np.testing.assert_array_equal(pulled(mt, kv, 'w', SHAPE), 0.5)
        kv.close(stop_servers=True)


def test_wire_frame_roundtrip_zero_copy():
    """Nested tuples, lists and dicts of arrays round-trip exactly through
    the port's frames (dtype, shape, 0-d, empty, int64), and each frame
    is the JAX package's byte for byte."""
    from mxnet_tpu_torch.kvstore_server import (_frame_parts, _recv_msg,
                                                _send_msg)
    from mxnet_tpu.kvstore_server import _frame_parts as jax_frame_parts
    msgs = [
        ("init", "w", np.arange(12, dtype=np.float32).reshape(3, 4)),
        ("ok", (np.ones((2, 3), np.float64), (4, 3))),
        ("push", "k", np.float32(7.5) * np.ones((), np.float32)),
        ("pull_rows", "k", np.array([], np.int64)),
        {"states": [np.arange(4, dtype=np.int64)]},
    ]
    for m in msgs:
        port = b"".join(bytes(p) for p in _frame_parts(m, False)[0])
        jax = b"".join(bytes(p) for p in jax_frame_parts(m, False)[0])
        assert port == jax
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=lambda: [_send_msg(a, m) for m in msgs])
        t.start()
        for want in msgs:
            _assert_same(want, _recv_msg(b))
        t.join()
    finally:
        a.close()
        b.close()


def test_dist_async_rejects_stripe_separator_keys(monkeypatch):
    """User keys holding the reserved '@s' separator are refused before
    they can collide with a stripe key (ADVICE r5)."""
    with cluster(mt, monkeypatch):
        kv = mt.kv.create('dist_async')
        with pytest.raises(mt.MXNetError, match="@s"):
            kv.init('w@s0', nd(mt, np.ones((2,))))
        with pytest.raises(mt.MXNetError, match="@s"):
            kv.push('w@s1', nd(mt, np.ones((2,))))
        kv.close(stop_servers=True)


def test_dist_async_load_save_relay_preserves_states(monkeypatch):
    """A pure load -> save relay on a fresh two-server cluster keeps every
    key: shards with an empty store return what they loaded."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        fname = os.path.join(tmp, "states")
        ckpt = {'w0': (mx.nd.ones((2,)) * 3,), 'w1': (mx.nd.ones((2,)) * 5,)}
        with open(fname, 'wb') as f:
            f.write(pickle.dumps(ckpt))
        with cluster(mt, monkeypatch, n=2):
            kv = mt.kv.create('dist_async')
            kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5,
                                              momentum=0.9, wd=0.0,
                                              rescale_grad=1.0))
            kv.load_optimizer_states(fname)
            kv.save_optimizer_states(fname)
            kv.close(stop_servers=True)
        up = mx.optimizer.get_updater(mx.optimizer.SGD(momentum=0.9))
        with open(fname, 'rb') as f:
            up.set_states(f.read())
    assert set(up.states) == {'w0', 'w1'}
    np.testing.assert_array_equal(up.states['w0'][0].asnumpy(), 3.0)
    np.testing.assert_array_equal(up.states['w1'][0].asnumpy(), 5.0)


def test_server_roster_and_handoff_ops_answer_as_the_jax_package(
        monkeypatch):
    """The static server's answers to the elastic plane's cold ops: a
    roster op errs "not the roster coordinator", a beat banks and
    answers None, a handoff applies once per (key, generation), the
    ledger report names the generation; and the server's store lives on
    the host.  ``elastic=True`` raises, naming E2."""
    def scenario(pkg):
        srv = scenario.srvs[0]
        got = []
        for msg in (("roster_get",), ("roster_join", "worker", 3),
                    ("roster_snapshot", "x")):
            try:
                srv._handle(msg)
                got.append("ok")
            except RuntimeError as exc:
                got.append(str(exc))
        got.append(srv._handle(("roster_beat", "peer:1", 4, None,
                                {"a": 1})))
        got.append(srv._handle(("handoff", 2, "w", np.ones(3, np.float32),
                                "w")))
        got.append(srv._handle(("handoff", 2, "w", np.ones(3, np.float32),
                                "w")))
        rep = srv._handle(("ledger_report",))
        got.append({k: rep[k] for k in ("generation", "beat_seq", "keys")})
        got.append(srv._stats_payload()["stats_bank"])
        return got
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch) as srvs:
            scenario.srvs = srvs
            got[name] = scenario(pkg)
    _assert_same(got["jax"], got["port"])
    with pytest.raises(mt.MXNetError, match="E2"):
        mt.kvstore_server.KVStoreServer(elastic=True)
    with cluster(mt, monkeypatch) as (srv,):
        kv = mt.kv.create('dist_async')
        kv.init('w', nd(mt, np.ones(SHAPE)))
        assert srv._store['w']._data.device.type == "cpu"
        assert kv.server_stats(0)["server"]["device"] == "cpu"
        kv.close(stop_servers=True)
