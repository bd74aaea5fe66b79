"""The happens-before shim (``analysis.hb``) over the hierarchical tier,
in both packages: the three mesh and lane cases of ``tests/test_hb.py``
as the JAX package's suite writes them (the leader and a follower's
fan-in under the strict shim, three ranks over a two-thread acceptor
pool and their shm lanes, the lane's single-writer probes), each run
once against the JAX package and once against the port (on the CPU),
each package's shim instrumenting its own tier."""
import threading
import time

import numpy as np
import pytest

from torch_both import both_packages
import mxnet_tpu as _jpkg
import mxnet_tpu_torch as _tpkg
import torch_threads  # noqa: F401  a worker's share of the cores

import mxnet_tpu.shmlane  # noqa: F401  a submodule neither package imports
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.shmlane  # noqa: F401


def _bind(p):
    return dict(mx=p, PKG=p, prof=p.profiler, hb=p.analysis.hb,
                shmlane=p.shmlane,
                KVStoreDistAsync=p.kvstore.KVStoreDistAsync,
                KVStoreServer=p.kvstore_server.KVStoreServer)


pkg = both_packages(globals(), _bind)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Each case leaves both packages' flight recorders clean and no fault
    plan armed (a lane's fallback notes channel trouble, which a later
    test file in the same worker would read as a CRITICAL verdict)."""
    yield
    for p in (_jpkg, _tpkg):
        p.health.reset()
        p.faultinject.reset()


class _Thread(threading.Thread):
    """A worker thread in the case's package's context: the port's
    default context is thread-local, so its workers enter ``cpu()``."""

    def __init__(self, target, args):
        p = PKG

        def run(*a):
            if p is mt:
                with mt.cpu():
                    return target(*a)
            return target(*a)
        super().__init__(target=run, args=args)


def _assert_clean(san, min_ops=100):
    assert san.op_count() >= min_ops, \
        "shim instrumented almost nothing (%d ops)" % san.op_count()
    assert san.violations() == [], "\n\n".join(san.violations())
    san.assert_race_free()


def test_hb_mesh_fanin_race_clean(monkeypatch):
    """The hierarchical tier's mesh fan-in under the STRICT shim: a
    leader + follower pair reduce in-mesh and resolve the SAME wire
    round through the leader's _PullHandle (mesh_collect served off a
    foreign thread) — race-clean, bit-identical to flat."""
    import socket as _socket

    def free_port():
        s = _socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    SHAPE, STEPS, LR = (6, 8), 3, 0.25

    def grad(rank, step):
        rs = np.random.RandomState(100 * rank + step)
        return rs.randint(-2, 3, SHAPE).astype(np.float32)

    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1")
    monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", "2")
    monkeypatch.setenv("MXT_MESH_URIS", f"127.0.0.1:{free_port()}")
    w0 = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    results, errors = {}, []
    with hb.shim(strict=True) as san:
        srv = KVStoreServer(server_id=0, num_workers=2)
        srv.start_background()
        monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")

        def worker(rank, kv):
            try:
                kv.init("w", mx.nd.NDArray(w0))
                kv.set_optimizer(mx.optimizer.SGD(
                    learning_rate=LR, momentum=0.0, wd=0.0,
                    rescale_grad=1.0))
                kv.barrier()
                out = mx.nd.zeros(SHAPE)
                for s in range(STEPS):
                    kv.push("w", mx.nd.NDArray(grad(rank, s)))
                    kv.pull("w", out=out)
                kv.barrier()
                kv.pull("w", out=out)
                results[rank] = out.asnumpy().copy()
            except BaseException as exc:  # noqa: BLE001 — to main
                errors.append((rank, exc))

        try:
            kv0 = KVStoreDistAsync(rank=0)   # leader binds the mesh
            kv1 = KVStoreDistAsync(rank=1)
            threads = [_Thread(target=worker, args=(r, kv))
                       for r, kv in ((0, kv0), (1, kv1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            assert all(not t.is_alive() for t in threads), "worker hung"
            expected = w0.copy()
            for s in range(STEPS):
                expected = expected - np.float32(LR) * (
                    grad(0, s) + grad(1, s))
            np.testing.assert_array_equal(results[0], expected)
            np.testing.assert_array_equal(results[1], expected)
            kv1.close()
            kv0.close(stop_servers=True)
        finally:
            srv.stop()
    _assert_clean(san)


def test_hb_mesh_acceptor_pool_race_clean(monkeypatch):
    """The PARALLEL fan-in under the STRICT shim: three ranks share a
    two-thread acceptor pool (pool < connection count, so one worker
    thread multiplexes several followers' sockets AND their shm lanes)
    while both followers deposit concurrently through the rings —
    race-clean, bit-identical to the analytic sequential result."""
    import socket as _socket

    def free_port():
        s = _socket.socket()
        s.bind(("", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    SHAPE, STEPS, LR = (6, 8), 3, 0.25

    def grad(rank, step):
        rs = np.random.RandomState(100 * rank + step)
        return rs.randint(-2, 3, SHAPE).astype(np.float32)

    monkeypatch.setenv("DMLC_NUM_WORKER", "3")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1")
    monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", "3")
    monkeypatch.setenv("MXNET_KVSTORE_MESH_ACCEPTORS", "2")
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "1")
    monkeypatch.setenv("MXT_MESH_URIS", f"127.0.0.1:{free_port()}")
    w0 = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    results, errors = {}, []
    with hb.shim(strict=True) as san:
        srv = KVStoreServer(server_id=0, num_workers=3)
        srv.start_background()
        monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")

        def worker(rank, kv):
            try:
                kv.init("w", mx.nd.NDArray(w0))
                kv.set_optimizer(mx.optimizer.SGD(
                    learning_rate=LR, momentum=0.0, wd=0.0,
                    rescale_grad=1.0))
                kv.barrier()
                out = mx.nd.zeros(SHAPE)
                for s in range(STEPS):
                    kv.push("w", mx.nd.NDArray(grad(rank, s)))
                    kv.pull("w", out=out)
                kv.barrier()
                kv.pull("w", out=out)
                results[rank] = out.asnumpy().copy()
            except BaseException as exc:  # noqa: BLE001 — to main
                errors.append((rank, exc))

        try:
            kv0 = KVStoreDistAsync(rank=0)   # leader binds the mesh
            kvs = [kv0] + [KVStoreDistAsync(rank=r) for r in (1, 2)]
            assert kv0._mesh_leader._acceptors == 2
            threads = [_Thread(target=worker, args=(r, kv))
                       for r, kv in enumerate(kvs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
            assert all(not t.is_alive() for t in threads), "worker hung"
            expected = w0.copy()
            for s in range(STEPS):
                expected = expected - np.float32(LR) * (
                    grad(0, s) + grad(1, s) + grad(2, s))
            for r in range(3):
                np.testing.assert_array_equal(results[r], expected)
            assert prof.shm_bytes_total() > 0
            for kv in kvs[1:]:
                kv.close()
            kv0.close(stop_servers=True)
        finally:
            srv.stop()
    _assert_clean(san)


def test_hb_shmlane_spsc_clean_then_cross_writer_caught():
    """One producer thread + one consumer thread over a lane is the
    design contract — zero violations.  Then the main thread pushes on
    the req ring the producer owned: the single-writer probe fires
    with both stacks, WITHOUT vector-clocking the (deliberately
    lock-free) index arithmetic itself."""
    with hb.shim() as san:
        lane = shmlane.ShmLane.create(8 * 1024)
        try:
            def produce():
                for i in range(5):
                    while not lane.send_request({"i": i}):
                        time.sleep(0.001)

            t = threading.Thread(target=produce)
            t.start()
            got = []
            deadline = time.monotonic() + 10
            while len(got) < 5 and time.monotonic() < deadline:
                m = lane.recv_request()
                if m is None:
                    time.sleep(0.001)
                    continue
                got.append(m["i"])
            t.join()
            assert got == list(range(5))
            assert not lane.dead()        # dead-flag probe is benign
            assert san.violations() == [], "\n".join(san.violations())
            lane.send_request({"i": 99})  # main writes producer's widx
            assert any("single-writer" in v for v in san.violations())
        finally:
            lane.destroy()
