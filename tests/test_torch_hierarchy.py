"""The hierarchical kvstore tier (``MXNET_KVSTORE_HIERARCHY``) in both
packages: the nine cases of ``tests/test_hierarchy.py`` as the JAX
package's suite writes them (the group arithmetic, the in-host sum, the
tier against the flat run bit for bit with the wire bytes moved onto the
in-host counters, the refusal under ``MXNET_KVSTORE_ELASTIC``, five
ranks over the shm lane, the wedged lane falling back to TCP bit for
bit, the fan-in timeout naming the missing rank, and the elastic pull
replan), each run once against the JAX package and once against the
port (on the CPU).  The port's ``_local_allreduce_sum`` is also held
against the JAX package's ``local_allreduce_sum`` bit for bit.  Every
final weight is held EXACTLY against its analytic golden (dyadic
values, an order-independent float32 sum)."""
import threading
import time

import numpy as np
import pytest
import torch

from torch_both import both_packages
import mxnet_tpu as _jpkg
import mxnet_tpu_torch as _tpkg
import torch_threads  # noqa: F401  a worker's share of the cores

import mxnet_tpu_torch as mt
from mxnet_tpu.parallel.mesh import local_allreduce_sum as _jax_allreduce_sum
from mxnet_tpu_torch.kvstore import _local_allreduce_sum as _port_allreduce_sum


def _port_sum_np(parts):
    """The port's sum with numpy parts (the JAX function's interface)."""
    out = _port_allreduce_sum([torch.from_numpy(np.asarray(parts[0]))]
                              + list(parts[1:]))
    return out.numpy()


def _bind(p):
    return dict(mx=p, PKG=p, membership=p.membership, prof=p.profiler,
                faultinject=p.faultinject, MXNetError=p.base.MXNetError,
                KVStoreDistAsync=p.kvstore.KVStoreDistAsync,
                KVStoreServer=p.kvstore_server.KVStoreServer,
                local_allreduce_sum=(_port_sum_np if p is mt
                                     else _jax_allreduce_sum))


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


# ---------------------------------------------------------------------------
# pure group arithmetic
# ---------------------------------------------------------------------------
def test_host_groups_partitions_consecutive_ranks():
    assert membership.host_groups(range(4), 2) == [(0, 1), (2, 3)]
    assert membership.host_groups(range(5), 2) == [(0, 1), (2, 3), (4,)]
    assert membership.host_groups([3, 1, 0, 2], 4) == [(0, 1, 2, 3)]
    # per_host 1 = every rank its own (flat) group
    assert membership.host_groups(range(3), 1) == [(0,), (1,), (2,)]


def test_mesh_group_leader_and_index():
    assert membership.mesh_group(0, range(4), 2) == (0, (0, 1), 0)
    assert membership.mesh_group(1, range(4), 2) == (0, (0, 1), 0)
    assert membership.mesh_group(3, range(4), 2) == (2, (2, 3), 1)
    with pytest.raises(ValueError):
        membership.mesh_group(9, range(4), 2)


def test_local_allreduce_sum_matches_stacked_sum():
    rs = np.random.RandomState(0)
    parts = [rs.randint(-3, 4, (4, 3)).astype(np.float32)
             for _ in range(3)]
    np.testing.assert_array_equal(
        local_allreduce_sum(parts), np.sum(np.stack(parts), axis=0))
    # single part passes through untouched
    np.testing.assert_array_equal(local_allreduce_sum(parts[:1]),
                                  parts[0])
    if PKG is mt:
        # the port's sum on the leader's tensor: bit for bit the JAX
        # function's on values that are not exact in float32, the
        # leader's part first, then the followers' in order
        rs = np.random.RandomState(1)
        for n in (2, 3, 5):
            parts = [rs.randn(64, 33).astype(np.float32) * 10 ** i
                     for i in range(n)]
            got = _port_allreduce_sum([torch.from_numpy(parts[0])]
                                      + parts[1:])
            want = _jax_allreduce_sum(parts)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(
                got.numpy().view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# hierarchical == flat equivalence (the CPU stub-mesh gate's twin)
# ---------------------------------------------------------------------------
STEPS = 4
LR = 0.25           # power of two: every update exact in fp32
SHAPE = (6, 8)


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _grad(rank, step):
    rs = np.random.RandomState(100 * rank + step)
    return rs.randint(-2, 3, SHAPE).astype(np.float32)


def _run_pair(monkeypatch, hier):
    """Two worker stores (ranks 0/1) against one fresh server; returns
    (final pulled weight, wire sent bytes, ici sent bytes) measured
    over the training rounds only.  Pins MXNET_KVSTORE_SHM=0: this
    harness is the pure-TCP baseline the byte assertions (and the CI
    gate's send_syscalls_per_step comparison) are anchored to — the
    shm lane has its own tests below."""
    srv = KVStoreServer(server_id=0, num_workers=2)
    srv.start_background()
    monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")
    monkeypatch.setenv("DMLC_NUM_WORKER", "2")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1" if hier else "0")
    monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", "2")
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "0")
    monkeypatch.setenv("MXT_MESH_URIS", f"127.0.0.1:{_free_port()}")
    w0 = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    results, errors = {}, []

    def worker(rank, kv):
        try:
            kv.init("w", mx.nd.NDArray(w0))
            kv.set_optimizer(mx.optimizer.SGD(
                learning_rate=LR, momentum=0.0, wd=0.0, rescale_grad=1.0))
            if rank == 0:
                prof.reset_channel_bytes()
            kv.barrier()
            out = mx.nd.zeros(SHAPE)
            for s in range(STEPS):
                kv.push("w", mx.nd.NDArray(_grad(rank, s)))
                kv.pull("w", out=out)
            kv.barrier()
            kv.pull("w", out=out)
            results[rank] = out.asnumpy().copy()
        except BaseException as exc:  # noqa: BLE001 — surface in main
            errors.append((rank, exc))

    try:
        # leader FIRST: it binds the mesh endpoint the follower dials
        kv0 = KVStoreDistAsync(rank=0)
        kv1 = KVStoreDistAsync(rank=1)
        threads = [_Thread(target=worker, args=(r, kv))
                   for r, kv in ((0, kv0), (1, kv1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert all(not t.is_alive() for t in threads), "worker hung"
        sent = prof.channel_bytes().get("sent", 0)
        ici = prof.ici_bytes_total()
        kv1.close()
        kv0.close(stop_servers=True)
        return results, sent, ici
    finally:
        srv.stop()


def test_hierarchical_equals_flat_bit_identical(monkeypatch):
    want = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    for r in range(2):
        for s in range(STEPS):
            want = want - np.float32(LR) * _grad(r, s)

    flat, flat_sent, flat_ici = _run_pair(monkeypatch, hier=False)
    hier, hier_sent, hier_ici = _run_pair(monkeypatch, hier=True)
    # every member of both runs converged onto the analytic golden:
    # summed-in-mesh SGD == two flat pushes, exactly (dyadic values)
    for r in range(2):
        np.testing.assert_array_equal(flat[r], want)
        np.testing.assert_array_equal(hier[r], want)
    # the tier moved bytes off the wire and onto the mesh
    assert flat_ici == 0
    assert hier_ici > 0
    assert hier_sent < flat_sent, (hier_sent, flat_sent)


def test_hierarchy_refuses_elastic(monkeypatch):
    srvs = [KVStoreServer(server_id=0, num_workers=1, elastic=True)]
    uri = f"127.0.0.1:{srvs[0].port}"
    srvs[0]._roster_servers = [uri]
    srvs[0].start_background()
    try:
        monkeypatch.setenv("MXT_SERVER_URIS", uri)
        monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
        monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1")
        monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", "2")
        monkeypatch.setenv("DMLC_NUM_WORKER", "2")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        with pytest.raises(MXNetError, match="HIERARCHY"):
            KVStoreDistAsync()
    finally:
        srvs[0].stop()


# ---------------------------------------------------------------------------
# shared-memory lane: 4 followers fan in over rings, bit-identical,
# payload off the sockets; a wedged drain falls back to TCP cleanly
# ---------------------------------------------------------------------------
def _run_group(monkeypatch, n_ranks, steps=3):
    """One host group of ``n_ranks`` workers (leader + followers, all
    in-process via the rank override) against one real server, shm lane
    ON.  Returns (per-rank final weights, shm bytes, socket ici payload
    bytes, socket send syscalls) measured over the training rounds."""
    srv = KVStoreServer(server_id=0, num_workers=n_ranks)
    srv.start_background()
    monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")
    monkeypatch.setenv("DMLC_NUM_WORKER", str(n_ranks))
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1")
    monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", str(n_ranks))
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "1")
    monkeypatch.setenv("MXT_MESH_URIS", f"127.0.0.1:{_free_port()}")
    w0 = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    results, errors, marks = {}, [], {}

    def worker(rank, kv):
        try:
            kv.init("w", mx.nd.NDArray(w0))
            kv.set_optimizer(mx.optimizer.SGD(
                learning_rate=LR, momentum=0.0, wd=0.0, rescale_grad=1.0))
            kv.barrier()
            if rank == 0:
                prof.reset_channel_bytes()
                prof.reset_serialization()
            kv.barrier()
            out = mx.nd.zeros(SHAPE)
            for s in range(steps):
                kv.push("w", mx.nd.NDArray(_grad(rank, s)))
                kv.pull("w", out=out)
            kv.barrier()
            if rank == 0:
                marks["shm"] = prof.shm_bytes_total()
                marks["ici_payload"] = prof.ici_payload_bytes_total()
                marks["syscalls"] = prof.send_syscalls_total()
            kv.barrier()
            kv.pull("w", out=out)
            results[rank] = out.asnumpy().copy()
        except BaseException as exc:  # noqa: BLE001 — surface in main
            errors.append((rank, exc))

    try:
        kvs = [KVStoreDistAsync(rank=0)]   # leader binds the mesh first
        kvs += [KVStoreDistAsync(rank=r) for r in range(1, n_ranks)]
        threads = [_Thread(target=worker, args=(r, kv))
                   for r, kv in enumerate(kvs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
        assert not errors, errors
        assert all(not t.is_alive() for t in threads), "worker hung"
        for kv in kvs[1:]:
            kv.close()
        kvs[0].close(stop_servers=True)
        return (results, marks["shm"], marks["ici_payload"],
                marks["syscalls"])
    finally:
        srv.stop()


def _golden(n_ranks, steps=3):
    want = np.arange(np.prod(SHAPE), dtype=np.float32).reshape(SHAPE)
    for r in range(n_ranks):
        for s in range(steps):
            want = want - np.float32(LR) * _grad(r, s)
    return want


def test_mesh_shm_four_followers_bit_identical(monkeypatch):
    """THE tentpole gate, in-process: 5 workers per host (1 leader + 4
    followers), shm lane on.  Concurrent follower deposits through the
    acceptor pool land bit-identical to the analytic sequential
    result; follower payload bytes ride the shm_ family; the sockets
    carry (close to) control traffic only."""
    results, shm, ici_payload, _ = _run_group(monkeypatch, n_ranks=5)
    want = _golden(5)
    for r in range(5):
        np.testing.assert_array_equal(results[r], want)
    assert shm > 0, "no bytes rode the shm lane"
    # steady-state: every mesh frame (pushes, collects, flush tokens)
    # is in the ring — socket ici payload over the rounds is at most
    # handshake residue, far below one gradient (6*8*4 = 192B each)
    assert ici_payload < shm / 4, (ici_payload, shm)


def test_mesh_shm_wedge_falls_back_bit_identical(monkeypatch):
    """MXNET_FI_SHM_WEDGE_AFTER: the leader stops draining the ring
    mid-run; the follower's stall watchdog must mark the lane dead and
    fail over to TCP — replaying its window, exactly-once — with zero
    failed steps and the same bits as a clean run."""
    monkeypatch.setenv("MXNET_KVSTORE_SHM_STALL_S", "0.5")
    faultinject.reset()
    try:
        with faultinject.shm_wedge_after_frames(3):
            results, _, _, _ = _run_group(monkeypatch, n_ranks=3)
            st = faultinject.stats()
        want = _golden(3)
        for r in range(3):
            np.testing.assert_array_equal(results[r], want)
        assert st["shm_frames_wedged"] > 0, st
        assert prof.channel_counts().get("kvstore.shm_fallback", 0) >= 1
    finally:
        faultinject.reset()


def test_mesh_fanin_timeout_names_missing_ranks(monkeypatch):
    """A fan-in timeout must say WHICH followers never deposited and
    how stale they are — 'incomplete (1 of 2)' alone is undebuggable
    at 3am (satellite: named barrier errors + flight-recorder note)."""
    _health = PKG.health
    _MeshLeader = PKG.kvstore._MeshLeader
    _ServerConn = PKG.kvstore._ServerConn
    _await = PKG.kvstore._await
    monkeypatch.setenv("MXNET_KVSTORE_MESH_FANIN_S", "0.4")
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "0")
    leader = _MeshLeader("127.0.0.1:0", n_followers=2,
                         follower_ranks=[1, 2])
    port = leader._listener.getsockname()[1]
    conn = _ServerConn(f"127.0.0.1:{port}", window=1, rank=1,
                       byte_kinds=("ici_sent", "ici_recv"))
    try:
        _await(conn.request(
            ("mesh_push", 0, [("w", np.ones(2, np.float32))])))
        with pytest.raises(MXNetError) as ei:
            leader.collect_push(0)
        msg = str(ei.value)
        assert "rank 2" in msg and "never heard from" in msg, msg
        assert "rank 1" not in msg.split("missing")[1], msg
        notes = [e for e in _health.events()
                 if e.get("kind") == "mesh.fanin_timeout"]
        assert notes and notes[-1]["missing"] == [2], notes
    finally:
        conn.close()
        leader.close()


# ---------------------------------------------------------------------------
# _PullHandle replan: roster bump mid-pull
# ---------------------------------------------------------------------------
def _elastic_pair(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "2")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "10")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "50")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "0.5")
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "16")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    srv0 = KVStoreServer(server_id=0, num_workers=1, elastic=True)
    srv1 = KVStoreServer(server_id=1, num_workers=1, elastic=True)
    uris = f"127.0.0.1:{srv0.port},127.0.0.1:{srv1.port}"
    monkeypatch.setenv("MXT_SERVER_URIS", uris)
    srv0._roster_servers = uris.split(",")
    srv1._roster_servers = uris.split(",")
    srv0.start_background()
    srv1.start_background()
    return srv0, srv1


def _small_key_on_server0():
    """A key the survivor (roster slot 0) owns under BOTH layouts."""
    i = 0
    while True:
        k = f"sm{i}"
        if membership.server_index(k, 2) == 0 \
                and membership.server_index(k, 1) == 0:
            return k
        i += 1


def _setup_striped(kv, big0, small):
    kv.init("big", mx.nd.NDArray(big0))
    kv.init(small, mx.nd.ones((2, 2)))
    kv.set_optimizer(mx.optimizer.SGD(
        learning_rate=0.125, momentum=0.0, wd=0.0, rescale_grad=1.0))
    kv.push("big", mx.nd.ones((10, 4)))
    kv.push(small, mx.nd.ones((2, 2)))
    out_b, out_s = mx.nd.zeros((10, 4)), mx.nd.zeros((2, 2))
    kv.pull("big", out=out_b)   # sync point: cache = server state
    kv.pull(small, out=out_s)


def test_pull_handle_replans_roster_bump_mid_pull(monkeypatch):
    """THE replan acceptance, deterministic and in-process: a striped
    pull in flight when its server dies must repair + re-route the
    unserved tail from inside wait() and resolve bit-identical to the
    uninterrupted run — with the untouched key served WITHOUT a replan
    (kvstore.pull_replan counts replanned KEYS, so it pins the
    unserved-tail granularity)."""
    big0 = np.arange(40, dtype=np.float32).reshape(10, 4)
    small = _small_key_on_server0()

    def run(kill):
        srv0, srv1 = _elastic_pair(monkeypatch)
        try:
            kv = mx.kv.create("dist_async")
            assert kv._stripe_plan("big", (10, 4)) is not None
            _setup_striped(kv, big0, small)
            prof.reset_channel_counts()
            if kill:
                # stretch every ack so the round is genuinely IN FLIGHT
                # when the server dies (both stripes unserved)
                with faultinject.delay_acks(0.25):
                    handle = kv.pull_async(["big", small],
                                           [(10, 4), (2, 2)])
                    time.sleep(0.05)
                    srv1.stop()          # takes its stripe to the grave
                    vals = handle.wait()
            else:
                handle = kv.pull_async(["big", small],
                                       [(10, 4), (2, 2)])
                vals = handle.wait()
            counts = dict(prof.channel_counts())
            gen = kv._roster_gen
            nconns = len(kv._conns)
            kv.close(stop_servers=True)
            return vals, counts, gen, nconns
        finally:
            srv0.stop()
            srv1.stop()

    clean, _, gen0, _ = run(kill=False)
    vals, counts, gen, nconns = run(kill=True)
    assert gen0 == 0 and gen >= 1 and nconns == 1
    # one key replanned (big — its layout moved), one served untouched
    assert counts.get("kvstore.pull_replan") == 1, counts
    for k in ("big", small):
        np.testing.assert_array_equal(
            vals[k], clean[k],
            err_msg=f"replanned pull of {k!r} diverged from the "
                    "uninterrupted run")
