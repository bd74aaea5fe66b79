"""Cross-package gates of the distributed plane: a port worker against an
in-process JAX ``KVStoreServer``, and a JAX worker against a port
server, under the default codec.  Each runs one script of ``init``,
``push`` (raw, 2-bit and fp16 payloads), a list push that coalesces into
``push_multi``, ``pull``, ``row_sparse_pull`` (``pull_rowsparse``),
``barrier`` and ``stats``.  The server's state after the script equals
the same script's within one package, bit for bit, and every frame the
worker sends is the other package's worker's frame for the same
message, byte for byte (the channel's nonce is pinned, heartbeats are
off, so the two runs send the same messages).  Each package's server
unpickles only its own optimizer classes, so the script installs no
optimizer (a push without an updater assigns); that divergence is kept
(ROADMAP §3)."""
import uuid

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from torch_dist import PKGS, nd, pulled, zeros
import mxnet_tpu as _jpkg
import mxnet_tpu_torch as _tpkg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (4, 6)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Each case leaves both packages' flight recorders clean and no fault
    plan armed (a lane's fallback notes channel trouble, which a later
    test file in the same worker would read as a CRITICAL verdict)."""
    yield
    for p in (_jpkg, _tpkg):
        p.health.reset()
        p.faultinject.reset()


def _script(pkg):
    """The worker's side; returns what it read back."""
    kv = pkg.kv.create('dist_async')
    rng = np.random.RandomState(3)
    got = []
    kv.init('raw', nd(pkg, rng.randn(*SHAPE)))
    kv.init(['s0', 's1', 's2'], [nd(pkg, np.full((2,), i)) for i in range(3)])
    kv.init('q', zeros(pkg, SHAPE))
    kv.init('h', zeros(pkg, SHAPE))
    kv.init('emb', nd(pkg, np.arange(40).reshape(10, 4)))
    kv.push('raw', nd(pkg, rng.randn(*SHAPE)))
    kv.push(['s0', 's1', 's2'], [nd(pkg, np.full((2,), 10 + i))
                                 for i in range(3)])
    kv.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
    for _ in range(2):
        kv.push('q', nd(pkg, rng.randn(*SHAPE) * 0.6))
    kv.set_gradient_compression({'type': 'fp16'})
    kv.push('h', nd(pkg, rng.randn(*SHAPE)))
    kv.set_gradient_compression({'type': 'none'})
    for k in ('raw', 'q', 'h'):
        got.append(pulled(pkg, kv, k, SHAPE))
    for k in ('s0', 's1', 's2'):
        got.append(pulled(pkg, kv, k, (2,)))
    rsp = pkg.nd.sparse.zeros('row_sparse', (10, 4))
    kv.row_sparse_pull('emb', out=rsp, row_ids=nd(pkg, [7, 2, 2], np.int64))
    got += [rsp.indices.asnumpy().astype(np.int64), rsp.data.asnumpy()]
    kv.barrier()
    stats = kv.server_stats(0)
    assert "channel_bytes" in stats and stats["server"]["server_id"] == 0
    kv.close(stop_servers=True)
    return got


def _run(worker, server, monkeypatch):
    """The script with a ``worker``-package store against a
    ``server``-package server; (read-back values, server store, the
    worker's frames)."""
    wpkg, spkg = PKGS[worker], PKGS[server]
    frames = []
    orig = wpkg.kvstore_server._send_msg
    wire = wpkg.kvstore_server

    def recording(sock, obj, fi_role=None, byte_kind="sent"):
        if fi_role == "client":
            parts = wire._frame_parts(obj, wpkg.wirecodec.sock_binary(sock))
            frames.append(b"".join(bytes(p) for p in parts[0]))
        return orig(sock, obj, fi_role=fi_role, byte_kind=byte_kind)
    monkeypatch.setattr(wire, "_send_msg", recording)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=7))
    srv = spkg.kvstore_server.KVStoreServer(server_id=0, num_workers=1)
    srv.start_background()
    for k, v in (("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}"),
                 ("DMLC_NUM_WORKER", "1"), ("DMLC_WORKER_ID", "0"),
                 ("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0")):
        monkeypatch.setenv(k, v)
    try:
        if wpkg is mt:
            with mt.cpu():
                got = _script(wpkg)
        else:
            got = _script(wpkg)
        store = {k: np.asarray(v.asnumpy()) for k, v in srv._store.items()}
    finally:
        srv.stop()
        monkeypatch.undo()
    return got, store, frames


def _assert_equal_runs(a, b):
    got_a, store_a, frames_a = a
    got_b, store_b, frames_b = b
    for x, y in zip(got_a, got_b):
        np.testing.assert_array_equal(x, y)
    assert set(store_a) == set(store_b)
    for k in store_a:
        assert store_a[k].dtype == store_b[k].dtype
        np.testing.assert_array_equal(store_a[k], store_b[k])
    assert len(frames_a) == len(frames_b)
    for i, (fa, fb) in enumerate(zip(frames_a, frames_b)):
        assert fa == fb, f"frame {i} differs"


@pytest.mark.parametrize("server", ["jax", "port"])
def test_cross_package_worker_equals_same_package_run(monkeypatch, server):
    """With a ``server`` server, the other package's worker leaves the
    same server state, reads back the same values and sends the same
    bytes as the server's own package's worker."""
    other = "port" if server == "jax" else "jax"
    same = _run(server, server, monkeypatch)
    cross = _run(other, server, monkeypatch)
    _assert_equal_runs(same, cross)
    got, store, frames = cross
    assert any(f[0] == 0xB1 for f in frames)          # binary frames rode
    assert set(store) >= {'raw', 'q', 'h', 's0', 'emb'}
    assert (got[3] == 10).all() and (got[5] == 12).all()
    np.testing.assert_array_equal(got[6], [2, 7])


def test_pickle_allowlists_admit_each_others_wire_classes():
    """The skeleton of a pickled frame names the marker classes by the
    JAX package's names: each package's decoder resolves them to its own
    classes, and refuses the other package's optimizer classes."""
    import pickle
    from mxnet_tpu.kvstore_server import _restricted_loads as jload
    from mxnet_tpu_torch.kvstore_server import (_frame_parts,
                                                _restricted_loads as tload)
    msg = ("req", (0, "n"), 1, ("init", "w", np.zeros(3, np.float32)))
    parts = _frame_parts(msg, False)[0]
    skel = bytes(parts[1])
    assert type(jload(skel)[3][2]).__module__ == "mxnet_tpu.kvstore_server"
    assert type(tload(skel)[3][2]).__module__ == \
        "mxnet_tpu_torch.kvstore_server"
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        jload(pickle.dumps(mt.optimizer.SGD()))
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tload(pickle.dumps(mx.optimizer.SGD()))


# -- the hierarchical tier across the packages ------------------------------
HIER_SHAPE = (5, 7)
HIER_STEPS = 4


def _hier_rank(pkg, kv, rank, results):
    """One rank of a host group: two raw rounds, then two 2-bit rounds
    (the leader compresses the group's sum; a follower compresses
    nothing), each a push of the rank's seeded gradient and a pull; no
    optimizer, so the server takes each round's push as the value."""
    rng = np.random.RandomState(20 + rank)
    kv.init('w', zeros(pkg, HIER_SHAPE))
    kv.barrier()
    got = []
    out = zeros(pkg, HIER_SHAPE)
    for s in range(HIER_STEPS):
        if s == 2:
            kv.set_gradient_compression({'type': '2bit', 'threshold': 0.5})
        kv.push('w', nd(pkg, rng.randn(*HIER_SHAPE)))
        kv.pull('w', out=out)
        got.append(out.asnumpy().copy())
    kv.barrier()
    results[rank] = got


def _hier_group(leader, follower, shm, monkeypatch, wedge=False):
    """A host group of two ranks, the leader (rank 0) of package
    ``leader`` and the follower (rank 1) of ``follower``, against one
    JAX server; (each rank's pulled values, the server's value, the
    request frames each rank sent by op, the follower's lane and
    fallback counts).  Nonces are pinned and heartbeats off, so two runs
    send the same messages."""
    import socket
    import threading
    lpkg, fpkg = PKGS[leader], PKGS[follower]
    frames = {0: [], 1: []}
    for pkg in (mx, mt):
        wire = pkg.kvstore_server
        orig = wire._frame_parts

        def recording(obj, binary_ok, orig=orig):
            out = orig(obj, binary_ok)
            if isinstance(obj, tuple) and obj and obj[0] == "req":
                data = b"".join(bytes(memoryview(p).cast("B"))
                                for p in out[0])
                frames[int(obj[1][0])].append(
                    (obj[3][0], None if obj[3][0] == "shm_hello" else data))
            return out
        monkeypatch.setattr(wire, "_frame_parts", recording)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=7))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    mesh_port = s.getsockname()[1]
    s.close()
    srv = mx.kvstore_server.KVStoreServer(server_id=0, num_workers=2)
    srv.start_background()
    for k, v in (("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}"),
                 ("DMLC_NUM_WORKER", "2"), ("DMLC_WORKER_ID", "0"),
                 ("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0"),
                 ("MXNET_KVSTORE_HIERARCHY", "1"),
                 ("MXNET_KVSTORE_WORKERS_PER_HOST", "2"),
                 ("MXNET_KVSTORE_SHM", "1" if shm else "0"),
                 ("MXNET_KVSTORE_SHM_STALL_S", "0.5"),
                 ("MXT_MESH_URIS", f"127.0.0.1:{mesh_port}")):
        monkeypatch.setenv(k, v)
    results, errors = {}, []
    fi = lpkg.faultinject
    fi.reset()
    for p in (mx, mt):
        p.profiler.reset_channel_counts()
    try:
        with mt.cpu():
            kv0 = lpkg.kvstore.KVStoreDistAsync(rank=0)
            kv1 = fpkg.kvstore.KVStoreDistAsync(rank=1)
        lane = kv1._mesh_conn._shm is not None

        def work(pkg, kv, rank):
            try:
                if pkg is mt:
                    with mt.cpu():
                        _hier_rank(pkg, kv, rank, results)
                else:
                    _hier_rank(pkg, kv, rank, results)
            except BaseException as exc:  # noqa: BLE001 — to the test
                errors.append((rank, exc))
        ts = [threading.Thread(target=work, args=a)
              for a in ((lpkg, kv0, 0), (fpkg, kv1, 1))]
        if wedge:
            ctx = fi.shm_wedge_after_frames(3)
        else:
            import contextlib
            ctx = contextlib.nullcontext()
        with ctx:
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
            wedged = fi.stats()["shm_frames_wedged"]
        assert not errors, errors
        assert not any(t.is_alive() for t in ts), "a rank hung"
        fallback = fpkg.profiler.channel_counts().get(
            "kvstore.shm_fallback", 0)
        kv1.close()
        kv0.close()
        stored = np.asarray(srv._store['w'].asnumpy())
    finally:
        fi.reset()
        srv.stop()
        monkeypatch.undo()
    return results, stored, frames, dict(lane=lane, wedged=wedged,
                                         fallback=fallback)


def _assert_same_group_runs(a, b):
    res_a, st_a, fr_a, _ = a
    res_b, st_b, fr_b, _ = b
    for r in (0, 1):
        for x, y in zip(res_a[r], res_b[r]):
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    np.testing.assert_array_equal(st_a.view(np.int32), st_b.view(np.int32))
    for r in (0, 1):
        assert [op for op, _ in fr_a[r]] == [op for op, _ in fr_b[r]], r
        for i, ((op, fa), (_, fb)) in enumerate(zip(fr_a[r], fr_b[r])):
            assert fa == fb, f"rank {r} frame {i} ({op}) differs"


@pytest.mark.parametrize("shm", [False, True], ids=["tcp", "lane"])
@pytest.mark.parametrize("leader,follower", [("jax", "port"),
                                             ("port", "jax"),
                                             ("port", "port")])
def test_mixed_host_group_equals_all_jax_group(monkeypatch, leader,
                                               follower, shm):
    """A host group whose leader and follower are of different packages
    (and an all-port group) reads back the same values bit for bit,
    leaves the same server value and sends the same request frames,
    byte for byte (the lane's ``shm_hello`` names a random segment and
    is compared by op only), as an all-JAX group; over the lane the
    follower's frames rode the ring."""
    ref = _hier_group("jax", "jax", shm, monkeypatch)
    got = _hier_group(leader, follower, shm, monkeypatch)
    _assert_same_group_runs(ref, got)
    assert got[3]["lane"] is shm and ref[3]["lane"] is shm
    ops = [op for op, _ in got[2][1]]
    assert ops.count("mesh_push") == HIER_STEPS
    assert ops.count("mesh_collect") == HIER_STEPS
    assert ("shm_hello" in ops) is shm
    # the follower's gradient reached the wire only inside the sum: the
    # leader's pushes are the group's, the follower's none
    assert not any(op == "push" for op, _ in got[2][1])
    assert sum(op == "push" for op, _ in got[2][0]) == HIER_STEPS


@pytest.mark.parametrize("leader,follower", [("jax", "port"),
                                             ("port", "jax")])
def test_mixed_group_shm_wedge_falls_back_bit_identical(monkeypatch, leader,
                                                        follower):
    """The leader's drain wedges after three ring frames
    (``shm_wedge_after_frames``): the follower's stall watchdog drops the
    lane and replays over TCP, and the mixed group ends bit for bit where
    an all-JAX group ends without the wedge."""
    ref = _hier_group("jax", "jax", True, monkeypatch)
    got = _hier_group(leader, follower, True, monkeypatch, wedge=True)
    res_a, st_a, _, _ = ref
    res_b, st_b, _, meta = got
    for r in (0, 1):
        for x, y in zip(res_a[r], res_b[r]):
            np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))
    np.testing.assert_array_equal(st_a.view(np.int32), st_b.view(np.int32))
    assert meta["wedged"] > 0 and meta["fallback"] >= 1, meta
