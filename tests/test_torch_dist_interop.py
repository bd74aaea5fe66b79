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
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (4, 6)


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
