"""Cross-package gates of the serving wire (ROADMAP T3): a port
``ServingReplica`` answers a JAX ``ServingClient``, a JAX replica answers
a port client, and a ``FleetClient`` of each package routes over a mixed
pair (one replica of each package).  The client's script is ``predict``
(the binary frame), ``predict_canary`` (pickled), ``serving_stats`` and
``drain``; every frame a client sends is the other package's client's
frame for the same message, byte for byte (the channel's nonce is
pinned and heartbeats are off, so both runs send the same messages).

Tolerance: the replies are one float32 dense layer's softmax, held
against numpy's within rtol 1e-5 / atol 1e-6 and against the other
package's replica's reply within the same (XLA and torch may order the
4-wide product's sums differently)."""
import uuid

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from torch_dist import PKGS
from torch_fleet_job import FEAT, model
import torch_threads  # noqa: F401  a worker's share of the cores

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Every test starts with both packages' flight recorders clean and
    no fault plan armed: a replica's self-reported verdict is its
    process's roll-up, so channel poison left by an earlier test in the
    same worker would read CRITICAL here."""
    for pkg in PKGS.values():
        pkg.health.reset()
        pkg.faultinject.reset()
    yield
    for pkg in PKGS.values():
        pkg.faultinject.reset()


def _replica(pkg, **kw):
    sym, params, _w, _b = model(pkg)
    if pkg is mt:
        kw["ctx"] = mt.cpu()
    rep = pkg.serving.ServingReplica(sym, {'data': (FEAT,)}, params,
                                     buckets=[1, 2, 4], max_wait_s=0.0,
                                     warmup=False, **kw)
    rep.start_background()
    return rep


def _reference(x):
    _sym, _params, w, b = model(mt)
    logits = x @ w.T + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _client_script(client, cpkg, x):
    """What the client reads back from one replica."""
    outs = [client.predict(x)[0],
            client.predict_async(x[:1], canary=True).get()[0]]
    st = client.stats()
    assert st["buckets"] == [1, 2, 4] and st["version"] == 0
    assert st["health"]["status"] in ("OK", "DEGRADED", "CRITICAL")
    assert client.drain(True) == {"draining": True}
    assert client.stats()["draining"] is True
    assert client.drain(False) == {"draining": False}
    with pytest.raises(cpkg.base.MXNetError, match="feature shape"):
        client.predict(np.zeros((1, FEAT + 1), np.float32))
    return outs


def _run(client_pkg, replica_pkg, monkeypatch):
    """The script from a ``client_pkg`` client against a
    ``replica_pkg`` replica: (replies, the client's frames)."""
    cpkg, rpkg = PKGS[client_pkg], PKGS[replica_pkg]
    frames = []
    wire = cpkg.kvstore_server
    orig = wire._send_msg

    def recording(sock, obj, fi_role=None, byte_kind="sent"):
        if fi_role == "client":
            parts = wire._frame_parts(obj, cpkg.wirecodec.sock_binary(sock))
            frames.append(b"".join(bytes(p) for p in parts[0]))
        return orig(sock, obj, fi_role=fi_role, byte_kind=byte_kind)
    monkeypatch.setattr(wire, "_send_msg", recording)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=11))
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0")
    rep = _replica(rpkg)
    client = cpkg.serving.ServingClient(f"127.0.0.1:{rep.port}", window=4)
    try:
        x = np.random.RandomState(5).randn(3, FEAT).astype(np.float32)
        outs = _client_script(client, cpkg, x)
        for o, want in zip(outs, (_reference(x), _reference(x[:1]))):
            np.testing.assert_allclose(o, want, **TOL)
    finally:
        client.close()
        rep.stop()
        monkeypatch.undo()
    return outs, frames


@pytest.mark.parametrize("replica", ["jax", "port"])
def test_cross_package_client_equals_same_package_run(monkeypatch,
                                                      replica):
    """Against a ``replica`` replica, the other package's client reads
    back what the replica's own package's client reads, and sends the
    same bytes."""
    other = "port" if replica == "jax" else "jax"
    same_outs, same_frames = _run(replica, replica, monkeypatch)
    cross_outs, cross_frames = _run(other, replica, monkeypatch)
    for a, b in zip(same_outs, cross_outs):
        np.testing.assert_array_equal(a, b)
    assert len(same_frames) == len(cross_frames) > 0
    for i, (fa, fb) in enumerate(zip(same_frames, cross_frames)):
        assert fa == fb, f"frame {i} differs"
    assert any(f[0] == 0xB1 for f in cross_frames)   # binary predict rode
    assert any(f[0] != 0xB1 for f in cross_frames)   # and pickled ops


def test_replies_of_the_two_packages_agree():
    """The same request to a replica of each package: equal replies
    within float32 summation order."""
    x = np.random.RandomState(9).randn(4, FEAT).astype(np.float32)
    got = {}
    for name, pkg in PKGS.items():
        rep = _replica(pkg)
        cli = mt.serving.ServingClient(f"127.0.0.1:{rep.port}", window=4)
        try:
            got[name] = cli.predict(x)[0]
        finally:
            cli.close()
            rep.stop()
    np.testing.assert_allclose(got["port"], got["jax"], **TOL)


@pytest.mark.parametrize("fleet", ["jax", "port"])
def test_fleet_of_either_package_routes_over_a_mixed_pair(fleet):
    """A ``fleet`` FleetClient over one replica of each package: both
    report OK, both take traffic, every reply is right, and a drain of
    either replica moves all traffic to the other."""
    fpkg = PKGS[fleet]
    fpkg.profiler.reset_channel_counts()
    reps = {name: _replica(pkg) for name, pkg in PKGS.items()}
    uris = {name: f"127.0.0.1:{r.port}" for name, r in reps.items()}
    fl = fpkg.serving.FleetClient(list(uris.values()), stats_interval=0,
                                  connect_timeout=10.0)
    try:
        assert set(fl.poll_once().values()) == {"OK"}
        x = np.random.RandomState(4).randn(2, FEAT).astype(np.float32)
        want = _reference(x)
        for _ in range(8):
            np.testing.assert_allclose(fl.predict({'data': x})[0], want,
                                       **TOL)
        routed = fpkg.profiler.fleet_route_counts()
        assert set(routed) == set(uris.values())
        assert all(v > 0 for v in routed.values())
        for name, uri in uris.items():
            fl.drain(uri)
            before = fpkg.profiler.fleet_route_counts()
            for _ in range(4):
                np.testing.assert_allclose(fl.predict({'data': x})[0],
                                           want, **TOL)
            after = fpkg.profiler.fleet_route_counts()
            assert after.get(uri, 0) == before.get(uri, 0), name
            fl.undrain(uri)
            fl.poll_once()
    finally:
        fl.close()
        for r in reps.values():
            r.stop()
