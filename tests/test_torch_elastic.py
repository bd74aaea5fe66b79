"""Elastic membership in both packages: the server and integration
cases of ``tests/test_membership.py:261-1156`` as the JAX package's suite
writes them, each run once against the JAX package and once against the
port (on the CPU): the coordinator's idempotent mutations, stale
envelopes, the ledger report, the join reply's barrier floor, rejoin
realignment, dead reports, barrier renegotiation, the process-kill plans
at exact counts, a server's death recovered exactly, momentum handed off
through the snapshot and the peer bank, repair with compression
residuals, a worker joining and leaving, a graceful server leave,
coordinator death and a double death, beat-loop self-promotion, and the
serving replica's refresh across a roster bump.

Every final weight is held EXACTLY (``assert_array_equal``) against its
analytic golden: integer and power-of-two values whose float32
arithmetic is order-independent, so each package's result equals the
golden and so the other package's bit for bit.  The port's stores and
servers run on the host."""
import os
import threading
import time

import numpy as np
import pytest

from torch_both import both_packages
import torch_threads  # noqa: F401  a worker's share of the cores

SHAPE = (3, 4)


def _bind(p):
    return dict(mx=p, faultinject=p.faultinject,
                membership=p.membership, profiler=p.profiler,
                MXNetError=p.base.MXNetError,
                KVStoreServer=p.kvstore_server.KVStoreServer)


pkg = both_packages(globals(), _bind)


@pytest.fixture(autouse=True)
def _counters(pkg):
    """Each case reads the profiler's counters from zero."""
    pkg.profiler.reset_channel_counts()
    yield


def test_coordinator_idempotent_mutations():
    m = membership.MembershipCoordinator(["a:1", "b:2"], [0, 1])
    assert m.generation == 0
    g1 = m.report_dead_server("b:2")
    assert g1 == 1 and m.evictions == 1
    # duplicate reports (every worker races to report) do NOT re-bump
    assert m.report_dead_server("b:2") == 1 and m.evictions == 1
    assert m.roster().servers == ("a:1",)
    # the LAST server (the coordinator itself) can never be removed
    with pytest.raises(RuntimeError, match="last server"):
        m.report_dead_server("a:1")
    # joins bump once, re-joins don't
    assert m.join_server("c:3") == 2
    assert m.join_server("c:3") == 2
    assert m.roster().servers == ("a:1", "c:3")   # order preserved
    assert m.join_worker(2) == 3
    assert m.join_worker(2) == 3
    assert m.evict_worker(1) == 4
    assert m.evict_worker(1) == 4 and m.evictions == 2
    assert m.roster().workers == (0, 2)


def test_coordinator_snapshots_outlive_eviction():
    m = membership.MembershipCoordinator(["a:1", "b:2"], [0])
    m.note_server_beat("b:2", seq=1, snapshot={"store": {"k": 1}})
    m.note_server_beat("b:2", seq=3, snapshot={"store": {"k": 3}})
    m.note_server_beat("b:2", seq=2, snapshot={"store": {"k": 2}})  # stale
    m.report_dead_server("b:2")
    snap = m.snapshot_of("b:2")
    assert snap == {"store": {"k": 3}}   # newest seq wins, survives death
    assert m.snapshot_of("nope:0") is None


def test_coordinator_silent_server_detection():
    m = membership.MembershipCoordinator(["a:1", "b:2", "c:3"], [0])
    # never heard from = never declared dead (may still be starting)
    assert m.silent_servers(0.01) == []
    m.note_server_beat("b:2")
    time.sleep(0.05)
    assert m.silent_servers(0.01) == ["b:2"]
    assert m.silent_servers(0) == []     # timeout 0 disables


# ---------------------------------------------------------------------------
# server-side handoff + barrier machinery, driven with NO sockets
# ---------------------------------------------------------------------------
def _mk_server(**kw):
    kw.setdefault("num_workers", 1)
    srv = KVStoreServer(server_id=0, **kw)
    srv._listener.close()    # never serving: pure _handle driving
    return srv


def test_handoff_idempotent_under_duplicate_delivery():
    """Quorum re-push: every worker sends the same handoff; the FIRST
    per (wire key, generation) applies, duplicates ack as no-ops, a
    stale generation never regresses the key, a newer one re-applies."""
    srv = _mk_server(elastic=True)
    v1 = np.full(SHAPE, 7.0, np.float32)
    assert srv._handle(("handoff", 3, "w", v1, "w")) is True
    assert srv._handle(("handoff", 3, "w",
                        np.full(SHAPE, 9.0, np.float32), "w")) is False
    np.testing.assert_array_equal(srv._store["w"].asnumpy(), 7.0)
    # stale generation: ignored
    assert srv._handle(("handoff", 2, "w",
                        np.full(SHAPE, 1.0, np.float32), "w")) is False
    np.testing.assert_array_equal(srv._store["w"].asnumpy(), 7.0)
    # newer generation: re-applies
    assert srv._handle(("handoff", 4, "w",
                        np.full(SHAPE, 2.0, np.float32), "w")) is True
    np.testing.assert_array_equal(srv._store["w"].asnumpy(), 2.0)


def test_handoff_purges_stale_wire_forms():
    """The first handoff of a logical key in a generation deletes the
    key's OLD wire forms (stripe keys from the previous layout) and
    their optimizer state, so a re-striped layout leaves no orphans."""
    opt = mx.optimizer
    srv = _mk_server(elastic=True)
    srv._updater = opt.get_updater(opt.SGD(learning_rate=0.5,
                                           momentum=0.9))
    srv._handle(("init", "w@s1", np.zeros((5, 4), np.float32)))
    srv._handle(("push", "w@s1", np.ones((5, 4), np.float32)))
    assert "w@s1" in srv._store and srv._updater.states
    srv._handle(("handoff", 1, "w",
                 np.zeros((10, 4), np.float32), "w"))
    assert "w@s1" not in srv._store and "w" in srv._store
    assert "w@s1" not in srv._updater.states
    # an in-flight OLD-layout push arriving post-purge fails loudly (the
    # pusher's own repair re-applies it from its push log)
    with pytest.raises(Exception, match="uninitialized"):
        srv._apply_push("w@s1", np.ones((5, 4), np.float32))


def test_handoff_state_idempotent_and_installed():
    opt = mx.optimizer
    srv = _mk_server(elastic=True)
    srv._updater = opt.get_updater(opt.SGD(learning_rate=0.5,
                                           momentum=0.9))
    mom = np.full((10, 4), 0.25, np.float32)
    assert srv._handle(("handoff_state", 1, "w", (mom,), "w")) is True
    assert srv._handle(("handoff_state", 1, "w", (mom * 9,), "w")) is False
    st = srv._updater.states["w"]
    np.testing.assert_array_equal(np.asarray(st[0].asnumpy()), mom)
    # None clears the slot (the optimizer re-creates fresh state)
    assert srv._handle(("handoff_state", 2, "w", None, "w")) is True
    assert "w" not in srv._updater.states


def test_stale_coordinator_envelopes_rejected():
    """After a failover the successor's ledger resumes at
    max(reported)+1, so envelopes stamped by the dead coordinator's
    epoch — handoffs a worker still converged on the stale roster keeps
    re-sending — are refused by the EXISTING per-generation staleness
    checks; no new wire validation was needed.  Socket-free."""
    srv = _mk_server(elastic=True)
    srv._membership = membership.rebuild_ledger(
        [srv.uri], [0], [{"uri": "dead:1", "generation": 4,
                          "beat_seq": 9, "keys": ["w"]}], None)
    srv._promoted = True
    gen = srv._membership.generation
    assert gen == 5
    # the post-failover roster (and generation) is what roster ops serve
    assert srv._handle(("roster_get",)) == (5, [srv.uri], [0])
    # barrier replies carry the resumed generation, so workers discover
    # the succession at their next sync point for free
    assert srv._handle(("barrier",), rank=0) == 5
    # a post-failover handoff at the rebuilt generation lands...
    v_new = np.full(SHAPE, 7.0, np.float32)
    assert srv._handle(("handoff", gen, "w", v_new, "w")) is True
    # ...and every stale-epoch envelope is rejected, values untouched
    for stale in (gen - 1, gen - 3):
        assert srv._handle(("handoff", stale, "w",
                            np.zeros(SHAPE, np.float32), "w")) is False
    np.testing.assert_array_equal(srv._store["w"].asnumpy(), 7.0)
    srv._stop.set()


def test_ledger_report_names_generation_and_keys():
    """Every elastic server answers ledger_report — the rebuild sweep's
    input: last-known generation, beat seq and the live key set."""
    srv = _mk_server(elastic=True)
    srv._handle(("init", "w", np.zeros(SHAPE, np.float32)))
    srv._known_gen = 3
    srv._beat_seq = 11
    r = srv._handle(("ledger_report",))
    assert r["uri"] == srv.uri and r["keys"] == ["w"]
    assert r["beat_seq"] == 11 and r["generation"] == 3
    # a coordinator reports its LEDGER generation, not the passive view
    srv._get_membership().join_server("x:9")
    assert srv._handle(("ledger_report",))["generation"] \
        == srv._get_membership().generation
    srv._stop.set()


def test_join_reply_carries_cohort_barrier_floor():
    """A joining worker's reply carries the cohort's barrier release
    floor (computed over ARRIVED ranks only, so two simultaneous
    joiners both align to the real cohort, not to each other's zero):
    the joiner seeds its raw sequence there, keeping client sequences
    globally aligned — the invariant that lets a failover successor
    pair arrivals with EMPTY barrier state."""
    srv = _mk_server(num_workers=1, elastic=True)
    assert srv._handle(("barrier", 1), rank=0) == 0   # cohort runs...
    assert srv._handle(("barrier", 2), rank=0) == 0
    reply = srv._handle(("roster_join", "worker", 1))
    assert len(reply) == 4 and reply[3] == 2          # floor = done(0)
    # a second concurrent joiner sees the SAME floor (rank 1 has not
    # arrived yet and must not drag it to zero)
    assert srv._handle(("roster_join", "worker", 2))[3] == 2
    # the seeded joiner's first arrival (floor+1) parks until the
    # cohort reaches the same rendezvous
    done = []

    def joiner():
        try:
            done.append(srv._handle(("barrier", 3), rank=1))
        except Exception as exc:  # noqa: BLE001 — surfaced via assert
            done.append(exc)

    t = threading.Thread(target=joiner, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not done
    srv._handle(("roster_leave", "worker", 2))        # 2 never arrives
    srv._handle(("barrier", 3), rank=0)
    t.join(timeout=5)
    assert not t.is_alive() and isinstance(done[0], int)
    srv._stop.set()


def test_rejoin_realignment_is_one_shot_client_adopted():
    """A (re-)joined rank arriving with a drifted sequence is realigned
    to the cohort's pending rendezvous ONE-SHOT: the offset rides the
    barrier reply so the client adopts the effective sequence — there
    is deliberately NO server-side offset state, which is why a
    failover successor can start with an empty barrier map and still
    pair every arrival."""
    srv = _mk_server(num_workers=1, elastic=True)
    assert srv._handle(("barrier", 1), rank=0) == 0
    assert srv._handle(("barrier", 2), rank=0) == 0
    srv._handle(("roster_join", "worker", 1))
    done = []

    def drifted():
        try:
            done.append(srv._handle(("barrier", 1), rank=1))
        except Exception as exc:  # noqa: BLE001 — surfaced via assert
            done.append(exc)

    t = threading.Thread(target=drifted, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not done                  # realigned to rendezvous 3: parks
    srv._handle(("barrier", 3), rank=0)
    t.join(timeout=5)
    assert not t.is_alive()
    payload = done[0]
    assert isinstance(payload, tuple) and payload[1] == 2, payload
    # the adopted sequence keeps pairing exactly: raw 1+2+1 = 4 next
    assert srv._barrier_high[1] == 3
    srv._stop.set()


def test_fresh_client_generation_resets_barrier_sequence():
    """A trainer RESUMED against live servers barriers under the same
    rank ids but a new client nonce and a sequence restarting at 1: the
    dead predecessors' release marks must not turn the first rendezvous
    into instant no-ops (the resumed set_optimizer barrier must really
    rendezvous)."""
    srv = _mk_server(num_workers=2, elastic=False)
    srv._note_ping(0)
    srv._note_ping(1)
    results = []

    def arrive(rank, bseq, client):
        try:
            results.append(srv._handle(("barrier", bseq), rank=rank,
                                       client=client))
        except Exception as exc:  # noqa: BLE001 — surfaced via assert
            results.append(exc)

    # first client generation completes rendezvous 1
    t0 = threading.Thread(target=arrive, args=(0, 1, (0, "A")),
                          daemon=True)
    t0.start()
    time.sleep(0.1)
    arrive(1, 1, (1, "A"))
    t0.join(timeout=5)
    assert len(results) == 2 and not any(
        isinstance(r, Exception) for r in results)
    # the job restarts: NEW nonces, sequences back at 1 — rank 0 must
    # PARK (no instant release off the stale done marks)...
    results.clear()
    t2 = threading.Thread(target=arrive, args=(0, 1, (0, "B")),
                          daemon=True)
    t2.start()
    time.sleep(0.2)
    assert not results, "fresh client released without a rendezvous"
    # ...until the other resumed rank arrives
    arrive(1, 1, (1, "B"))
    t2.join(timeout=5)
    assert len(results) == 2 and not any(
        isinstance(r, Exception) for r in results)
    srv._stop.set()


def test_dead_report_naming_live_coordinator_refused():
    """A false-positive roster_dead (the reporter's heartbeat blipped)
    that reaches the very coordinator it names is REFUSED — answering
    the report IS proof of life, and a live coordinator must never
    evict itself into a split-brain roster."""
    srv = _mk_server(elastic=True)
    m = srv._get_membership()
    m.join_server("b:2")
    with pytest.raises(Exception, match="alive"):
        srv._handle(("roster_dead", "server", srv.uri))
    assert srv.uri in m.roster().servers
    # reports naming OTHER servers keep working
    assert srv._handle(("roster_dead", "server", "b:2"))[1] == [srv.uri]
    srv._stop.set()


def test_barrier_renegotiates_with_evicted_rank(monkeypatch):
    """Elastic coordinator: a 2-worker barrier whose rank 1 was alive
    and went silent does NOT fail — rank 1 is evicted (generation
    bump), the target re-reads the live roster and rank 0 is released.
    Pure threads, no sockets."""
    srv = _mk_server(num_workers=2, elastic=True, hb_timeout=0.2)
    srv._note_ping(0)
    srv._note_ping(1)
    with srv._barrier_cv:
        srv._hb_seen[1] = time.monotonic() - 99.0   # long silent
    t0 = time.monotonic()
    gen = srv._handle(("barrier",), rank=0)
    assert time.monotonic() - t0 < 5.0
    assert gen == srv._get_membership().generation >= 1
    assert srv._get_membership().roster().workers == (0,)
    assert profiler.channel_counts().get("kvstore.worker_eviction", 0) >= 1
    # the evicted rank was merely slow: arriving at the next barrier
    # RE-ADMITS it (join, another bump) instead of corrupting the count.
    # Stretch the silence budget so phase 2 tests re-admission alone,
    # not another round of evictions racing the parked waiters.
    srv._hb_timeout = 60.0
    done = []

    def late_rank1():
        try:
            done.append(srv._handle(("barrier",), rank=1))
        except Exception as exc:  # noqa: BLE001 — surfaced via assert
            done.append(exc)

    t = threading.Thread(target=late_rank1, daemon=True)
    t.start()
    time.sleep(0.3)          # rank 1 parks: roster is {0, 1} again
    srv._note_ping(1)
    srv._handle(("barrier",), rank=0)
    t.join(timeout=5)
    assert not t.is_alive() and isinstance(done[0], int)
    assert srv._get_membership().roster().workers == (0, 1)
    srv._stop.set()


def test_static_barrier_error_names_heartbeat_age():
    """Satellite: the non-elastic barrier failure carries per-rank
    last-heartbeat AGE — evidence, not just rank ids."""
    srv = _mk_server(num_workers=2, elastic=False, hb_timeout=0.2)
    srv._note_ping(0)
    srv._note_ping(1)
    with srv._barrier_cv:
        srv._hb_seen[1] = time.monotonic() - 42.0
    with pytest.raises(RuntimeError) as ei:
        srv._handle(("barrier",), rank=0)
    msg = str(ei.value)
    assert "[1]" in msg and "arrived rank(s): [0]" in msg
    assert "rank 1: last heartbeat" in msg and "ago" in msg
    srv._stop.set()


# ---------------------------------------------------------------------------
# faultinject: the process-level kill point
# ---------------------------------------------------------------------------
def test_kill_process_after_acks_fires_at_exact_count(monkeypatch):
    """SIGKILL after exactly n enveloped replies (the trigger is
    monkeypatched so the test process survives); heartbeat pings never
    advance the count."""
    fired = []
    monkeypatch.setattr(faultinject, "_sigkill_self",
                        lambda: fired.append(True))
    faultinject.reset()
    srv = KVStoreServer(server_id=0, num_workers=1)
    srv.start_background()
    try:
        monkeypatch.setenv("MXT_SERVER_URIS", f"127.0.0.1:{srv.port}")
        monkeypatch.setenv("DMLC_NUM_WORKER", "1")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.05")
        with faultinject.kill_process_after_acks(3):
            kv = mx.kv.create("dist_async")
            kv.init("a", mx.nd.ones(SHAPE))        # ack 1
            out = mx.nd.zeros(SHAPE)
            kv.pull("a", out=out)                  # ack 2
            time.sleep(0.3)                        # heartbeats flow...
            assert not fired                       # ...and don't count
            kv.pull("a", out=out)                  # ack 3 -> kill
            deadline = time.time() + 5
            while not fired and time.time() < deadline:
                time.sleep(0.01)
            assert fired and faultinject.stats()["kills_fired"] == 1
        kv.close(stop_servers=True)
    finally:
        faultinject.reset()
        srv.stop()


def test_kill_process_env_arming(monkeypatch):
    """MXNET_FI_KILL_PROCESS_AFTER / MXNET_FI_ONLY_SERVER arm the plan
    from the environment (the launcher-spawned-process path), and the
    server-id filter keeps the plan off other shards."""
    faultinject.reset()
    try:
        faultinject.configure(kill_process_after=2, only_server=1)
        monkeypatch.setenv("DMLC_SERVER_ID", "0")
        faultinject.server_replied()
        faultinject.server_replied()
        faultinject.server_replied()
        assert faultinject.stats()["kills_fired"] == 0   # wrong server id
        monkeypatch.setattr(faultinject, "_sigkill_self", lambda: None)
        monkeypatch.setenv("DMLC_SERVER_ID", "1")
        faultinject.server_replied()
        faultinject.server_replied()
        assert faultinject.stats()["kills_fired"] == 1
    finally:
        faultinject.reset()


def test_kill_on_beat_seq_fires_at_exact_beat(monkeypatch):
    """The beat-boundary SIGKILL point: fires exactly when the armed
    beat number is reached, once (the deterministic way to kill a
    COORDINATOR, whose enveloped-ack ordering is timing-dependent)."""
    fired = []
    monkeypatch.setattr(faultinject, "_sigkill_self",
                        lambda: fired.append(True))
    faultinject.reset()
    try:
        faultinject.configure(kill_on_beat_seq=3)
        faultinject.server_beat(1)
        faultinject.server_beat(2)
        assert not fired
        faultinject.server_beat(3)
        assert fired and faultinject.stats()["kills_fired"] == 1
        faultinject.server_beat(4)          # fired once, stays disarmed
        assert len(fired) == 1
    finally:
        faultinject.reset()


def test_only_coordinator_filter_composes(monkeypatch):
    """MXNET_FI_ONLY_COORDINATOR gates the process-kill points on the
    CURRENT coordinator role — kept fresh across failovers via
    note_coordinator — composing with the ack-count and beat-seq
    points (and with MXNET_FI_ONLY_SERVER)."""
    fired = []
    monkeypatch.setattr(faultinject, "_sigkill_self",
                        lambda: fired.append(True))
    faultinject.reset()
    try:
        faultinject.configure(kill_process_after=1, only_coordinator=True)
        faultinject.note_coordinator(False)
        faultinject.server_replied()
        assert not fired          # not the coordinator: count frozen
        faultinject.note_coordinator(True)   # a failover promotes us
        faultinject.server_replied()
        assert len(fired) == 1
        # env arming covers the new knobs too
        faultinject.reset()
        monkeypatch.setenv("MXNET_FI_KILL_ON_BEAT_SEQ", "2")
        monkeypatch.setenv("MXNET_FI_ONLY_COORDINATOR", "1")
        faultinject._arm_from_env()
        faultinject.note_coordinator(False)
        faultinject.server_beat(2)
        assert len(fired) == 1    # filtered: not the coordinator
        faultinject.note_coordinator(True)
        faultinject.server_beat(3)
        assert len(fired) == 2
    finally:
        faultinject.note_coordinator(False)
        faultinject.reset()


# ---------------------------------------------------------------------------
# integration: real in-process servers, sockets, kill / join / leave
# ---------------------------------------------------------------------------
def _elastic_pair(monkeypatch, num_workers=1, snapshot_s=0.0):
    """Two elastic in-process servers sharing a roster, env wired."""
    monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "2")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "10")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "50")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "0.5")
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "16")
    monkeypatch.setenv("MXNET_KVSTORE_SNAPSHOT_S", str(snapshot_s))
    monkeypatch.setenv("DMLC_NUM_WORKER", str(num_workers))
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    srv0 = KVStoreServer(server_id=0, num_workers=num_workers,
                         elastic=True)
    srv1 = KVStoreServer(server_id=1, num_workers=num_workers,
                         elastic=True)
    uris = f"127.0.0.1:{srv0.port},127.0.0.1:{srv1.port}"
    monkeypatch.setenv("MXT_SERVER_URIS", uris)
    srv0._roster_servers = uris.split(",")
    srv1._roster_servers = uris.split(",")
    srv0._snapshot_s = snapshot_s
    srv1._snapshot_s = snapshot_s
    srv0.start_background()
    srv1.start_background()
    return srv0, srv1


def test_elastic_server_death_recovers_exact(monkeypatch):
    """The server-death flow, in-process: kill server 1 mid-job; the
    worker reports it, re-derives striping against the survivor, hands
    the state off from its pull cache and re-pushes the updates the
    dead server took with it — final weights EXACTLY equal the
    uninterrupted run (integer grads, power-of-two lr: the arithmetic
    is order-independent and exact in fp32)."""
    srv0, srv1 = _elastic_pair(monkeypatch)
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        kv.init("small", mx.nd.ones((2, 2)))
        kv.set_optimizer(mx.optimizer.SGD(
            learning_rate=0.125, momentum=0.0, wd=0.0, rescale_grad=1.0))
        kv.push("big", mx.nd.ones((10, 4)))
        kv.push("small", mx.nd.ones((2, 2)))
        out_b, out_s = mx.nd.zeros((10, 4)), mx.nd.zeros((2, 2))
        kv.pull("big", out=out_b)        # sync point: cache = server state
        kv.pull("small", out=out_s)
        # both servers hold live stripes before the kill
        assert len(srv0._store) >= 1 and len(srv1._store) >= 1
        gen0 = kv._roster_gen
        srv1.stop()                      # SIGKILL-equivalent: state LOST
        # next round rides the repair path end to end
        kv.push("big", mx.nd.ones((10, 4)) * 2)
        kv.push("small", mx.nd.ones((2, 2)) * 2)
        kv.barrier()
        kv.pull("big", out=out_b)
        kv.pull("small", out=out_s)
        np.testing.assert_array_equal(out_b.asnumpy(), big - 0.125 * 3)
        np.testing.assert_array_equal(out_s.asnumpy(), 1.0 - 0.125 * 3)
        assert kv._roster_gen > gen0
        assert kv._roster_servers == [f"127.0.0.1:{srv0.port}"]
        counts = profiler.channel_counts()
        assert counts.get("kvstore.roster_bump", 0) >= 1
        assert counts.get("kvstore.handoff_applied", 0) >= 1
        assert counts.get("kvstore.orphan_repush", 0) >= 1
        assert counts.get("kvstore.roster_generation", 0) >= 1
        assert profiler.channel_bytes().get("handoff", 0) > 0
        distributed = mx.distributed
        assert distributed.roster_generation() >= 1
        # striping must have re-derived: the survivor now owns ALL keys
        assert "big" in srv0._store and "small" in srv0._store
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_momentum_state_hands_off_via_snapshot(monkeypatch):
    """Optimizer state survives a SIGKILL through the coordinator's
    banked snapshot: a momentum-SGD run that loses server 1 and repairs
    at a QUIESCENT sync point (barrier, no pushes in flight) finishes
    EXACTLY like an uninterrupted single-server run of the same push
    sequence — momentum restriping is elementwise-exact.  (A repair
    with pushes still in flight keeps VALUES exact but may capture
    survivor-stripe momentum one update ahead — the same staleness
    async SGD already tolerates.)"""
    srv0, srv1 = _elastic_pair(monkeypatch, snapshot_s=0.05)
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        opt = mx.optimizer.SGD(learning_rate=0.125, momentum=0.5,
                               wd=0.0, rescale_grad=1.0)
        kv.set_optimizer(opt)
        kv.push("big", mx.nd.ones((10, 4)))      # momentum builds
        out = mx.nd.zeros((10, 4))
        kv.pull("big", out=out)                  # sync point
        # which of big's stripes lives on (doomed) server 1
        uris = os.environ["MXT_SERVER_URIS"].split(",")
        doomed_wk = [wk for wk, (uri, _lo, _hi) in membership.wire_layout(
            "big", (10, 4), uris, 16).items() if uri == uris[1]][0]

        def banked_momentum():
            m = srv0._get_membership()
            snap = m.snapshot_of(uris[1]) if m else None
            return snap is not None and snap.get("states", {}).get(
                doomed_wk) not in (None, ())

        deadline = time.time() + 5
        while not banked_momentum() and time.time() < deadline:
            time.sleep(0.02)                 # wait for a POST-push beat
        assert banked_momentum(), "no momentum-bearing snapshot banked"
        srv1.stop()
        kv.barrier()         # quiescent repair: handoff at the sync point
        kv.push("big", mx.nd.ones((10, 4)))      # momentum compounds on
        kv.barrier()
        kv.pull("big", out=out)
        # golden: the same sequence against one never-interrupted server
        mom = np.zeros((10, 4), np.float32)
        w = big.copy()
        for _ in range(2):
            mom = 0.5 * mom - 0.125 * np.ones((10, 4), np.float32)
            w = w + mom
        np.testing.assert_array_equal(out.asnumpy(), w)
        counts = profiler.channel_counts()
        assert counts.get("kvstore.handoff_state_applied", 0) >= 1
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_repair_with_compression_residuals(monkeypatch):
    """2-bit wire compression composes with a roster bump: the
    error-feedback residuals are keyed by WIRE key and shaped like the
    OLD stripe spans — a re-stripe must drop the moved keys' residuals
    (bounded pending-quantum loss, same class as compression itself)
    instead of broadcast-adding stale rows into the new layout or
    crashing on the shape mismatch."""
    srv0, srv1 = _elastic_pair(monkeypatch)
    monkeypatch.setenv("MXNET_KVSTORE_COMPRESSION", "2bit")
    monkeypatch.setenv("MXNET_KVSTORE_COMPRESSION_THRESHOLD", "0.5")
    try:
        kv = mx.kv.create("dist_async")
        big = np.zeros((10, 4), np.float32)
        kv.init("big", mx.nd.NDArray(big))
        kv.set_optimizer(mx.optimizer.SGD(
            learning_rate=1.0, momentum=0.0, wd=0.0, rescale_grad=1.0))
        # fractional grads leave nonzero residuals behind, one per
        # OLD-layout stripe key
        kv.push("big", mx.nd.ones((10, 4)) * 0.3)
        out = mx.nd.zeros((10, 4))
        kv.pull("big", out=out)
        assert any("@s" in wk for wk in kv._gc_residual)
        srv1.stop()
        kv.push("big", mx.nd.ones((10, 4)) * 0.3)   # repairs mid-flight
        kv.barrier()
        kv.pull("big", out=out)                     # completes, no crash
        # stale striped residuals are gone; the re-grown one matches the
        # new (whole-key) layout
        assert not any("@s" in wk for wk in kv._gc_residual), \
            kv._gc_residual.keys()
        if "big" in kv._gc_residual:
            assert kv._gc_residual["big"].shape == (10, 4)
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_worker_join_and_graceful_leave(monkeypatch):
    """Add a worker at step N: a second worker joins mid-job (roster
    bump), barriers re-target the grown roster, and a graceful close
    deregisters it so the survivor's barriers shrink back without
    waiting out a heartbeat timeout."""
    srv0, srv1 = _elastic_pair(monkeypatch, num_workers=1)
    try:
        kv1 = mx.kv.create("dist_async")
        kv1.init("w", mx.nd.zeros(SHAPE))
        kv1.barrier()                      # 1-worker barrier: immediate
        assert kv1.num_workers == 1
        monkeypatch.setenv("DMLC_WORKER_ID", "1")
        kv2 = mx.kv.create("dist_async")   # joins: generation bump
        assert kv2.num_workers == 2
        done = []

        def w2_barrier():
            try:
                kv2.barrier()
                done.append("ok")
            except Exception as exc:  # noqa: BLE001 — surfaced below
                done.append(exc)

        t = threading.Thread(target=w2_barrier, daemon=True)
        t.start()
        time.sleep(0.2)
        assert not done                    # rank 1 is parked, waiting
        kv1.barrier()                      # rank 0 arrives -> released
        t.join(timeout=10)
        assert done == ["ok"]
        assert kv1.num_workers == 2        # barrier reply refreshed kv1
        kv2.close()                        # graceful roster_leave
        kv1.barrier()                      # 1-worker again: immediate
        assert kv1.num_workers == 1
        kv1.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_graceful_server_leave(monkeypatch):
    """A departing server ships its final snapshot and deregisters; the
    worker converges at its next op and the values survive exactly."""
    srv0, srv1 = _elastic_pair(monkeypatch, snapshot_s=3600.0)
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        kv.push("big", mx.nd.NDArray(big * 3))   # assign semantics
        out = mx.nd.zeros((10, 4))
        kv.pull("big", out=out)
        srv1.leave()                       # snapshot + roster_leave + stop
        kv.push("big", mx.nd.NDArray(big * 5))
        kv.barrier()
        kv.pull("big", out=out)
        np.testing.assert_array_equal(out.asnumpy(), big * 5)
        assert len(kv._conns) == 1
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_stripe_plan_staleness_is_hard_error(monkeypatch):
    """Mutating the server set WITHOUT the elastic path must
    fail loudly — a stale cached plan silently routes rows to the wrong
    servers.  _reset_stripe_plans() is the sanctioned clear."""
    srvs = [KVStoreServer(server_id=i, num_workers=1) for i in range(2)]
    for s in srvs:
        s.start_background()
    try:
        monkeypatch.setenv("MXT_SERVER_URIS", ",".join(
            f"127.0.0.1:{s.port}" for s in srvs))
        monkeypatch.setenv("DMLC_NUM_WORKER", "1")
        monkeypatch.setenv("DMLC_WORKER_ID", "0")
        monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "16")
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        dropped = kv._conns.pop()          # the old test-only mutation
        with pytest.raises(MXNetError, match="server count changed"):
            kv._stripe_plan("big", big.shape)
        kv._reset_stripe_plans()
        assert kv._stripe_plan("big", big.shape) is None  # 1 server now
        kv._conns.append(dropped)
        kv._reset_stripe_plans()
        kv.close(stop_servers=True)
    finally:
        for s in srvs:
            s.stop()


def test_elastic_coordinator_death_fails_over_exact(monkeypatch):
    """The coordinator-death flow, in-process: kill server 0.
    The worker elects the deterministic successor (server 1), reports
    the death there; the successor verifies it with its own probe,
    rebuilds the ledger at max(reported)+1 and answers with the
    post-succession roster; the ordinary three-phase handoff then
    reconstructs server 0's stripes — final weights EXACTLY equal the
    uninterrupted run (integer grads, power-of-two lr).  No restart,
    no votes, no extra protocol."""
    srv0, srv1 = _elastic_pair(monkeypatch)
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        kv.init("small", mx.nd.ones((2, 2)))
        kv.set_optimizer(mx.optimizer.SGD(
            learning_rate=0.125, momentum=0.0, wd=0.0, rescale_grad=1.0))
        kv.push("big", mx.nd.ones((10, 4)))
        kv.push("small", mx.nd.ones((2, 2)))
        out_b, out_s = mx.nd.zeros((10, 4)), mx.nd.zeros((2, 2))
        kv.pull("big", out=out_b)        # sync point: cache = state
        kv.pull("small", out=out_s)
        gen0 = kv._roster_gen
        srv0.stop()                      # the COORDINATOR dies
        # the next round rides succession + repair end to end
        kv.push("big", mx.nd.ones((10, 4)) * 2)
        kv.push("small", mx.nd.ones((2, 2)) * 2)
        kv.barrier()                     # retried against the successor
        kv.pull("big", out=out_b)
        kv.pull("small", out=out_s)
        np.testing.assert_array_equal(out_b.asnumpy(), big - 0.125 * 3)
        np.testing.assert_array_equal(out_s.asnumpy(), 1.0 - 0.125 * 3)
        uris = os.environ["MXT_SERVER_URIS"].split(",")
        assert kv._roster_servers == [uris[1]]
        assert kv._roster_gen > gen0
        assert kv._failovers == 1
        assert srv1._promoted
        assert srv1._get_membership().roster().servers == (uris[1],)
        counts = profiler.channel_counts()
        assert counts.get("kvstore.coordinator_failover", 0) >= 1
        assert counts.get("kvstore.coordinator_failover_observed",
                          0) >= 1
        assert counts.get("kvstore.coordinator_slot", None) == 1
        assert counts.get("kvstore.failover_rebuild_s", None) is not None
        distributed = mx.distributed
        assert distributed.coordinator_failovers() >= 1
        # the survivor (now coordinator) owns every key
        assert "big" in srv1._store and "small" in srv1._store
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_coordinator_death_momentum_via_peer_bank(monkeypatch):
    """The snapshot bank OUTLIVES server 0: the coordinator's beat
    fan-out ships its state snapshots to every peer, each peer banks
    them, and a promotion preloads the local bank into the rebuilt
    ledger — so momentum on the dead COORDINATOR's stripes restripes
    elementwise-exactly, same contract as the non-coordinator kill."""
    srv0, srv1 = _elastic_pair(monkeypatch, snapshot_s=0.05)
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        kv.set_optimizer(mx.optimizer.SGD(
            learning_rate=0.125, momentum=0.5, wd=0.0, rescale_grad=1.0))
        kv.push("big", mx.nd.ones((10, 4)))      # momentum builds
        out = mx.nd.zeros((10, 4))
        kv.pull("big", out=out)                  # sync point
        uris = os.environ["MXT_SERVER_URIS"].split(",")
        doomed_wk = [wk for wk, (uri, _lo, _hi) in membership.wire_layout(
            "big", (10, 4), uris, 16).items() if uri == uris[0]][0]

        def banked_on_peer():
            have = srv1._peer_snapshots.get(uris[0])
            return have is not None and have[1].get("states", {}).get(
                doomed_wk) not in (None, ())

        deadline = time.time() + 5
        while not banked_on_peer() and time.time() < deadline:
            time.sleep(0.02)             # wait for a POST-push beat
        assert banked_on_peer(), \
            "no momentum-bearing coordinator snapshot banked on the peer"
        srv0.stop()                      # the COORDINATOR dies
        kv.barrier()     # quiescent repair: succession at the sync point
        kv.push("big", mx.nd.ones((10, 4)))      # momentum compounds on
        kv.barrier()
        kv.pull("big", out=out)
        # golden: the same sequence against one never-interrupted server
        mom = np.zeros((10, 4), np.float32)
        w = big.copy()
        for _ in range(2):
            mom = 0.5 * mom - 0.125 * np.ones((10, 4), np.float32)
            w = w + mom
        np.testing.assert_array_equal(out.asnumpy(), w)
        assert profiler.channel_counts().get(
            "kvstore.handoff_state_applied", 0) >= 1
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


def test_elastic_double_death_walks_to_true_survivor(monkeypatch):
    """Coordinator AND the next roster slot die together: the worker's
    repair walks the election past the dead successor (its channel's
    hard failure is the evidence), and the true survivor's probe-walk
    excludes BOTH corpses from the rebuilt roster — values stay exact
    on the last server standing."""
    monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX", "2")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_INITIAL_MS", "10")
    monkeypatch.setenv("MXNET_KVSTORE_RETRY_MAX_MS", "50")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.1")
    monkeypatch.setenv("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "0.5")
    monkeypatch.setenv("MXNET_KVSTORE_BIGARRAY_BOUND", "16")
    monkeypatch.setenv("MXNET_KVSTORE_SNAPSHOT_S", "0")
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    srvs = [KVStoreServer(server_id=i, num_workers=1, elastic=True)
            for i in range(3)]
    uris = ",".join(f"127.0.0.1:{s.port}" for s in srvs)
    monkeypatch.setenv("MXT_SERVER_URIS", uris)
    for s in srvs:
        s._roster_servers = uris.split(",")
        s.start_background()
    try:
        kv = mx.kv.create("dist_async")
        big = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mx.nd.NDArray(big))
        kv.set_optimizer(mx.optimizer.SGD(
            learning_rate=0.125, momentum=0.0, wd=0.0, rescale_grad=1.0))
        kv.push("big", mx.nd.ones((10, 4)))
        out = mx.nd.zeros((10, 4))
        kv.pull("big", out=out)
        srvs[0].stop()               # the coordinator...
        srvs[1].stop()               # ...AND its deterministic successor
        kv.push("big", mx.nd.ones((10, 4)) * 2)
        kv.barrier()
        kv.pull("big", out=out)
        np.testing.assert_array_equal(out.asnumpy(), big - 0.125 * 3)
        assert kv._roster_servers == [uris.split(",")[2]]
        assert srvs[2]._promoted and kv._failovers >= 1
        assert kv._coordinator_slot == 2
        m = srvs[2]._get_membership()
        assert m.roster().servers == (uris.split(",")[2],)
        kv.close(stop_servers=True)
    finally:
        for s in srvs:
            s.stop()


def test_beat_loop_self_promotes_on_coordinator_silence(monkeypatch):
    """No worker needed: the survivors' own beat loops detect the
    coordinator's death (refused dial = decisive evidence), every one
    elects the same successor, and the elected one promotes itself —
    so a workerless window (e.g. between epochs) still converges."""
    srv0, srv1 = _elastic_pair(monkeypatch)
    try:
        deadline = time.time() + 5
        while srv1._coord_last_ok is None and time.time() < deadline:
            time.sleep(0.02)             # beats flowing to server 0
        assert srv1._coord_last_ok is not None
        srv0.stop()
        deadline = time.time() + 10
        while not srv1._promoted and time.time() < deadline:
            time.sleep(0.05)
        assert srv1._promoted
        uris = os.environ["MXT_SERVER_URIS"].split(",")
        m = srv1._get_membership()
        assert m is not None and m.roster().servers == (uris[1],)
        assert m.failovers == 1
        assert profiler.channel_counts().get(
            "kvstore.coordinator_failover", 0) >= 1
    finally:
        srv0.stop()
        srv1.stop()


def test_serving_replica_tolerates_roster_bump(monkeypatch):
    """The serving tier's weight-refresh client follows the roster: a
    parameter server dying between version pulls repairs transparently
    (roster_member=False — the replica never joins the roster), and a
    version bump published AFTER the churn still refreshes served
    weights with zero replica restarts."""
    serving = mx.serving
    srv0, srv1 = _elastic_pair(monkeypatch)
    try:
        kv = mx.kv.create("dist_async")
        # layer name chosen so 'fca_weight' crc-routes to server 1 (the
        # one we kill) — the refresh MUST cross the repair path
        assert membership.server_index("fca_weight", 2) == 1
        w = np.full((2, 4), 2.0, np.float32)   # FC weight: (hidden, in)
        kv.init("fca_weight", mx.nd.NDArray(w))
        serving.publish_version(kv, 1)
        # build a replica over the SAME roster
        sym = mx.sym
        data = sym.Variable("data")
        net = sym.FullyConnected(data, num_hidden=2, no_bias=True,
                                 name="fca")
        replica = serving.ServingReplica(
            net, {"data": (1, 4)},
            {"fca_weight": mx.nd.NDArray(w)}, {},
            param_servers=os.environ["MXT_SERVER_URIS"].split(","),
            refresh_interval=0.0, port=0)
        r1 = replica._refresh_once()
        gen_before = getattr(replica._ps, "_roster_gen", 0)
        # kill whichever server does NOT host the coordinator
        srv1.stop()
        # trainer-side: repair + handoff re-homes every key (incl. the
        # version register), then publish a NEW version
        kv.push("fca_weight", mx.nd.NDArray(np.full((2, 4), 5.0,
                                                    np.float32)))
        kv.barrier()
        serving.publish_version(kv, 2)
        r2 = replica._refresh_once()       # repairs mid-pull if needed
        assert r2["version"] == 2 and r2["refreshed"]
        assert getattr(replica._ps, "_roster_gen", 0) > gen_before
        stats = replica._op_stats(("serving_stats",), None)
        assert stats["roster_generation"] >= 1
        # the failover observables surface through serving_stats too
        assert "coordinator_slot" in stats
        assert stats["coordinator_failovers"] == 0   # srv1 was not coord
        replica.stop()
        kv.close(stop_servers=True)
    finally:
        srv0.stop()
        srv1.stop()


