"""The serving fleet (``FleetClient``) in both packages: every case of
``tests/test_fleet.py`` as the JAX package's suite writes it, run once
against the JAX package and once against the port (on the CPU):
routing, the degraded penalty and round-robin ties, the backoff
schedule pinned exactly under an injected clock, quarantine and
reinstatement, the stale-verdict discount, drain and
``observe_roster``, the canary's p99 and error-rate rollbacks and its
promotion, and end to end over two live replicas, around a blackholed
one and through a storm with one replica that sheds everything.

Tolerance: replies are one float32 dense layer's softmax against
numpy's, rtol 1e-5 / atol 1e-6 (float32 summation order and exp)."""
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
        mx=p, faultinject=p.faultinject, health=p.health,
        profiler=p.profiler, MXNetError=p.base.MXNetError,
        BusyError=p.serving.BusyError, FleetClient=p.serving.FleetClient,
        FleetError=p.serving.FleetError,
        PredictTimeout=p.serving.PredictTimeout,
        ServingReplica=p.serving.ServingReplica)


pkg = both_packages(globals(), _bind)


@pytest.fixture(autouse=True)
def _clean_slate(pkg):
    """Every test starts with a clean flight recorder and no armed
    fault plan: a replica's self-reported verdict is the process-global
    roll-up, so leaked channel poison would read CRITICAL here."""
    health.reset()
    faultinject.reset()
    profiler.reset_channel_counts()
    yield
    faultinject.reset()


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


def _replica(**kw):
    kw.setdefault('buckets', [2, 4])
    kw.setdefault('warmup', False)
    rep = ServingReplica(_softmax_symbol(), {'data': (FEAT,)},
                         _params(), **kw)
    rep.start_background()
    return rep


# -- deterministic harness ----------------------------------------------------
class _FakeTime:
    """Injected monotonic clock + sleep recorder — the retry tests'
    whole point is that NO real time passes."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(round(d, 9))
        self.t += d


class _StubFuture:
    def __init__(self, fn, timeout_seen):
        self._fn = fn
        self._timeout_seen = timeout_seen

    def get(self, timeout=None):
        self._timeout_seen.append(timeout)
        return self._fn()


class _StubClient:
    """Stands in for ServingClient on a scoreboard entry: ``behavior``
    runs at ``get()`` time and either returns outputs or raises."""

    def __init__(self, behavior, stats=None):
        self.behavior = behavior
        self.calls = 0
        self.canary_calls = 0
        self.timeouts_seen = []
        self._stats = stats

    def predict_async(self, data, name="data", canary=False):
        self.calls += 1
        if canary:
            self.canary_calls += 1
        return _StubFuture(self.behavior, self.timeouts_seen)

    def stats(self, timeout=None):
        if self._stats is None:
            raise MXNetError("stub has no stats")
        return dict(self._stats)

    def refresh(self, timeout=None):
        return {"version": 99, "refreshed": True}

    def drain(self, enable=True, timeout=None):
        return {"draining": bool(enable)}

    def is_dead(self):
        return False

    def close(self):
        pass

    def abort(self):
        pass


def _stub_fleet(behaviors, ft=None, **kw):
    """FleetClient over stub clients (no sockets, no background poll).
    ``behaviors`` maps uri -> callable for that replica's get()."""
    ft = ft or _FakeTime()
    kw.setdefault("jitter", 0.0)
    kw.setdefault("backoff_ms", 10.0)
    kw.setdefault("backoff_max_ms", 40.0)
    kw.setdefault("deadline_s", 1000.0)
    kw.setdefault("attempt_s", 5.0)
    fl = FleetClient(list(behaviors), stats_interval=0,
                     clock=ft.clock, sleep=ft.sleep, **kw)
    stubs = {}
    for uri, beh in behaviors.items():
        st = beh if isinstance(beh, _StubClient) else _StubClient(beh)
        fl._entries[uri].client = st
        stubs[uri] = st
    return fl, stubs, ft


_OK = lambda: [np.zeros((1, HIDDEN), np.float32)]  # noqa: E731


def _busy(tag):
    def beh():
        raise BusyError("shed busy-%s" % tag)
    return beh


# -- routing ------------------------------------------------------------------
def test_routing_excludes_sick_states():
    """CRITICAL, draining, quarantined and dead replicas never see a
    request — every route lands on the one healthy survivor."""
    fl, stubs, _ = _stub_fleet({u: _OK for u in "abcd"}, retries=0)
    fl._entries["b"].verdict = "CRITICAL"
    fl._entries["c"].draining = True
    fl._entries["d"].quarantined = True
    for _ in range(5):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["a"].calls == 5
    assert all(stubs[u].calls == 0 for u in "bcd")
    sb = fl.scoreboard()
    assert sb["b"]["state"] == "CRITICAL"
    assert sb["c"]["state"] == "DRAINING"
    assert sb["d"]["state"] == "DEAD"


def test_degraded_penalty_steers_traffic():
    """A DEGRADED replica still serves, but only once the healthy one
    is loaded past the penalty multiplier — at idle it gets nothing."""
    fl, stubs, _ = _stub_fleet({"deg": _OK, "ok": _OK}, retries=0,
                               degraded_penalty=4.0)
    fl._entries["deg"].verdict = "DEGRADED"
    for _ in range(6):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["ok"].calls == 6 and stubs["deg"].calls == 0
    # queue pressure on the healthy one flips the comparison:
    # (0+4+1)*1 = 5 > (0+0+1)*4 = 4
    fl._entries["ok"].queue_depth = 4
    fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["deg"].calls == 1


def test_least_loaded_ties_round_robin():
    fl, stubs, _ = _stub_fleet({"a": _OK, "b": _OK}, retries=0)
    for _ in range(8):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["a"].calls == 4 and stubs["b"].calls == 4


# -- retries ------------------------------------------------------------------
def test_busy_retries_on_a_different_replica():
    profiler.reset_channel_counts()
    fl, stubs, ft = _stub_fleet({"busy": _busy("x"), "good": _OK})
    for _ in range(6):
        outs = fl.predict(np.zeros((1, FEAT), np.float32))
        assert outs[0].shape == (1, HIDDEN)
    sb = fl.scoreboard()
    # every attempt that hit the busy replica was shed and re-routed;
    # none of the 6 requests failed
    assert sb["busy"]["busy"] == stubs["busy"].calls
    assert stubs["good"].calls == 6 + 0  # every request ended here
    counts = profiler.channel_counts()
    assert counts.get("fleet.busy", 0) == stubs["busy"].calls
    if stubs["busy"].calls:
        assert counts["fleet.retry"] >= stubs["busy"].calls
    # BUSY does NOT quarantine — the replica is healthy, just full
    assert sb["busy"]["state"] == "OK"


def test_backoff_schedule_pinned_exactly():
    """jitter=0 + injected clock/sleep: the retry backoff is EXACTLY
    base * 2^k capped — and not one real millisecond passes."""
    fl, _, ft = _stub_fleet(
        {u: _busy(u) for u in ("r0", "r1", "r2")},
        retries=4, backoff_ms=10.0, backoff_max_ms=40.0)
    wall0 = time.monotonic()
    with pytest.raises(FleetError) as ei:
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert time.monotonic() - wall0 < 2.0      # no real sleeps
    assert ft.sleeps == [0.01, 0.02, 0.04, 0.04]
    msg = str(ei.value)
    for uri in ("r0", "r1", "r2"):
        assert uri in msg, msg
    assert "retry budget" in msg


def test_jittered_backoff_stays_in_band():
    import random
    ft = _FakeTime()
    fl, _, _ = _stub_fleet(
        {u: _busy(u) for u in ("a", "b")}, ft=ft,
        retries=3, jitter=0.5, backoff_ms=100.0, backoff_max_ms=400.0)
    fl._rng = random.Random(7)
    with pytest.raises(FleetError):
        fl.predict(np.zeros((1, FEAT), np.float32))
    bases = [0.1, 0.2, 0.4]
    assert len(ft.sleeps) == 3
    for got, base in zip(ft.sleeps, bases):
        assert base * 0.5 <= got <= base * 1.5, (got, base)
        assert got != base                      # jitter actually moved it


def test_exhaustion_names_every_replica_and_surfaces_last_error():
    fl, _, _ = _stub_fleet(
        {u: _busy(u) for u in ("s1", "s2", "s3")}, retries=2)
    with pytest.raises(FleetError) as ei:
        fl.predict(np.zeros((1, FEAT), np.float32))
    msg = str(ei.value)
    for uri in ("s1", "s2", "s3"):
        assert uri in msg, msg
    # the LAST error rides along: named inline AND chained as __cause__
    assert "last error from" in msg and "BusyError" in msg
    last_uri = msg.split("last error from ")[1].split(":")[0]
    assert ("busy-%s" % last_uri) in msg
    assert isinstance(ei.value.__cause__, BusyError)


def test_deadline_exhaustion_is_typed_and_named():
    ft = _FakeTime()

    def slow_busy():
        ft.t += 10.0                 # each attempt burns 10 fake seconds
        raise BusyError("still full")

    fl, _, _ = _stub_fleet({"a": slow_busy, "b": slow_busy}, ft=ft,
                           retries=100, deadline_s=25.0, attempt_s=50.0)
    with pytest.raises(FleetError, match="deadline"):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert ft.t < 40.0               # stopped at the deadline, not at 100


def test_attempt_timeout_bounded_by_deadline():
    """The per-attempt wait shrinks to the remaining deadline — a
    30s attempt budget never outlives a 2s request deadline."""
    fl, stubs, ft = _stub_fleet({"only": _OK}, retries=0,
                                deadline_s=2.0, attempt_s=30.0)
    fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["only"].timeouts_seen == [2.0]


def test_timeout_quarantines_and_poll_reinstates():
    """A reply timeout is the gray-failure verdict: quarantine NOW,
    route around, and only a successful scoreboard probe re-earns
    eligibility."""
    profiler.reset_channel_counts()

    def hang():
        raise PredictTimeout("no reply within 0.1s")

    good_stats = {"health": {"status": "OK", "ts": time.time()},
                  "queue_depth": 0, "queue_limit": 8, "version": 1}
    hung = _StubClient(hang, stats=good_stats)
    fl, stubs, _ = _stub_fleet({"hung": hung, "good": _OK})
    for _ in range(4):
        fl.predict(np.zeros((1, FEAT), np.float32))
    sb = fl.scoreboard()
    assert sb["good"]["routes"] == 4          # every request ended here
    assert sb["hung"]["routes"] == sb["hung"]["timeouts"]
    if sb["hung"]["timeouts"]:
        assert sb["hung"]["state"] == "DEAD"    # quarantined
        hung_calls = stubs["hung"].calls
        for _ in range(4):                      # no more traffic there
            fl.predict(np.zeros((1, FEAT), np.float32))
        assert stubs["hung"].calls == hung_calls
        assert profiler.channel_counts()["fleet.timeout"] \
            == sb["hung"]["timeouts"]
        # quarantine REPLACED the suspect conn (FIFO acks are
        # misaligned after a missed reply; see ServingClient.abort)
        assert fl._entries["hung"].client is None
        # the probe re-dials and clears the quarantine (stats OK)
        fl._entries["hung"].client = hung
        states = fl.poll_once()
        assert states["hung"] == "OK"


def test_conn_error_quarantines_and_flight_records():
    def refuse():
        raise ConnectionRefusedError("nope")

    fl, _, _ = _stub_fleet({"down": refuse, "up": _OK})
    health.reconfigure()
    outs = fl.predict(np.zeros((1, FEAT), np.float32))
    assert outs[0].shape == (1, HIDDEN)
    sb = fl.scoreboard()
    if sb["down"]["conn_errors"]:
        assert sb["down"]["state"] == "DEAD"
        kinds = [e["kind"] for e in health.events()]
        assert "fleet_quarantine" in kinds


# -- scoreboard staleness -----------------------------------------------------
def test_stale_ok_verdict_discounted_to_degraded():
    """An OK stamped 100s ago is NOT a live OK: the router discounts it
    past MXNET_HEALTH_STALE_S and steers to the freshly-OK replica."""
    stale = _StubClient(_OK, stats={
        "health": {"status": "OK", "ts": time.time() - 100.0},
        "queue_depth": 0, "queue_limit": 8, "version": 1})
    fresh = _StubClient(_OK, stats={
        "health": {"status": "OK", "ts": time.time()},
        "queue_depth": 0, "queue_limit": 8, "version": 1})
    fl, stubs, _ = _stub_fleet({"stale": stale, "fresh": fresh},
                               retries=0, stale_s=30.0)
    states = fl.poll_once()
    assert states == {"stale": "DEGRADED", "fresh": "OK"}
    sb = fl.scoreboard()
    assert sb["stale"]["verdict_age_s"] >= 99.0
    for _ in range(4):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert stubs["fresh"].calls == 4 and stubs["stale"].calls == 0


def test_poll_quarantines_unreachable_replica():
    dead = _StubClient(_OK)          # stats raises (stub has none)
    live = _StubClient(_OK, stats={
        "health": {"status": "OK", "ts": time.time()},
        "queue_depth": 2, "queue_limit": 8, "version": 7})
    fl, _, _ = _stub_fleet({"dead": dead, "live": live}, retries=0)
    states = fl.poll_once()
    assert states["dead"] == "DEAD" and states["live"] == "OK"
    sb = fl.scoreboard()
    assert sb["live"]["queue_depth"] == 2 and sb["live"]["version"] == 7


# -- drain / roster -----------------------------------------------------------
def test_observe_roster_drains_departed_and_adds_joined():
    fl, _, _ = _stub_fleet({"a": _OK, "b": _OK}, retries=0)
    diff = fl.observe_roster(["b", "c"])
    assert diff == {"added": ["c"], "removed": ["a"]}
    sb = fl.scoreboard()
    assert sb["a"]["state"] == "DRAINING"
    assert "c" in sb and sb["c"]["state"] == "OK"
    # reconciliation is idempotent
    assert fl.observe_roster(["b", "c"]) == {"added": [], "removed": []}


def test_drain_is_sticky_server_side():
    """Operator drain travels over the wire: the replica flags itself
    in serving_stats, so a SECOND fleet (different process in prod)
    observes the drain on its next poll."""
    rep = _replica(max_wait_s=0.0)
    uri = f"127.0.0.1:{rep.port}"
    fl1 = FleetClient([uri], stats_interval=0, connect_timeout=10.0)
    fl2 = FleetClient([uri], stats_interval=0, connect_timeout=10.0)
    try:
        fl1.predict(np.zeros((1, FEAT), np.float32))
        fl1.drain(uri)
        with pytest.raises(FleetError, match="no eligible"):
            fl1.predict(np.zeros((1, FEAT), np.float32))
        assert fl2.poll_once()[uri] == "DRAINING"
        fl1.undrain(uri)
        outs = fl1.predict(np.zeros((1, FEAT), np.float32))
        assert outs[0].shape == (1, HIDDEN)
        assert fl2.poll_once()[uri] != "DRAINING"
    finally:
        fl1.close()
        fl2.close()
        rep.stop()


# -- canary -------------------------------------------------------------------
def _armed_canary(p99_regression):
    """Stub fleet with an active canary on 'can'; cohort windows filled
    to the min sample count, regression injected on the last canary
    sample."""
    fl, stubs, ft = _stub_fleet({"base": _OK, "can": _OK},
                                canary_min_n=8, canary_fraction=0.5)
    fl.start_canary(["can"], refresh=False)
    for _ in range(8):
        fl._note_sample("baseline", 0.010, ok=True)
    for i in range(8):
        if p99_regression:
            fl._note_sample("canary", 0.100, ok=True)   # 10x the p99
        else:
            fl._note_sample("canary", 0.010, ok=(i < 4))  # 50% errors
    return fl, stubs


def test_canary_p99_regression_rolls_back():
    health.reconfigure()
    profiler.reset_channel_counts()
    fl, _ = _armed_canary(p99_regression=True)
    assert not fl.canary_active
    assert fl.last_rollback["reasons"] == ["p99"]
    assert fl.last_rollback["canary_p99_ms"] == 100.0
    sb = fl.scoreboard()
    assert sb["can"]["state"] == "DRAINING" and not sb["can"]["canary"]
    assert profiler.channel_counts()["fleet.rollback"] == 1
    ev = [e for e in health.events() if e["kind"] == "canary_rollback"]
    assert ev and ev[-1]["uris"] == ["can"]
    # post-rollback traffic goes ONLY to the baseline
    for _ in range(4):
        fl.predict(np.zeros((1, FEAT), np.float32))
    assert fl.scoreboard()["base"]["routes"] >= 4


def test_canary_error_rate_regression_rolls_back():
    fl, _ = _armed_canary(p99_regression=False)
    assert not fl.canary_active
    assert "error_rate" in fl.last_rollback["reasons"]
    rep = fl.canary_report()
    assert rep["canary"]["err"] == 4 and rep["baseline"]["err"] == 0


def test_canary_needs_both_cohorts_before_judging():
    """No verdict before BOTH cohorts hit the minimum sample count —
    8 slow canary samples alone must not trigger anything."""
    fl, _, _ = _stub_fleet({"base": _OK, "can": _OK}, canary_min_n=8)
    fl.start_canary(["can"], refresh=False)
    for _ in range(8):
        fl._note_sample("canary", 0.100, ok=True)
    assert fl.canary_active and fl.last_rollback is None


def test_canary_routes_fraction_with_tagged_op():
    import random
    fl, stubs, _ = _stub_fleet({"base": _OK, "can": _OK},
                               canary_fraction=0.5, canary_min_n=10 ** 6)
    fl._rng = random.Random(3)
    fl.start_canary(["can"], refresh=False)
    for _ in range(40):
        fl.predict(np.zeros((1, FEAT), np.float32))
    # the canary cohort got real traffic, all of it canary-TAGGED ops
    assert 5 <= stubs["can"].calls <= 35
    assert stubs["can"].canary_calls == stubs["can"].calls
    assert stubs["base"].canary_calls == 0
    assert stubs["base"].calls + stubs["can"].calls == 40


def test_canary_promote_dissolves_cohorts():
    fl, stubs, _ = _stub_fleet({"base": _OK, "can": _OK},
                               canary_min_n=10 ** 6)
    replies = fl.start_canary(["can"], refresh=True)
    assert replies["can"]["refreshed"] is True
    promoted = fl.promote_canary()
    assert set(promoted) == {"base"}
    assert not fl.canary_active
    sb = fl.scoreboard()
    assert not sb["can"]["canary"] and not sb["can"]["draining"]
    with pytest.raises(MXNetError, match="promote"):
        fl.promote_canary()


# -- live-replica integration -------------------------------------------------
def test_fleet_over_two_replicas_end_to_end():
    """Two real replicas, one fleet: correct outputs, traffic on both,
    per-replica routing counters visible in the profiler."""
    profiler.reset_channel_counts()
    reps = [_replica(max_wait_s=0.0) for _ in range(2)]
    uris = [f"127.0.0.1:{r.port}" for r in reps]
    fl = FleetClient(uris, stats_interval=0, connect_timeout=10.0)
    try:
        assert set(fl.poll_once().values()) == {"OK"}
        x = np.random.RandomState(5).randn(3, FEAT).astype(np.float32)
        want = _ref_softmax(x, _params())
        for _ in range(8):
            outs = fl.predict({'data': x})
            np.testing.assert_allclose(outs[0], want,
                                       rtol=1e-5, atol=1e-6)
        routed = profiler.fleet_route_counts()
        assert set(routed) == set(uris)
        assert all(v > 0 for v in routed.values())
        assert sum(routed.values()) == 8
    finally:
        fl.close()
        for r in reps:
            r.stop()


def test_fleet_routes_around_blackholed_replica():
    """The gray failure, in-process: the replica keeps
    accepting and heartbeating but never replies.  Liveness says OK;
    only the fleet's reply timeout catches it — the attempt times out,
    the replica is quarantined, and the caller sees a typed error that
    NAMES the silent replica."""
    faultinject.reset()
    rep = _replica(max_wait_s=0.0)
    uri = f"127.0.0.1:{rep.port}"
    fl = FleetClient([uri], stats_interval=0, connect_timeout=10.0,
                     retries=1, attempt_s=0.5, deadline_s=5.0,
                     backoff_ms=1.0, backoff_max_ms=1.0, jitter=0.0)
    try:
        fl.predict(np.zeros((1, FEAT), np.float32))   # warm, replies on
        with faultinject.blackhole_after_replies(0):
            with pytest.raises(FleetError) as ei:
                fl.predict(np.zeros((1, FEAT), np.float32))
            assert uri in str(ei.value)
            assert isinstance(ei.value.__cause__, PredictTimeout)
            assert faultinject.stats()["replies_blackholed"] >= 1
        sb = fl.scoreboard()
        assert sb[uri]["state"] == "DEAD" and sb[uri]["timeouts"] >= 1
    finally:
        faultinject.reset()
        fl.close()
        rep.stop()


def test_fleet_storm_with_one_busy_replica_zero_failures():
    """16 concurrent callers against a healthy replica plus one that
    sheds EVERYTHING: every request succeeds (retried onto the healthy
    one), nothing leaks to callers."""
    healthy = _replica(max_wait_s=0.0, queue_depth=256)
    shedding = _replica(max_wait_s=0.0, queue_depth=0)
    uris = [f"127.0.0.1:{healthy.port}", f"127.0.0.1:{shedding.port}"]
    fl = FleetClient(uris, stats_interval=0, connect_timeout=10.0,
                     retries=3, backoff_ms=1.0, backoff_max_ms=5.0)
    x = np.random.RandomState(6).randn(2, FEAT).astype(np.float32)
    want = _ref_softmax(x, _params())
    errors = []

    def storm():
        try:
            outs = fl.predict({'data': x})
            np.testing.assert_allclose(outs[0], want,
                                       rtol=1e-5, atol=1e-6)
        except Exception as exc:  # noqa: BLE001 — the assertion IS zero
            errors.append(exc)

    try:
        threads = [threading.Thread(target=storm) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errors, errors
        sb = fl.scoreboard()
        assert sb[uris[0]]["routes"] >= 16     # everyone ended here
    finally:
        fl.close()
        healthy.stop()
        shedding.stop()
