"""Health: watchdogs, SLO evaluation and the flight recorder.

PyTorch counterpart of ``mxnet_tpu/health.py``, with the same events,
status rules and bundle files (``tools/postmortem.py`` reads the port's
bundles unchanged):

* **Flight recorder**: a bounded ring of typed health events
  (``note``), trip counters and, when ``MXNET_HEALTH_DIR`` is set, an
  fsync'd, atomically replaced ``<dir>/<role>-<rank>.crash.json`` bundle
  dumped on unhandled exceptions, channel poison, watchdog trips,
  SIGTERM and exit: recent events, counter families, an env-knob
  fingerprint and (with tracing on) recent span summaries.
* **Stall watchdogs**: a monitor thread, started by the first
  registered wait or probe, that trips on a barrier or wire wait parked
  past its limit, on dead nodes, and on a saturated serving queue (a
  registered probe).  Trips are events, ``health.*`` channel counters,
  trace instants and a bundle dump.
* **SLO rules**: thresholds (p99 latency, wire overlap floor, failover
  budget, BUSY-shed storms) evaluated against ``profiler.snapshot()``,
  rolled up into ``OK`` / ``DEGRADED`` / ``CRITICAL`` with recovery
  hysteresis (``MXNET_HEALTH_RECOVERY_S``).  The status rides
  ``profiler.snapshot()``.

``MXNET_HEALTH=0`` makes every entry point a cheap no-op.  All state is
process-global behind one leaf lock.  Importing this module reads the
knobs and installs nothing: the dump hooks (``sys.excepthook``,
``threading.excepthook``, SIGTERM, ``atexit``) are installed where the
JAX package installs them, by :func:`reconfigure` when a bundle
directory is set, and, for a directory set before import, at the first
use of the recorder (``note``, ``dump``, ``wait_begin``,
``register_probe``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from .base import env
from . import tracing

OK = "OK"
DEGRADED = "DEGRADED"
CRITICAL = "CRITICAL"
_SEV = {OK: 0, DEGRADED: 1, CRITICAL: 2}

_lock = threading.Lock()


class _State:
    """Module config + recorder state, re-readable for tests
    (:func:`reconfigure`)."""

    def __init__(self):
        self.on = True
        self.dir = ""
        self.path = None
        self.interval = 1.0
        self.barrier_stall_s = 30.0
        self.wire_stall_s = 30.0
        self.recovery_s = 5.0
        self.p99_ms = 0.0
        self.overlap_floor = 0.0
        self.failover_budget_s = 0.0
        self.queue_sat = 1.0
        self.busy_storm = 8
        self.busy_window_s = 1.0
        self.role = "local"
        self.rank = "0"
        self.events = deque(maxlen=256)
        self.counts: Dict[str, int] = {}     # events per kind (lifetime)
        self.trips: Dict[str, int] = {}      # watchdog trips per kind
        self.waits: Dict[int, dict] = {}     # token id -> in-flight wait
        self.probes: Dict[str, Callable] = {}
        self.probe_state: Dict[str, dict] = {}   # name -> last sample
        self.progress: Dict[str, float] = {}
        self.poisoned: Dict[str, float] = {}     # uri -> mono of poison
        self.last_bad = None          # mono of the last bad evaluation
        self.worst = OK               # worst status ever computed
        self.dump_reasons: List[str] = []
        self.watchdog = None          # the monitor thread (lazy)
        self.watchdog_err = None      # sticky watchdog crash
        self.hooks_installed = False
        self.next_token = 0


_state = _State()
_prev_excepthook = None
_prev_threading_hook = None


def reconfigure():
    """(Re-)read the MXNET_HEALTH* knobs (tests call it after changing
    the env).  Dump hooks (excepthook / threading.excepthook / SIGTERM /
    atexit) install on the first reconfigure that sees a bundle dir and
    stay installed; they are no-ops while the dir is unset again."""
    want_hooks, want_watchdog = _read_config()
    if want_hooks:
        _install_hooks()
    if want_watchdog:
        # probes/waits registered while health was OFF start being
        # monitored the moment it is re-enabled
        _ensure_watchdog()


def _read_config():
    """Read the knobs; (hooks wanted, watchdog wanted)."""
    with _lock:
        _state.on = bool(env("MXNET_HEALTH", True))
        _state.dir = str(env("MXNET_HEALTH_DIR", "") or "")
        _state.role, _state.rank = tracing.role_rank()
        _state.path = os.path.join(
            _state.dir, "%s-%s.crash.json" % (_state.role, _state.rank)
        ) if _state.dir else None
        _state.interval = max(0.01, float(env("MXNET_HEALTH_INTERVAL_S",
                                              1.0)))
        _state.barrier_stall_s = float(
            env("MXNET_HEALTH_BARRIER_STALL_S", 30.0))
        _state.wire_stall_s = float(env("MXNET_HEALTH_WIRE_STALL_S", 30.0))
        _state.recovery_s = float(env("MXNET_HEALTH_RECOVERY_S", 5.0))
        _state.p99_ms = float(env("MXNET_HEALTH_P99_MS", 0.0))
        _state.overlap_floor = float(
            env("MXNET_HEALTH_OVERLAP_FLOOR", 0.0))
        _state.failover_budget_s = float(
            env("MXNET_HEALTH_FAILOVER_BUDGET_S", 0.0))
        _state.queue_sat = float(env("MXNET_HEALTH_QUEUE_SAT", 1.0))
        _state.busy_storm = int(env("MXNET_HEALTH_BUSY_STORM", 8))
        _state.busy_window_s = float(
            env("MXNET_HEALTH_BUSY_WINDOW_S", 1.0))
        _state.stale_s = float(env("MXNET_HEALTH_STALE_S", 30.0))
        ring = max(16, int(env("MXNET_HEALTH_EVENTS", 256)))
        if ring != _state.events.maxlen:
            _state.events = deque(_state.events, maxlen=ring)
        want_hooks = bool(_state.dir) and _state.on
        want_watchdog = _state.on and bool(_state.probes or _state.waits)
    return want_hooks, want_watchdog


def _arm():
    """Install the dump hooks at the first use of the recorder when a
    bundle directory was set before import."""
    if _state.dir and _state.on and not _state.hooks_installed:
        _install_hooks()


def enabled() -> bool:
    return _state.on


# ---------------------------------------------------------------------------
# The event ring (the flight recorder's memory)
# ---------------------------------------------------------------------------
def note(kind: str, mono: Optional[float] = None, **fields) -> None:
    """Record one typed health event into the bounded ring (and, when
    tracing is on, as a ``health.<kind>`` instant in the trace ring).
    ``mono`` overrides the monotonic stamp — injectable so the windowed
    rules (BUSY storms) are testable without sleeping.  Near-zero cost:
    two dict ops under the leaf lock."""
    if not _state.on:
        return
    _arm()
    rec = {"ts": time.time(),
           "mono": time.monotonic() if mono is None else float(mono),
           "kind": str(kind)}
    if fields:
        rec.update(fields)
    with _lock:
        _state.events.append(rec)
        _state.counts[rec["kind"]] = _state.counts.get(rec["kind"], 0) + 1
    # outside the leaf lock: tracing has its own lock
    tracing.instant("health.%s" % kind, cat="health",
                    args=fields or None)


def events() -> list:
    """The event ring, oldest first (the stats section's and the
    postmortem bundle's view)."""
    with _lock:
        return [dict(e) for e in _state.events]


def event_counts() -> Dict[str, int]:
    with _lock:
        return dict(_state.counts)


def trip_counts() -> Dict[str, int]:
    with _lock:
        return dict(_state.trips)


# ---------------------------------------------------------------------------
# Wait registry + watchdog (the stall detectors)
# ---------------------------------------------------------------------------
#: wait names the barrier-stall threshold governs; everything else
#: registered via wait_begin falls under the wire-stall threshold
_BARRIER_WAITS = ("kv.barrier", "srv.barrier_park")


def wait_begin(name: str) -> Optional[dict]:
    """Register a blocking wait ABOUT to start (barrier rendezvous, wire
    pull) so the watchdog can see it age while the caller is parked.
    Returns the token ``wait_end`` takes (None when health is off).
    Registering the first wait starts the monitor thread — a process
    that never blocks never pays for one."""
    if not _state.on:
        return None
    _arm()
    tok = {"name": str(name), "mono": time.monotonic(), "tripped": False}
    with _lock:
        _state.next_token += 1
        tok["id"] = _state.next_token
        _state.waits[tok["id"]] = tok
    _ensure_watchdog()
    return tok


def wait_end(tok: Optional[dict]) -> None:
    """Deregister a wait (None is a no-op).  A wait that TRIPPED while
    parked notes its recovery, so the ring shows stall → clear pairs."""
    if tok is None:
        return
    with _lock:
        _state.waits.pop(tok.get("id"), None)
        tripped = tok.get("tripped")
    if tripped:
        note("stall_cleared", name=tok["name"],
             stalled_s=round(time.monotonic() - tok["mono"], 3))


def register_probe(name: str, fn: Callable[[], dict]) -> None:
    """Register a gauge probe the watchdog samples every tick (the
    serving replica registers its batcher queue here).  ``fn`` must
    return a plain dict; ``{"queue_depth": d, "queue_limit": l}`` feeds
    the saturation detector.  Registered even with MXNET_HEALTH=0 — the
    switch gates EVALUATION, so a probe registered while health was off
    starts being sampled the moment a reconfigure() turns it back on
    (note()/status() have the same re-check-per-call symmetry)."""
    with _lock:
        _state.probes[str(name)] = fn
    if _state.on:
        _arm()
        _ensure_watchdog()


def unregister_probe(name: str) -> None:
    with _lock:
        _state.probes.pop(str(name), None)
        _state.probe_state.pop(str(name), None)


def note_progress(name: str) -> None:
    """Cheap liveness breadcrumb for long-running loops: the
    last-progress stamp rides the snapshot section so an operator can
    tell a stalled loop from a slow one."""
    if not _state.on:
        return
    with _lock:
        _state.progress[str(name)] = time.monotonic()


def note_channel_poison(uri: str) -> None:
    """A kvstore channel hard-failed (retries exhausted / IO-thread
    crash): CRITICAL while any poison is outstanding.  The elastic
    repair clears it (:func:`clear_channel_poison`) when the worker
    converges onto the surviving roster."""
    if not _state.on:
        return
    with _lock:
        _state.poisoned[str(uri)] = time.monotonic()
    note("channel_poison", uri=str(uri))
    dump("channel_poison")


def clear_channel_poison(uri: Optional[str] = None) -> None:
    """Clear one uri's poison (connection closed/replaced) or — with no
    argument — all of them (a successful elastic roster convergence
    rebuilt every connection)."""
    with _lock:
        if uri is None:
            cleared = bool(_state.poisoned)
            _state.poisoned.clear()
        else:
            cleared = _state.poisoned.pop(str(uri), None) is not None
    if cleared:
        note("poison_cleared", uri=str(uri) if uri else "all")


def _ensure_watchdog():
    with _lock:
        if _state.watchdog is not None and _state.watchdog.is_alive():
            return
        # create AND start under the lock: a created-but-unstarted
        # thread reports is_alive() False, so releasing between the
        # two let a concurrent caller seat a second monitor (start()
        # itself takes no application lock — safe to hold ours).  A
        # fresh healthy monitor also clears the sticky crash marker —
        # the crash stays on record as an event/count, but a replaced
        # watchdog must not degrade the node forever.
        t = threading.Thread(target=_watchdog_loop, daemon=True,
                             name="mxnet-health-watchdog")
        _state.watchdog = t
        _state.watchdog_err = None
        t.start()


def _watchdog_loop():
    """The monitor thread.  A crash parks as a sticky error surfaced in
    the snapshot section (and an event) — the watchdog's own death must
    be observable, never silent."""
    try:
        while True:
            time.sleep(_state.interval)
            if not _state.on:
                continue
            _watchdog_tick()
    except Exception as exc:  # noqa: BLE001 — sticky-error contract
        with _lock:
            _state.watchdog = None
            _state.watchdog_err = "%s: %s" % (type(exc).__name__, exc)
        note("watchdog_crash", error=_state.watchdog_err)


def _watchdog_tick(now: Optional[float] = None):
    now = time.monotonic() if now is None else now
    trips = []
    with _lock:
        for tok in list(_state.waits.values()):
            if tok["tripped"]:
                continue
            limit = (_state.barrier_stall_s
                     if tok["name"] in _BARRIER_WAITS
                     else _state.wire_stall_s)
            if limit > 0 and now - tok["mono"] > limit:
                tok["tripped"] = True
                kind = ("barrier_stall" if tok["name"] in _BARRIER_WAITS
                        else "wire_stall")
                _state.trips[kind] = _state.trips.get(kind, 0) + 1
                trips.append((kind, tok["name"],
                              round(now - tok["mono"], 3)))
        probes = list(_state.probes.items())
    for kind, name, age in trips:
        note("watchdog.%s" % kind, name=name, age_s=age)
        from . import profiler as _prof
        _prof.record_channel_event("health.%s" % kind)
        dump("watchdog_%s" % kind)
    # probes sampled OUTSIDE the leaf lock (a probe may take its own
    # subsystem lock — the batcher condition)
    for name, fn in probes:
        try:
            sample = dict(fn() or {})
        except Exception as exc:  # noqa: BLE001 — a broken probe is an event
            sample = {"error": "%s: %s" % (type(exc).__name__, exc)}
        sample["mono"] = now
        depth = sample.get("queue_depth")
        limit = sample.get("queue_limit")
        saturated = bool(
            isinstance(depth, (int, float))
            and isinstance(limit, (int, float)) and limit > 0
            and depth >= _state.queue_sat * limit)
        with _lock:
            was = _state.probe_state.get(name, {}).get("saturated", False)
            sample["saturated"] = saturated
            _state.probe_state[name] = sample
            if saturated and not was:
                _state.trips["queue_saturated"] = \
                    _state.trips.get("queue_saturated", 0) + 1
        if saturated and not was:
            note("watchdog.queue_saturated", probe=name, **{
                k: v for k, v in sample.items()
                if k in ("queue_depth", "queue_limit")})
            from . import profiler as _prof
            _prof.record_channel_event("health.queue_saturated")
            dump("watchdog_queue_saturated")
    # dead-node sampling (heartbeat silence): the dist registry in this
    # process — edge-noted, level-contributes to status()
    dead = _dead_nodes()
    with _lock:
        was = _state.probe_state.get("_dead", {}).get("count", 0)
        _state.probe_state["_dead"] = {"count": dead, "mono": now}
    if dead > was:
        note("watchdog.dead_node", count=dead)
        from . import profiler as _prof
        _prof.record_channel_event("health.dead_node")
    # refresh worst/hysteresis once per tick
    status(now=now)


def _dead_nodes() -> int:
    """Nodes the heartbeat roster counts dead
    (``distributed.num_dead_nodes``; JAX package ``health.py:394-400``)."""
    try:
        from . import distributed as _dist
        return int(_dist.num_dead_nodes())
    except Exception:  # noqa: BLE001 — a broken source is not a death
        return 0


# ---------------------------------------------------------------------------
# SLO rule engine
# ---------------------------------------------------------------------------
def _slo_rules(snap: Optional[dict] = None) -> List[dict]:
    """Evaluate the declarative threshold rules against a profiler
    snapshot (this process's when None).  Pure over its input: the same
    rules run locally and over beat-piggybacked PEER stats on the
    coordinator (:func:`evaluate`).  Each verdict:
    ``{rule, ok, value, threshold, severity}`` — disabled rules (zero
    threshold) are omitted."""
    out = []
    if not (_state.overlap_floor > 0 or _state.p99_ms > 0
            or _state.failover_budget_s > 0):
        return out   # every rule disabled (the default): no snapshot work
    if snap is None:
        # NEVER profiler.snapshot() here: snapshot() embeds the health
        # section, whose status() evaluates these very rules — the peek
        # reads only the counter families the rules consume
        snap = _peek_snapshot()
    wire = snap.get("wire") or {}
    if _state.overlap_floor > 0 and int(wire.get("rounds", 0)) >= 4:
        v = float(wire.get("overlap_pct", 0.0))
        out.append({"rule": "overlap_floor", "ok": v >= _state.overlap_floor,
                    "value": round(v, 1),
                    "threshold": _state.overlap_floor,
                    "severity": DEGRADED})
    if _state.p99_ms > 0:
        lat = (snap.get("latency") or {}).get("serving.request")
        if lat:
            v = float(lat.get("p99_ms", 0.0))
            out.append({"rule": "p99_ms", "ok": v <= _state.p99_ms,
                        "value": round(v, 3), "threshold": _state.p99_ms,
                        "severity": DEGRADED})
    if _state.failover_budget_s > 0:
        chan = snap.get("channel") or {}
        v = chan.get("kvstore.failover_rebuild_s")
        if isinstance(v, (int, float)):
            out.append({"rule": "failover_budget_s",
                        "ok": float(v) <= _state.failover_budget_s,
                        "value": round(float(v), 3),
                        "threshold": _state.failover_budget_s,
                        "severity": DEGRADED})
    return out


def evaluate(snap: dict) -> tuple:
    """Apply the SLO rules to an arbitrary snapshot dict — a peer's
    beat-piggybacked compact stats on the coordinator, a banked dead
    member's last-known counters in a sweep.  Returns
    ``(status, failed_rules)``; a snapshot that carries its own
    self-reported ``health.status`` contributes that as a floor (the
    peer knows its waits and events; the numeric rules still apply)."""
    failed = [r for r in _slo_rules(snap) if not r["ok"]]
    sev = OK
    for r in failed:
        if _SEV[r["severity"]] > _SEV[sev]:
            sev = r["severity"]
    own = ((snap.get("health") or {}).get("status")
           if isinstance(snap.get("health"), dict) else None)
    if own in _SEV and _SEV[own] > _SEV[sev]:
        sev = own
    return sev, failed


def verdict_age_s(block, now: Optional[float] = None):
    """Seconds since a (possibly remote) ``health`` block's verdict was
    produced, from the wall-clock ``ts`` stamp every
    :func:`snapshot_section` carries.  None when the block has no stamp
    (a pre-stamp peer, or health disabled on its side) — absence of
    evidence is not staleness evidence."""
    if not isinstance(block, dict):
        return None
    ts = block.get("ts")
    if not isinstance(ts, (int, float)):
        return None
    now = time.time() if now is None else float(now)
    return max(0.0, now - float(ts))


def discount_stale(status_: str, age_s, stale_s: Optional[float] = None
                   ) -> str:
    """Fold verdict staleness into a REMOTE status: an ``OK`` older
    than the staleness horizon (``MXNET_HEALTH_STALE_S``) floors at
    DEGRADED — a silent replica's last word is forensics, not a live
    all-clear.  Worse-than-OK verdicts pass through unchanged (stale
    bad news is still news), as does an unknown age."""
    stale = _state.stale_s if stale_s is None else float(stale_s)
    if (status_ == OK and stale > 0 and age_s is not None
            and float(age_s) > stale):
        return DEGRADED
    return status_


def _raw_conditions(now: float) -> tuple:
    """(severity, active condition names, SLO rule verdicts) from live
    local state — tripped in-flight waits, outstanding channel poison,
    dead nodes, queue saturation, BUSY storms, failed SLO rules.  The
    rule verdicts ride back so snapshot_section reports the SAME
    evaluation its status came from (re-evaluating could disagree
    across the two instants, and doubles the peek cost)."""
    active = []
    sev = OK

    def bump(level, name):
        nonlocal sev, active
        active.append(name)
        if _SEV[level] > _SEV[sev]:
            sev = level

    with _lock:
        tripped = [t["name"] for t in _state.waits.values()
                   if t["tripped"]]
        poisoned = list(_state.poisoned)
        dead = _state.probe_state.get("_dead", {}).get("count", 0)
        saturated = [n for n, s in _state.probe_state.items()
                     if not n.startswith("_") and s.get("saturated")]
        sheds = sum(1 for e in _state.events
                    if e["kind"] == "busy_shed"
                    and now - e["mono"] <= _state.busy_window_s)
        wd_err = _state.watchdog_err
    for name in tripped:
        bump(DEGRADED, "stalled_wait:%s" % name)
    for uri in poisoned:
        bump(CRITICAL, "channel_poison:%s" % uri)
    if dead:
        bump(DEGRADED, "dead_nodes:%d" % dead)
    for name in saturated:
        bump(DEGRADED, "queue_saturated:%s" % name)
    if _state.busy_storm > 0 and sheds >= _state.busy_storm:
        bump(DEGRADED, "busy_storm:%d" % sheds)
    if wd_err:
        bump(DEGRADED, "watchdog_crashed")
    rules = _slo_rules()
    for r in rules:
        if not r["ok"]:
            bump(r["severity"], "slo:%s" % r["rule"])
    return sev, active, rules


def _apply_hysteresis(sev: str, now: float) -> str:
    """Fold the recovery window into a raw severity and track the
    worst-ever (caller computed ``sev`` via :func:`_raw_conditions`)."""
    with _lock:
        if sev != OK:
            _state.last_bad = now
        elif _state.last_bad is not None \
                and now - _state.last_bad < _state.recovery_s:
            sev = DEGRADED
        if _SEV[sev] > _SEV[_state.worst]:
            _state.worst = sev
    return sev


def status(now: Optional[float] = None) -> str:
    """This process's health status with recovery hysteresis: raw
    conditions decide CRITICAL/DEGRADED; once every condition clears the
    status stays DEGRADED for ``MXNET_HEALTH_RECOVERY_S`` more seconds
    before reporting OK — a flapping condition reads as one continuous
    degradation, never as per-tick oscillation."""
    if not _state.on:
        return OK
    now = time.monotonic() if now is None else float(now)
    sev, _active, _rules = _raw_conditions(now)
    return _apply_hysteresis(sev, now)


def snapshot_section(compact: bool = False) -> dict:
    """The ``health`` block of ``profiler.snapshot()`` — compact (what
    beats piggyback: status + trip/event counters) or full (plus active
    conditions, rule verdicts, probe samples, recent events and the
    bundle path)."""
    if not _state.on:
        return {"status": OK, "enabled": False}
    now = time.monotonic()
    # ONE conditions pass feeds the status, the active list AND the
    # reported rule verdicts — re-evaluating would double the hot-path
    # cost of every beat and could disagree with the status it sits
    # next to
    sev, active, rules = _raw_conditions(now)
    st = _apply_hysteresis(sev, now)
    with _lock:
        out = {"status": st,
               "worst": _state.worst,
               # wall-clock stamp of THIS verdict: a consumer reading
               # the block later (beat-banked snapshot, fleet
               # scoreboard) derives age_s = now - ts and discounts a
               # stale OK (verdict_age_s / discount_stale) instead of
               # trusting the last word of a corpse
               "ts": round(time.time(), 3),
               "trips": dict(_state.trips),
               "event_counts": dict(_state.counts)}
    if compact:
        return out
    with _lock:
        out.update({
            "active": active,
            "rules": rules,
            "probes": {n: {k: v for k, v in s.items() if k != "mono"}
                       for n, s in _state.probe_state.items()
                       if not n.startswith("_")},
            "progress_age_s": {n: round(now - t, 3)
                               for n, t in _state.progress.items()},
            "events": [dict(e) for e in list(_state.events)[-32:]],
            "watchdog_error": _state.watchdog_err,
            "bundle": _state.path,
        })
    return out


def _peek_snapshot():
    """The counter families the SLO rules read, WITHOUT the health
    section (snapshot() calls back into snapshot_section — this breaks
    the recursion)."""
    from . import profiler as _prof
    return {
        "wire": {"rounds": _prof.wire_rounds(),
                 "overlap_pct": _prof.wire_overlap_pct()},
        "channel": _prof.channel_counts(),
        "latency": {k: _prof.latency_stats(k)
                    for k in _prof.latency_kinds()},
    }


def summary() -> dict:
    """The end-of-run digest bench.py banks next to wire_bytes_per_step:
    current + worst status and the watchdog trip counters — an unhealthy
    run is visible in BENCH_LOG.jsonl, not just slow."""
    st = status()
    with _lock:
        return {"status": st, "worst": _state.worst,
                "watchdog_trips": dict(_state.trips)}


def reset() -> None:
    """Clear the recorder (tests): events, counters, waits, probes,
    poison, hysteresis.  Files already dumped stay — they are evidence."""
    with _lock:
        _state.events.clear()
        _state.counts.clear()
        _state.trips.clear()
        _state.waits.clear()
        _state.probes.clear()
        _state.probe_state.clear()
        _state.progress.clear()
        _state.poisoned.clear()
        _state.last_bad = None
        _state.worst = OK
        _state.watchdog_err = None
        _state.dump_reasons = []


# ---------------------------------------------------------------------------
# The flight-recorder bundle (black-box crash forensics)
# ---------------------------------------------------------------------------
_ENV_PREFIXES = ("MXNET_", "DMLC_", "MXT_", "BENCH_", "JAX_")


def _env_fingerprint() -> Dict[str, str]:
    """Every knob-shaped env var actually SET in this process — the
    configuration half of a postmortem (which window/compression/elastic
    settings the dead job ran under, and the launcher topology
    DMLC_NUM_WORKER/MXT_SERVER_URIS the report derives the expected
    process set from)."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(_ENV_PREFIXES)}


def bundle(reason: str, exc: Optional[BaseException] = None) -> dict:
    """Build (without writing) the crash bundle: identity, reason
    history, env fingerprint, counter families, roster generation,
    recent health events, and — when tracing is on — summaries of the
    newest ring spans.  Everything is plain builtins (json-ready)."""
    from . import profiler as _prof
    with _lock:
        reasons = list(_state.dump_reasons)
        evs = [dict(e) for e in _state.events]
        trips = dict(_state.trips)
    out = {
        "schema": 1,
        "reason": str(reason),
        "reasons": reasons + [str(reason)],
        "ts": time.time(),
        "mono": time.monotonic(),
        "pid": os.getpid(),
        "role": _state.role,
        "rank": _state.rank,
        "status": status(),
        "trips": trips,
        "events": evs,
        "env": _env_fingerprint(),
        "counters": {
            "channel": _prof.channel_counts(),
            "channel_bytes": _prof.channel_bytes(),
            "dispatch": _prof.dispatch_counts(),
        },
        "roster_generation": _prof.channel_counts().get(
            "kvstore.roster_generation", 0),
    }
    if exc is not None:
        import traceback
        out["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__),
        }
    spans = tracing.ring_records()
    if spans:
        out["recent_spans"] = [
            {"name": s.get("name"), "cat": s.get("cat"),
             "ts": s.get("ts"), "dur": s.get("dur")}
            for s in spans[-64:]]
    return out


def dump(reason: str, exc: Optional[BaseException] = None
         ) -> Optional[str]:
    """Write the bundle to ``MXNET_HEALTH_DIR/<role>-<rank>.crash.json``
    — tmp-file + fsync + atomic ``os.replace``, so a reader never sees a
    torn bundle and a re-dump (crash, then atexit) REPLACES the file
    with a strictly richer one (the reason history accumulates).
    Returns the path, or None when no dir is configured (the ring is
    still the in-memory black box).  Never raises: forensics must not
    take the job down."""
    if not _state.on or _state.path is None:
        return None
    _arm()
    try:
        data = bundle(reason, exc=exc)
        d = os.path.dirname(_state.path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = "%s.tmp.%d" % (_state.path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(data, f, sort_keys=True, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, _state.path)
        with _lock:
            _state.dump_reasons.append(str(reason))
        return _state.path
    except Exception:  # noqa: BLE001 — forensics must never crash the job
        return None


def _excepthook(exc_type, exc, tb):
    """sys.excepthook chain: dump the bundle, then defer to whatever
    hook was installed before (usually the default printer)."""
    try:
        if exc is not None and exc.__traceback__ is None:
            exc.__traceback__ = tb
        dump("crash", exc=exc)
    finally:
        if _prev_excepthook is not None:
            _prev_excepthook(exc_type, exc, tb)


def _threading_hook(args):
    """threading.excepthook chain: an unhandled crash on ANY thread is
    bundle-worthy (the sticky-error pattern parks expected failures;
    this catches the unexpected ones)."""
    try:
        dump("thread_crash", exc=args.exc_value)
    finally:
        if _prev_threading_hook is not None:
            _prev_threading_hook(args)


def _sigterm_handler(signum, frame):
    """SIGTERM (planned preemption / launcher teardown): dump, restore
    the default disposition and re-deliver so exit semantics are
    unchanged.  The dump runs on a HELPER thread with a bounded join:
    a signal handler runs on the interrupted main-thread stack, so
    dumping inline would deadlock on any non-reentrant lock the
    interrupted frame already holds (health's own leaf lock, a profiler
    counter lock).  Off-thread, the common case completes instantly;
    the pathological case (main thread interrupted inside one of those
    critical sections) times out after 2 s and the process still dies
    with default SIGTERM semantics — a missing bundle, never a hang."""
    import signal
    t = threading.Thread(target=_sigterm_dump, daemon=True)
    t.start()
    t.join(timeout=2.0)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _sigterm_dump():
    try:
        dump("sigterm")
        tracing.flush()
    except Exception:  # noqa: BLE001 — dying anyway: the bundle is
        # best-effort and the joiner re-delivers SIGTERM regardless
        pass


def _atexit_dump():
    dump("exit")


def _install_hooks():
    global _prev_excepthook, _prev_threading_hook
    with _lock:
        if _state.hooks_installed:
            return
        _state.hooks_installed = True
    import atexit
    import sys
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _threading_hook
    atexit.register(_atexit_dump)
    try:
        import signal
        if threading.current_thread() is threading.main_thread() \
                and signal.getsignal(signal.SIGTERM) == signal.SIG_DFL:
            signal.signal(signal.SIGTERM, _sigterm_handler)
    except (ValueError, OSError):
        pass   # not the main thread / restricted env: bundles still
        #        flow from the other triggers


_read_config()
