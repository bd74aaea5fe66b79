"""Profiler: chrome://tracing host events, the device trace, counters.

PyTorch counterpart of ``mxnet_tpu/profiler.py`` (reference:
src/engine/profiler.h:79 OprExecStat; python/mxnet/profiler.py:27-55
set_config / set_state / dump_profile).  Three layers:

* **host events**: the dispatch sites (``Executor.forward`` /
  ``backward``, ``Module.forward`` / ``backward`` / ``update``, the
  eager ``_invoke`` in mode ``all``, the serving predictor) record
  {name, start us, dur us} while the profiler runs, and
  ``dump_profile()`` writes them in chrome://tracing format.
* **device truth**: ``profiler_set_config(xla_logdir=...)`` or
  ``MXNET_PROFILER_XLA_LOGDIR`` (the JAX package's names, so scripts
  run unchanged) makes ``set_state('run')`` / ``set_state('stop')``
  also drive ``torch.profiler`` with CUDA activity; at stop its chrome
  trace is written into that directory (``device_trace_files()``).
* **counters**: dispatch, host-sync, channel, byte, serialization,
  wire, mesh fan-in and latency families, all in one ``snapshot()``
  (``python -m mxnet_tpu_torch.profiler --dump``).  The distributed
  kvstore feeds the wire, channel, allgather and serialization
  families; the mesh (``ici_*``, ``shm_*``) and fan-in families stay
  zero until the hierarchical tier (ROADMAP E2) and multi-GPU (D1)
  feed them; their keys are there already, so consumers do not drift.

``MXNET_PROFILER_AUTOSTART=1`` begins profiling at import (reference:
src/engine/profiler.cc autostart); without it importing starts nothing.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional

from .base import MXNetError, env
from . import tracing
from . import health as _health

PROFILER_STATE_STOP = 0
PROFILER_STATE_RUN = 1

_MODE_SYMBOLIC = "symbolic"
_MODE_ALL = "all"


class _Profiler:
    def __init__(self):
        self.state = PROFILER_STATE_STOP
        # reference env parity: MXNET_PROFILER_MODE=all widens capture
        # beyond dispatch events; any other value (incl. the reference
        # spelling "symbolic_only") is the symbolic default.
        # profiler_set_config overrides at runtime.
        self.mode = _MODE_ALL \
            if env("MXNET_PROFILER_MODE", "symbolic_only") == _MODE_ALL \
            else _MODE_SYMBOLIC
        self.filename = "profile.json"
        self.continuous_dump = False
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._xla_logdir: Optional[str] = None
        self._xla_running = False
        # the device trace (torch.profiler) of set_state run/stop
        self._device_prof = None
        self._device_logdir = None
        self._device_seq = 0
        self._device_files: List[str] = []

    # -- event capture -----------------------------------------------------
    def record(self, name, start_us, dur_us, category="operator",
               tid=None):
        if self.state != PROFILER_STATE_RUN:
            return
        with self._lock:
            self._events.append({
                "name": name, "cat": category, "ph": "X",
                "ts": start_us, "dur": dur_us,
                "pid": os.getpid(),
                "tid": tid if tid is not None else
                threading.get_ident() % 100000,
            })

    def scope(self, name, category="operator"):
        return _Scope(self, name, category)

    # -- lifecycle ---------------------------------------------------------
    def set_state(self, state):
        if state == PROFILER_STATE_RUN and \
                self.state != PROFILER_STATE_RUN:
            self._maybe_start_xla()
        if state == PROFILER_STATE_STOP and \
                self.state == PROFILER_STATE_RUN:
            self._maybe_stop_xla()
            if self.continuous_dump:
                self.state = state
                self.dump()
        self.state = state

    def _maybe_start_xla(self):
        logdir = self._xla_logdir or env("MXNET_PROFILER_XLA_LOGDIR", None)
        if logdir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            self._device_prof = prof
            self._device_logdir = logdir
            self._xla_running = True

    def _maybe_stop_xla(self):
        if self._xla_running:
            prof, self._xla_running = self._device_prof, False
            prof.stop()
            os.makedirs(self._device_logdir, exist_ok=True)
            self._device_seq += 1
            path = os.path.join(self._device_logdir, "device-%d-%d.trace.json"
                                % (os.getpid(), self._device_seq))
            prof.export_chrome_trace(path)
            self._device_files.append(path)
            self._device_prof = None

    def dump(self, finished=True):
        with self._lock:
            events = list(self._events)
            if finished:
                self._events = []
        with open(self.filename, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


class _Scope:
    __slots__ = ("_p", "_name", "_cat", "_t0")

    def __init__(self, p, name, cat):
        self._p = p
        self._name = name
        self._cat = cat

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *a):
        if self._p.state == PROFILER_STATE_RUN:
            t1 = time.perf_counter_ns()
            self._p.record(self._name, self._t0 // 1000,
                           (t1 - self._t0) // 1000, self._cat)


_profiler = _Profiler()


def profiler_set_config(mode="symbolic", filename="profile.json",
                        continuous_dump=False, xla_logdir=None, **kwargs):
    """reference: profiler.py:27 profiler_set_config / MXSetProfilerConfig.

    ``xla_logdir``: directory for the device trace (torch.profiler with
    CUDA activity) that start/stop also drives, the public form of
    ``MXNET_PROFILER_XLA_LOGDIR`` (the JAX package's names).  None
    leaves the current setting; the empty string "" clears it (device
    capture off).
    """
    if mode not in (_MODE_SYMBOLIC, _MODE_ALL):
        raise MXNetError(f"invalid profiler mode {mode!r}")
    if kwargs:
        import warnings
        warnings.warn("profiler_set_config: ignoring unknown options %r"
                      % sorted(kwargs), stacklevel=2)
    _profiler.mode = mode
    _profiler.filename = filename
    _profiler.continuous_dump = continuous_dump
    if xla_logdir is not None:
        _profiler._xla_logdir = xla_logdir or None  # "" clears


set_config = profiler_set_config


def profiler_set_state(state="stop"):
    """reference: profiler.py:40 / MXSetProfilerState."""
    s = {"stop": PROFILER_STATE_STOP, "run": PROFILER_STATE_RUN}
    if state not in s:
        raise MXNetError(f"invalid profiler state {state!r}")
    _profiler.set_state(s[state])


set_state = profiler_set_state


def dump_profile():
    """reference: profiler.py:52 dump_profile / MXDumpProfile."""
    _profiler.dump()


dump = dump_profile


def is_running():
    return _profiler.state == PROFILER_STATE_RUN


def record_event(name, start_us, dur_us, category="operator"):
    _profiler.record(name, start_us, dur_us, category)


def device_trace_files() -> List[str]:
    """The chrome-trace files the device windows wrote, oldest first."""
    return list(_profiler._device_files)


# -- span tracing (tracing.py) ------------------------------------------------
# The profiler's cross-process face: span_begin/span_end with a
# thread-local current span, monotonic clocks, a bounded ring and the
# MXNET_TRACE master switch all live in tracing.py, re-exported
# here so instrumentation sites (and the reference-shaped public
# surface) reach them as profiler.span_begin(...) without a second
# import.
span = tracing.span
span_begin = tracing.span_begin
span_end = tracing.span_end
trace_instant = tracing.instant
trace_enabled = tracing.enabled


# -- host-dispatch counters --------------------------------------------------
# One counter a dispatch kind (executor.forward, module.update, ...): the
# tests and the card script hold the training loops' dispatch contracts
# against these by exact counts.
_dispatch_counts: dict = {}
_dispatch_lock = threading.Lock()


def record_dispatch(kind: str):
    """Count one host-side dispatch event of ``kind`` (always on — a
    dict increment is noise next to the device round-trip it marks)."""
    with _dispatch_lock:
        _dispatch_counts[kind] = _dispatch_counts.get(kind, 0) + 1


def dispatch_counts() -> dict:
    with _dispatch_lock:
        return dict(_dispatch_counts)


def reset_dispatch_counts():
    with _dispatch_lock:
        _dispatch_counts.clear()


# -- host-sync counters ------------------------------------------------------
# One counter a host-blocking readback site (asnumpy, metric.sync,
# predict.readback, ...), apart from the dispatch counters: a dispatch
# launches device work asynchronously, a sync blocks the host on it.
_host_sync_counts: dict = {}
_host_sync_lock = threading.Lock()


def record_host_sync(kind: str):
    """Count one host-blocking device readback of ``kind`` (always on —
    a dict increment is noise next to the device round-trip it marks)."""
    with _host_sync_lock:
        _host_sync_counts[kind] = _host_sync_counts.get(kind, 0) + 1


def host_syncs() -> dict:
    with _host_sync_lock:
        return dict(_host_sync_counts)


def host_sync_total() -> int:
    """Total host syncs across all sites (the gate's one number)."""
    with _host_sync_lock:
        return sum(_host_sync_counts.values())


def reset_host_syncs():
    with _host_sync_lock:
        _host_sync_counts.clear()


# -- kvstore channel counters ------------------------------------------------
# One counter a transport or serving event (the distributed kvstore's
# retries, replays and heartbeats, serving.busy_shed, health.*), apart
# from the dispatch counters, which tests hold by exact equality.
_channel_counts: dict = {}
_channel_lock = threading.Lock()


def record_channel_event(kind: str):
    """Count one kvstore transport event of ``kind`` (always on — a dict
    increment is noise next to the socket round-trip it marks)."""
    with _channel_lock:
        _channel_counts[kind] = _channel_counts.get(kind, 0) + 1


def record_channel_count(kind: str, n: int):
    """Add ``n`` to the transport counter ``kind`` — the bulk form of
    :func:`record_channel_event` for per-row accounting (e.g.
    ``kvstore.sparse_rows``: one sparse push moves thousands of rows;
    counting them one event at a time would put a lock round-trip per
    row on the push path).  Lives in _channel_counts, NOT the byte
    counters, so row counts never pollute wire_bytes_total."""
    with _channel_lock:
        _channel_counts[kind] = _channel_counts.get(kind, 0) + int(n)


def record_channel_gauge(kind: str, value):
    """SET a transport gauge (last-value, not a count): the elastic
    roster generation is the canonical one — ``kvstore.roster_generation``
    must read as "which membership epoch am I on", where an increment
    per observer would be meaningless."""
    with _channel_lock:
        _channel_counts[kind] = value


def channel_counts() -> dict:
    with _channel_lock:
        return dict(_channel_counts)


def reset_channel_counts():
    with _channel_lock:
        _channel_counts.clear()


def fleet_route_counts() -> dict:
    """Per-replica routing counters for a serving fleet: {uri: attempts
    routed there}, stripped of the ``fleet.route:`` prefix.  The chaos
    gate asserts on a DELTA of this map — after a kill/blackhole, the
    dead replicas' counts must stop moving while the survivors' climb."""
    with _channel_lock:
        return {k[len("fleet.route:"):]: v
                for k, v in _channel_counts.items()
                if k.startswith("fleet.route:")}


# -- kvstore channel byte counters -------------------------------------------
# Bytes moved a transport direction ("sent" / "recv" on the kvstore wire;
# "allgather" for the gloo group's host collectives).
_channel_bytes: dict = {}


def record_channel_bytes(kind: str, n: int):
    """Add ``n`` bytes to the transport byte counter ``kind`` (always on
    — two dict ops are noise next to the socket write they measure)."""
    with _channel_lock:
        _channel_bytes[kind] = _channel_bytes.get(kind, 0) + int(n)


def channel_bytes() -> dict:
    with _channel_lock:
        return dict(_channel_bytes)


# The in-host mesh tier's traffic counts under "ici_*" kinds, a family of
# its own beside the wire (ROADMAP D1 / E2 feed it).
ICI_BYTE_PREFIX = "ici_"

# Control-plane traffic (heartbeats, roster beats, codec hellos) counts
# under "control" / "control_recv", so the wire totals measure data only.
CONTROL_BYTE_PREFIX = "control"


def is_control_byte_kind(kind: str) -> bool:
    """True for control-plane byte kinds on either transport."""
    return (kind.startswith(CONTROL_BYTE_PREFIX)
            or kind.startswith(ICI_BYTE_PREFIX + CONTROL_BYTE_PREFIX))


# Same-host shared-memory lane traffic counts under "shm_sent" /
# "shm_recv", a fourth family (the hierarchical tier's lane, ROADMAP E2).
SHM_BYTE_PREFIX = "shm_"


def ici_bytes_total() -> int:
    """Total in-mesh (hierarchy-tier) bytes moved over SOCKETS so far;
    the shm lane's share counts under shm_bytes_total."""
    with _channel_lock:
        return sum(v for k, v in _channel_bytes.items()
                   if k.startswith(ICI_BYTE_PREFIX))


def ici_payload_bytes_total() -> int:
    """The mesh sockets' DATA share: ici_* minus ici_control* — with
    the shm lane active this is ≈0 (payload rides the ring), which is
    exactly what the CI shm gate pins."""
    with _channel_lock:
        return sum(v for k, v in _channel_bytes.items()
                   if k.startswith(ICI_BYTE_PREFIX)
                   and not k.startswith(ICI_BYTE_PREFIX
                                        + CONTROL_BYTE_PREFIX))


def shm_bytes_total() -> int:
    """Total same-host shared-memory lane bytes moved so far (both
    directions; zero socket syscalls behind any of them)."""
    with _channel_lock:
        return sum(v for k, v in _channel_bytes.items()
                   if k.startswith(SHM_BYTE_PREFIX))


def wire_bytes_total() -> int:
    """Total non-mesh DATA bytes (TCP wire + host collectives);
    control-plane traffic is excluded so the banked per-step number
    measures gradients, not heartbeat cadence — and the in-host
    families (ici_*, shm_*) are excluded so it measures the WIRE."""
    with _channel_lock:
        return sum(v for k, v in _channel_bytes.items()
                   if not k.startswith(ICI_BYTE_PREFIX)
                   and not k.startswith(CONTROL_BYTE_PREFIX)
                   and not k.startswith(SHM_BYTE_PREFIX))


def control_bytes_total() -> int:
    """Total wire-side control-plane bytes (heartbeats, roster beats,
    codec hellos); mesh-side control counts into ici_bytes_total."""
    with _channel_lock:
        return sum(v for k, v in _channel_bytes.items()
                   if k.startswith(CONTROL_BYTE_PREFIX))


def reset_channel_bytes():
    with _channel_lock:
        _channel_bytes.clear()


# -- kvstore serialization counters -------------------------------------------
# What the frame layer costs: codec_bytes, pickle_bytes, send_syscalls
# (the distributed kvstore's frames); a dict of its own, apart from the channel
# counters that tests hold by exact equality.
_serialization: dict = {}
_serialization_lock = threading.Lock()


def record_serialization(kind: str, n: int):
    """Add ``n`` to the serialization counter ``kind`` (always on — a
    dict increment is noise next to the encode it measures)."""
    with _serialization_lock:
        _serialization[kind] = _serialization.get(kind, 0) + int(n)


def serialization_counts() -> dict:
    with _serialization_lock:
        return dict(_serialization)


def codec_bytes_total() -> int:
    """Descriptor bytes emitted by the binary wire codec so far."""
    with _serialization_lock:
        return _serialization.get("codec_bytes", 0)


def pickle_bytes_total() -> int:
    """Skeleton bytes pickled by the legacy frame path so far — the
    steady-state acceptance pin is 0 with the codec negotiated on."""
    with _serialization_lock:
        return _serialization.get("pickle_bytes", 0)


def send_syscalls_total() -> int:
    """Socket write syscalls issued by the frame layer so far."""
    with _serialization_lock:
        return _serialization.get("send_syscalls", 0)


def reset_serialization():
    with _serialization_lock:
        _serialization.clear()


# -- kvstore wire-overlap counters --------------------------------------------
# Two clocks of the distributed loop's wire (pull handles): wire_wait, the
# host time blocked on a pull, and wire_round, each round's whole
# enqueue-to-resolved time; overlap_pct = 100 (1 - wait / round).
_wire_lock = threading.Lock()
_wire = {"wait_s": 0.0, "round_s": 0.0, "rounds": 0}


def record_wire_wait(dur_s: float):
    """Add host-blocked seconds spent waiting on an in-flight kvstore
    pull (the exposed wire).  Also emitted as a chrome-trace event
    (category "wire") when the profiler is running, so a single-process
    trace shows the wire stall next to the dispatches it blocked —
    these clocks used to feed only the counters and never reached the
    trace export."""
    with _wire_lock:
        _wire["wait_s"] += float(dur_s)
    if _profiler.state == PROFILER_STATE_RUN:
        dur_us = float(dur_s) * 1e6
        _profiler.record("kvstore.wire_wait",
                         time.perf_counter_ns() // 1000 - int(dur_us),
                         dur_us, "wire")


def record_wire_round(dur_s: float):
    """Add one completed wire round's full enqueue->resolved seconds
    (chrome-trace event "wire" category when the profiler runs — see
    record_wire_wait)."""
    with _wire_lock:
        _wire["round_s"] += float(dur_s)
        _wire["rounds"] += 1
    if _profiler.state == PROFILER_STATE_RUN:
        dur_us = float(dur_s) * 1e6
        _profiler.record("kvstore.wire_round",
                         time.perf_counter_ns() // 1000 - int(dur_us),
                         dur_us, "wire")


def wire_wait_ms() -> float:
    with _wire_lock:
        return _wire["wait_s"] * 1e3


def wire_round_ms() -> float:
    with _wire_lock:
        return _wire["round_s"] * 1e3


def wire_rounds() -> int:
    with _wire_lock:
        return _wire["rounds"]


def wire_overlap_pct() -> float:
    """Fraction of the wire hidden behind compute, as a percentage:
    100*(1 - wait/round) over every recorded round, 0.0 before the
    first round (and never negative — scheduling jitter can make a
    single wait marginally exceed its round)."""
    with _wire_lock:
        if _wire["rounds"] == 0 or _wire["round_s"] <= 0.0:
            return 0.0
        return max(0.0, 100.0 * (1.0 - _wire["wait_s"] / _wire["round_s"]))


def reset_wire_counters():
    with _wire_lock:
        _wire["wait_s"] = 0.0
        _wire["round_s"] = 0.0
        _wire["rounds"] = 0


# -- mesh fan-in clock --------------------------------------------------------
# Host time a hierarchy-tier leader spends waiting for its followers'
# rounds (ROADMAP D1 / E2).
_fanin_lock = threading.Lock()
_fanin = {"wait_s": 0.0, "rounds": 0}


def record_mesh_fanin_wait(dur_s: float):
    """Add one collect_push round's blocked seconds (chrome-trace event
    "wire" category when the profiler runs, like the wire clocks)."""
    with _fanin_lock:
        _fanin["wait_s"] += float(dur_s)
        _fanin["rounds"] += 1
    if _profiler.state == PROFILER_STATE_RUN:
        dur_us = float(dur_s) * 1e6
        _profiler.record("kvstore.mesh_fanin",
                         time.perf_counter_ns() // 1000 - int(dur_us),
                         dur_us, "wire")


def mesh_fanin_wait_ms() -> float:
    with _fanin_lock:
        return _fanin["wait_s"] * 1e3


def mesh_fanin_rounds() -> int:
    with _fanin_lock:
        return _fanin["rounds"]


def reset_mesh_fanin():
    with _fanin_lock:
        _fanin["wait_s"] = 0.0
        _fanin["rounds"] = 0


# -- serving latency / QPS counters ------------------------------------------
# Request-latency distributions of the serving tier (serving/): a bounded
# ring of durations and completion times a kind (serving.request,
# serving.batch), sized by MXNET_SERVING_LATENCY_WINDOW.
_latency_lock = threading.Lock()
_latency: dict = {}   # kind -> {"durs": deque, "ts": deque, "count", "total"}


def _latency_window() -> int:
    return max(2, int(env("MXNET_SERVING_LATENCY_WINDOW", 2048)))


def record_latency(kind: str, dur_s: float, ts: Optional[float] = None):
    """Record one completed request of ``kind`` taking ``dur_s`` seconds.
    ``ts`` is the completion time (``time.monotonic()`` when omitted —
    injectable so the QPS arithmetic is testable without sleeping)."""
    if ts is None:
        ts = time.monotonic()
    if _profiler.state == PROFILER_STATE_RUN:
        # latency samples used to live only in the percentile ring and
        # never reached the chrome-trace export; emit each completed
        # request as a trace event so a single-process serving trace
        # shows queue-wait + forward time per request
        dur_us = float(dur_s) * 1e6
        _profiler.record(kind,
                         time.perf_counter_ns() // 1000 - int(dur_us),
                         dur_us, "latency")
    with _latency_lock:
        st = _latency.get(kind)
        if st is None:
            from collections import deque
            w = _latency_window()
            st = _latency[kind] = {"durs": deque(maxlen=w),
                                   "ts": deque(maxlen=w),
                                   "count": 0, "total": 0.0}
        st["durs"].append(float(dur_s))
        st["ts"].append(float(ts))
        st["count"] += 1
        st["total"] += float(dur_s)


def percentile(samples, q) -> float:
    """Nearest-rank percentile (q in [0, 100]) over ``samples``.  The
    deterministic textbook definition — sorted sample at rank
    ``ceil(q/100 * n)`` — so the p50/p99 numbers tests pin are exact,
    not interpolation-scheme-dependent."""
    xs = sorted(samples)
    if not xs:
        raise MXNetError("percentile of an empty sample set")
    import math
    rank = max(1, math.ceil((float(q) / 100.0) * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def latency_stats(kind: str) -> Optional[dict]:
    """{count, window, p50_ms, p99_ms, mean_ms, max_ms, qps} for ``kind``
    or None before the first sample.  Percentiles/mean/max are over the
    ring window; ``count``/``total`` are lifetime.  QPS is completions
    over the window's timespan — (len-1)/(last-first), the unbiased
    inter-arrival estimate; 0.0 until two samples exist."""
    with _latency_lock:
        st = _latency.get(kind)
        if st is None:
            return None
        durs = list(st["durs"])
        ts = list(st["ts"])
        count, total = st["count"], st["total"]
    qps = 0.0
    if len(ts) >= 2 and ts[-1] > ts[0]:
        qps = (len(ts) - 1) / (ts[-1] - ts[0])
    return {
        "count": count,
        "window": len(durs),
        "p50_ms": percentile(durs, 50) * 1e3,
        "p99_ms": percentile(durs, 99) * 1e3,
        "mean_ms": (sum(durs) / len(durs)) * 1e3,
        "max_ms": max(durs) * 1e3,
        "qps": qps,
    }


def latency_kinds() -> list:
    with _latency_lock:
        return sorted(_latency)


def reset_latency():
    with _latency_lock:
        _latency.clear()


_NULL = __import__("contextlib").nullcontext()


def scope(name, category="operator", require_mode=None):
    """Context manager for dispatch sites.  Returns a no-op context when
    the profiler is stopped (or the mode doesn't match), so call sites
    are just ``with profiler.scope(...):`` — all gating lives here."""
    if _profiler.state != PROFILER_STATE_RUN:
        return _NULL
    if require_mode is not None and _profiler.mode != require_mode:
        return _NULL
    return _profiler.scope(name, category)


# -- the universal snapshot ---------------------------------------------------
def snapshot(compact: bool = False) -> dict:
    """EVERY counter family in one plain-builtin dict — the single
    source behind the kvstore ``("stats",)`` envelope
    (kvstore_server._stats_payload), ``distributed.cluster_stats()``,
    the elastic beat piggyback and ``python -m
    mxnet_tpu_torch.profiler --dump``, so no consumer can drift from another.

    ``compact=True`` returns only the transport families (channel
    counts/gauges, bytes, wire clocks) — the per-beat piggyback the
    elastic stats bank accumulates; full counters since process start,
    so a lost beat costs freshness, never correctness."""
    out = {
        "channel": channel_counts(),
        "channel_bytes": channel_bytes(),
        "wire": {
            "wait_ms": wire_wait_ms(),
            "round_ms": wire_round_ms(),
            "rounds": wire_rounds(),
            "overlap_pct": wire_overlap_pct(),
        },
    }
    if compact:
        # the health status rides the compact form too: beats piggyback
        # it, so every peer's stats bank holds each member's last-known
        # OK/DEGRADED/CRITICAL verdict next to its counters
        out["health"] = _health.snapshot_section(compact=True)
        return out
    role, rank = tracing.role_rank()
    out.update({
        "pid": os.getpid(),
        "role": role,
        "rank": int(rank or 0),
        "dispatch": dispatch_counts(),
        "host_syncs": host_syncs(),
        "host_sync_total": host_sync_total(),
        "latency": {k: latency_stats(k) for k in latency_kinds()},
        "trace": tracing.stats(),
        "health": _health.snapshot_section(),
    })
    return out


def reset_all():
    """Zero every counter family (the --reset CLI and test isolation;
    the span FILE journal is append-only evidence and stays)."""
    reset_dispatch_counts()
    reset_host_syncs()
    reset_channel_counts()
    reset_channel_bytes()
    reset_wire_counters()
    reset_latency()
    tracing.reset()


def _main(argv=None) -> int:
    """``python -m mxnet_tpu_torch.profiler [--dump] [--reset] [--watch S]``
    — the shell face of :func:`snapshot` for scripts and chip runbooks:
    ``--dump`` (the default) prints the full snapshot as ONE JSON line
    (one JSON line); ``--reset`` zeroes the counters first (combine both for a
    read-and-rearm); ``--watch S`` repeats the dump every S seconds —
    one JSON line per tick, same contract — so a chip runbook can tail
    live counters (``| jq .wire``) without writing a loop.  ``--ticks
    N`` bounds the watch (0 = until interrupted)."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.profiler",
        description="dump/reset/watch the mxnet_tpu_torch profiler "
                    "counter snapshot")
    ap.add_argument("--dump", action="store_true",
                    help="print the snapshot as one JSON line (default "
                         "when --reset is not given)")
    ap.add_argument("--reset", action="store_true",
                    help="zero every counter family")
    ap.add_argument("--watch", type=float, default=None, metavar="S",
                    help="interval mode: print one snapshot JSON line "
                         "every S seconds (ctrl-C to stop)")
    ap.add_argument("--ticks", type=int, default=0, metavar="N",
                    help="with --watch: stop after N lines (0 = run "
                         "until interrupted)")
    args = ap.parse_args(argv)
    if args.watch is not None:
        if args.watch <= 0:
            ap.error("--watch interval must be > 0 seconds")
        if args.reset:
            reset_all()
        tick = 0
        try:
            while True:
                print(json.dumps(snapshot(), sort_keys=True,
                                 default=str), flush=True)
                tick += 1
                if args.ticks and tick >= args.ticks:
                    break
                time.sleep(args.watch)
        except KeyboardInterrupt:
            pass
        return 0
    # dump BEFORE reset: the --dump --reset combination is
    # read-and-rearm — print the accumulated counters, THEN zero them
    # (the other order would print an empty snapshot and lose the data)
    if args.dump or not args.reset:
        print(json.dumps(snapshot(), sort_keys=True, default=str))
    if args.reset:
        reset_all()
    return 0


if env("MXNET_PROFILER_AUTOSTART", 0):
    profiler_set_state("run")


if __name__ == "__main__":
    import sys
    sys.exit(_main())
