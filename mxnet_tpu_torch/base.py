"""Core plumbing shared by every layer of mxnet_tpu_torch.

PyTorch counterpart of ``mxnet_tpu/base.py``: the package's error type,
the typed environment-knob registry and the ``contrib`` namespace helper.
Only the knobs this package reads are declared here.
"""
from __future__ import annotations

import os
from typing import Dict

__version__ = "0.12.0.torch0"


class MXNetError(RuntimeError):
    """Default error raised by mxnet_tpu_torch (mirrors mxnet.base.MXNetError)."""


# ---------------------------------------------------------------------------
# Runtime flag registry (reference: dmlc::GetEnv call sites).  Every env
# flag the package consults is declared here with a type, a default and a
# description.
# ---------------------------------------------------------------------------
_ENV_FLAGS: Dict[str, tuple] = {}


def declare_env(name: str, typ: type, default, doc: str = "") -> None:
    _ENV_FLAGS[name] = (typ, default, doc)


def env(name: str, default=None):
    """Typed environment-variable lookup (reference: dmlc::GetEnv)."""
    if name in _ENV_FLAGS:
        typ, declared_default, _ = _ENV_FLAGS[name]
        if default is None:
            default = declared_default
    else:
        typ = type(default) if default is not None else str
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() not in ("0", "false", "off", "")
    try:
        return typ(raw)
    except (TypeError, ValueError):
        return default


declare_env("MXNET_SERVING_BUCKETS", str, "1,2,4,8,16,32",
            "serving: comma-separated batch-size buckets the predictor "
            "serves (requests pad to the smallest covering bucket)")
declare_env("MXNET_SERVING_MAX_WAIT_MS", float, 2.0,
            "serving: dynamic batcher max wait for more requests before "
            "dispatching a partially-filled bucket (0 dispatches "
            "immediately)")
declare_env("MXNET_SERVING_QUEUE_DEPTH", int, 256,
            "serving: admission control — requests queued past this "
            "depth are shed with a typed BUSY reply")
declare_env("MXNET_CPU_WORKER_NTHREADS", int, 4,
            "host worker threads for the data pipeline")
# -- profiler (profiler.py) -------------------------------------------------
declare_env("MXNET_PROFILER_MODE", str, "symbolic_only",
            "initial profiler mode: symbolic_only (dispatch events) or "
            "all (every category); profiler_set_config overrides")
declare_env("MXNET_PROFILER_AUTOSTART", bool, False,
            "begin profiling at import (reference: engine profiler "
            "autostart)")
declare_env("MXNET_PROFILER_XLA_LOGDIR", str, "",
            "directory for the device trace (torch.profiler with CUDA "
            "activity) that profiler start/stop also drives; the name "
            "is the JAX package's, so scripts run unchanged; empty = "
            "host events only")
# -- cluster tracing (tracing.py) --------------
declare_env("MXNET_TRACE", bool, False,
            "master switch for Dapper-style span tracing: kvstore "
            "request envelopes carry (trace_id, parent span) so "
            "server-side handling becomes child spans of the worker-"
            "side call; off (default) adds ZERO envelope bytes and "
            "near-zero cost at every instrumentation site")
declare_env("MXNET_TRACE_DIR", str, "",
            "tracing: directory each process appends its span journal "
            "to (<role>-<rank>.trace.jsonl, fsync'd, torn-line "
            "tolerant); merge with tools/trace_merge.py --spans; "
            "empty = in-memory ring only")
declare_env("MXNET_TRACE_RING", int, 4096,
            "tracing: bounded in-memory span ring per process (the "
            "stats op and in-process tests read it; older spans fall "
            "off — the file journal is the durable record)")
declare_env("MXNET_TRACE_FLUSH_N", int, 32,
            "tracing: spans buffered between flush+fsync of the trace "
            "journal (a SIGKILL loses at most this many spans plus "
            "one torn line, which the reader skips)")
# -- cluster health (health.py) ----------------
declare_env("MXNET_HEALTH", bool, True,
            "master switch for the health layer: flight-recorder event "
            "ring, stall watchdogs and SLO status evaluation; 0 makes "
            "every entry point a no-op (status always OK, no monitor "
            "thread, no crash bundles)")
declare_env("MXNET_HEALTH_DIR", str, "",
            "health: directory the flight recorder dumps its fsync'd "
            "<role>-<rank>.crash.json bundle into on crashes, channel "
            "poison, watchdog trips, SIGTERM and exit — the postmortem "
            "evidence a SIGKILLed peer's survivors leave behind "
            "(tools/postmortem.py merges them); empty = in-memory ring "
            "only")
declare_env("MXNET_HEALTH_INTERVAL_S", float, 1.0,
            "health: watchdog monitor-thread poll interval (the thread "
            "starts lazily with the first registered wait or probe)")
declare_env("MXNET_HEALTH_EVENTS", int, 256,
            "health: bounded size of the flight recorder's typed-event "
            "ring (older events fall off; the crash bundle carries the "
            "whole ring)")
declare_env("MXNET_HEALTH_BARRIER_STALL_S", float, 30.0,
            "health: a barrier wait (worker rendezvous or server park) "
            "parked past this many seconds trips the barrier_stall "
            "watchdog; 0 disables the check")
declare_env("MXNET_HEALTH_WIRE_STALL_S", float, 30.0,
            "health: a kvstore wire wait (pull_async resolution) stuck "
            "past this many seconds with its round never completing "
            "trips the wire_stall watchdog; 0 disables the check")
declare_env("MXNET_HEALTH_RECOVERY_S", float, 5.0,
            "health: recovery hysteresis — after every bad condition "
            "clears, the status keeps reporting DEGRADED for this many "
            "seconds before returning to OK, so a flapping condition "
            "reads as one continuous degradation")
declare_env("MXNET_HEALTH_P99_MS", float, 0.0,
            "health SLO rule: serving.request p99 latency ceiling in "
            "ms — p99 above it degrades the node; 0 disables the rule")
declare_env("MXNET_HEALTH_OVERLAP_FLOOR", float, 0.0,
            "health SLO rule: wire overlap_pct floor for the fused "
            "distributed loop — overlap below it (once >= 4 rounds have "
            "completed) degrades the node; 0 disables the rule")
declare_env("MXNET_HEALTH_FAILOVER_BUDGET_S", float, 0.0,
            "health SLO rule: coordinator failover_rebuild_s budget — "
            "a rebuild gauge above it degrades the node; 0 disables "
            "the rule")
declare_env("MXNET_HEALTH_QUEUE_SAT", float, 1.0,
            "health: serving queue-depth saturation fraction — a "
            "registered queue probe at or past this fraction of its "
            "limit trips the queue_saturated watchdog")
declare_env("MXNET_HEALTH_BUSY_STORM", int, 8,
            "health: BUSY-shed storm threshold — this many busy_shed "
            "events within MXNET_HEALTH_BUSY_WINDOW_S flip the replica "
            "to DEGRADED (recovering with hysteresis); 0 disables")
declare_env("MXNET_HEALTH_BUSY_WINDOW_S", float, 1.0,
            "health: sliding window (seconds) the BUSY-shed storm rule "
            "counts busy_shed events over")
declare_env("MXNET_HEALTH_STALE_S", float, 30.0,
            "health: staleness horizon for REMOTE health verdicts — a "
            "banked/beat-piggybacked health block whose wall-clock ts "
            "stamp is older than this many seconds no longer earns an "
            "OK (cluster_health and the serving fleet router floor it "
            "at DEGRADED: the last word of a corpse is forensics, not "
            "a live verdict); 0 disables the discount")
declare_env("MXNET_CKPT_RENDEZVOUS_TIMEOUT", float, 600.0,
            "async checkpoint: seconds rank 0 waits for every rank's "
            "shard (and ranks wait for the index) before failing")


class ContribNamespace:
    """``mx.sym.contrib.X`` → registered ``_contrib_X`` op (reference:
    python/mxnet/symbol/contrib.py namespace)."""

    def __init__(self, ns):
        self._ns = ns

    def __getattr__(self, name):
        fn = self._ns.get("_contrib_" + name) or self._ns.get(name)
        if fn is None:
            raise AttributeError(f"contrib op {name!r} not registered")
        return fn
