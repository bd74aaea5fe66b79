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
# -- the distributed kvstore (kvstore.py, kvstore_server.py, wirecodec.py,
# faultinject.py): the JAX package's knobs and defaults; the same-host
# shm lane's and the process-kill plans' come with ROADMAP E2 ----------
declare_env("MXNET_KVSTORE_BIGARRAY_BOUND", int, 1 << 19,
            "dist kvstore: arrays above this many elements stripe "
            "row-wise across all servers (per-stripe keys; parallel "
            "serialize/apply)")
declare_env("MXNET_KVSTORE_WINDOW", int, 8,
            "dist_async channel: max envelopes in flight per server "
            "connection (sliding-window pipeline; 1 = the old "
            "stop-and-wait loop bit for bit)")
declare_env("MXNET_KVSTORE_COMPRESSION", str, "",
            "gradient compression for dist pushes: ''/none, 2bit or "
            "fp16 (job-wide form of set_gradient_compression)")
declare_env("MXNET_KVSTORE_COMPRESSION_THRESHOLD", float, 0.5,
            "2bit quantization threshold t: gradient values quantize "
            "to {-t, 0, +t} with worker-side error feedback")
declare_env("MXNET_KVSTORE_COALESCE_BYTES", int, 16384,
            "LIST pushes coalesce same-server keys at or below this "
            "many payload bytes into one multi-key envelope")
declare_env("MXNET_KVSTORE_CODEC", str, "auto",
            "dist kvstore wire codec: 'auto'/'binary' negotiate the "
            "registry-generated binary frame codec per connection at "
            "hello time (hot push/pull/predict envelopes serialize "
            "zero pickled bytes; old peers keep pickle), 'pickle' "
            "pins the legacy pickle framing — the mixed-version "
            "escape hatch")
declare_env("MXNET_KVSTORE_SENDMSG", int, 1,
            "dist kvstore transport: 1 sends each frame with vectored "
            "socket.sendmsg scatter-gather (one syscall per frame, "
            "chunked at IOV_MAX); 0 falls back to per-buffer sendall")
declare_env("MXNET_KVSTORE_PICKLE_ALLOWLIST", str, "",
            "extra 'module' or 'module:name' entries (comma-separated) "
            "the wire unpickler admits — the custom-optimizer escape "
            "hatch (kvstore_server allowlist)")
declare_env("MXNET_KVSTORE_RETRY_MAX", int, 8,
            "dist_async channel: reconnect attempts per failure episode "
            "before the channel fails hard")
declare_env("MXNET_KVSTORE_RETRY_INITIAL_MS", int, 50,
            "dist_async channel: first reconnect backoff delay")
declare_env("MXNET_KVSTORE_RETRY_MAX_MS", int, 2000,
            "dist_async channel: backoff delay cap")
declare_env("MXNET_KVSTORE_RETRY_BACKOFF", float, 2.0,
            "dist_async channel: backoff multiplier per attempt")
declare_env("MXNET_KVSTORE_HEARTBEAT_INTERVAL", float, 5.0,
            "dist_async channel: seconds between liveness pings "
            "(0 disables the heartbeat)")
declare_env("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", float, 15.0,
            "dist_async: silence past this marks a node dead "
            "(num_dead_nodes; server barrier failure naming the rank)")
declare_env("MXNET_KVSTORE_DEDUP_WINDOW", int, 8,
            "server: cached replies per client channel for idempotent "
            "replay acks after a reconnect (keep >= 2: a zombie "
            "connection can serve its last request late)")
declare_env("MXNET_KVSTORE_ELASTIC", bool, False,
            "dist_async elastic membership (servers and workers joining "
            "or leaving mid-job): not ported yet (ROADMAP E2); set, the "
            "store and the server raise")
declare_env("MXNET_KVSTORE_FUSED", bool, True,
            "dist_async: let run_steps/step_k drive update-on-kvstore "
            "training chunk by chunk with the push/pull wire of a chunk "
            "overlapped behind the next chunk's compute; 0 restores the "
            "per-step dist loop")
declare_env("MXNET_KVSTORE_FUSED_CHUNK", int, 8,
            "chunked dist driver: steps per chunk, one push/pull wire "
            "round per chunk; larger chunks widen the window of local "
            "(worker-replica) weight evolution between server sync "
            "points")
declare_env("MXNET_KVSTORE_FUSED_STALENESS", int, 1,
            "chunked dist driver: exactly how many chunk boundaries the "
            "adopted server weights lag; chunk j starts from the pull "
            "issued after chunk j-1-S's pushes.  0 is a barrier'd chunk "
            "boundary (no overlap); 1 hides the wire behind one chunk "
            "of compute")
declare_env("MXNET_KVSTORE_HIERARCHY", bool, False,
            "dist_async hierarchical reduction tier (workers of a host "
            "reduce in-host, one leader ships): not ported yet (ROADMAP "
            "E2); set, the store raises")
declare_env("MXNET_KVSTORE_SPARSE", bool, True,
            "dist_async: ship row-sparse gradients (RowSparseNDArray "
            "pushes, e.g. embedding tables under sparse_grad) as "
            "RowSparsePayload wire values — only the touched rows plus "
            "8 bytes per row id travel, cutting push bytes by roughly "
            "the touch density (docs/PERF_NOTES.md round 14); 0 "
            "densifies at the push boundary (the pre-PR-19 wire "
            "format, every byte dense)")
declare_env("MXNET_KVSTORE_SPARSE_DENSITY_CUTOVER", float, 0.5,
            "dist_async sparse wire: touch-density threshold above "
            "which a row-sparse push goes DENSE instead — past ~50% "
            "touched rows the 8-bytes-per-id index overhead plus the "
            "gather outweighs the skipped rows, and the dense path's "
            "2-bit quantization packs tighter per element; 1.0 keeps "
            "every sparse push sparse, 0.0 densifies all")
declare_env("MXNET_FI_KILL_POINT", str, "before_send",
            "fault injection: where the one-shot connection kill fires "
            "(before_send / after_send / on_recv)")
declare_env("MXNET_FI_KILL_AFTER", int, None,
            "fault injection: sever the client connection at exactly "
            "this 1-based data-channel message count (unset = off)")
declare_env("MXNET_FI_KILL_UNACKED", int, None,
            "fault injection: sever the connection the moment this "
            "many pipelined envelopes are unacked (unset = off)")
declare_env("MXNET_FI_REFUSE_CONNECTS", int, 0,
            "fault injection: refuse the next N client connect "
            "attempts")
declare_env("MXNET_FI_REFUSE_ACCEPTS", int, 0,
            "fault injection: close the next N accepted server "
            "connections immediately")
declare_env("MXNET_FI_DELAY_ACK_MS", float, 0.0,
            "fault injection: delay every server data-channel reply "
            "by this many ms (heartbeats exempt)")
declare_env("MXNET_FI_ONLY_RANK", int, None,
            "fault injection: restrict the armed plan to this "
            "DMLC_WORKER_ID (unset = all ranks)")
declare_env("MXNET_FI_ONLY_SERVER", int, None,
            "fault injection: restrict the barrier-stall and blackhole "
            "plans to this DMLC_SERVER_ID (unset = all servers)")
declare_env("MXNET_FI_STALL_BARRIER_MS", float, 0.0,
            "fault injection: delay the server's handling of the NEXT "
            "barrier arrival by this many ms before it registers — a "
            "deterministic one-shot barrier wedge (every other rank's "
            "park and the delayed rank's reply stretch by exactly this "
            "long), the CPU-testable stall the mxnet_tpu.health "
            "watchdog gates trip on (unset/0 = off)")
declare_env("MXNET_FI_BLACKHOLE_AFTER", int, None,
            "fault injection: serve exactly N enveloped data-channel "
            "replies normally, then SWALLOW every later one — the "
            "socket stays open, requests are still accepted and "
            "heartbeats still ack, but no reply ever arrives.  The "
            "gray-failure shape (a stalled-not-dead server) the "
            "serving fleet's reply timeouts must route around, where "
            "liveness alone says everything is fine (unset = off)")
declare_env("MXT_SERVER_URIS", str, "",
            "dist_async: comma-separated host:port of every parameter "
            "server (set by tools/launch.py -s S for every role)")


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
