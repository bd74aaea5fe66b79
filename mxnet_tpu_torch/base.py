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


def list_env_flags() -> Dict[str, tuple]:
    """Every declared knob: ``{name: (type, default, doc)}``."""
    return dict(_ENV_FLAGS)


# Attr (de)serialization for symbol JSON round trips (the reference stores
# op hyper-parameters as strings in graph JSON), the JAX package's helpers
def attr_to_str(v) -> str:
    import numpy as _np
    if isinstance(v, (list, tuple)):
        return "(" + ", ".join(attr_to_str(x) for x in v) + \
            ("," if len(v) == 1 else "") + ")"
    if isinstance(v, bool):
        return "True" if v else "False"
    if isinstance(v, _np.dtype):
        return v.name
    if isinstance(v, type):
        return _np.dtype(v).name
    return str(v)


def string_types():
    return (str,)


def str_to_attr(s: str):
    import ast
    if not isinstance(s, str):
        return s
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


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
declare_env("MXNET_SERVING_REFRESH_S", float, 0.0,
            "serving: seconds between weight-version polls against the "
            "live dist_async parameter servers (0 disables polling; the "
            "serving_refresh envelope forces a check either way)")
declare_env("MXNET_SERVING_CLIENT_WINDOW", int, 64,
            "serving: max in-flight predict envelopes per client "
            "connection (the serving override of MXNET_KVSTORE_WINDOW — "
            "the replica's pipelined loop batches across the window)")
declare_env("MXNET_SERVING_LATENCY_WINDOW", int, 2048,
            "serving: ring size of the profiler's per-kind latency "
            "sample window (p50/p99/QPS are computed over this window; "
            "count/total stay lifetime)")
# -- serving fleet (serving/fleet.py) ----------------------------------------
declare_env("MXNET_SERVING_FLEET_RETRIES", int, 3,
            "serving fleet: per-request retry budget — after the first "
            "attempt, at most this many more replicas are tried on "
            "BusyError / connection failure / reply timeout (predict is "
            "pure, so a cross-replica retry can never double-apply)")
declare_env("MXNET_SERVING_FLEET_DEADLINE_S", float, 30.0,
            "serving fleet: per-request wall deadline — routing, "
            "backoff sleeps and retries all stop here and the LAST "
            "error surfaces, naming every attempted replica")
declare_env("MXNET_SERVING_FLEET_ATTEMPT_S", float, 5.0,
            "serving fleet: per-attempt reply timeout — a replica that "
            "accepted the request but never answers (gray failure / "
            "blackhole) is abandoned after this many seconds and the "
            "request retries on a different replica")
declare_env("MXNET_SERVING_FLEET_BACKOFF_MS", float, 10.0,
            "serving fleet: initial retry backoff; doubles per retry "
            "up to MXNET_SERVING_FLEET_BACKOFF_MAX_MS")
declare_env("MXNET_SERVING_FLEET_BACKOFF_MAX_MS", float, 500.0,
            "serving fleet: retry backoff cap")
declare_env("MXNET_SERVING_FLEET_JITTER", float, 0.5,
            "serving fleet: jitter fraction on each backoff sleep "
            "(delay * (1 +/- jitter*U) — decorrelates a thundering "
            "retry herd); 0 = the pinned deterministic schedule the "
            "backoff tests assert")
declare_env("MXNET_SERVING_FLEET_STATS_S", float, 1.0,
            "serving fleet: scoreboard poll interval — each tick asks "
            "every replica for serving_stats (health verdict, queue "
            "depth, draining flag) and re-probes quarantined replicas; "
            "0 = no background thread, poll_once() only")
declare_env("MXNET_SERVING_FLEET_DEGRADED_PENALTY", float, 4.0,
            "serving fleet: load multiplier applied to a DEGRADED "
            "replica in weighted-least-loaded routing (it still "
            "serves, just proportionally less; CRITICAL/dead/draining "
            "replicas are excluded outright)")
declare_env("MXNET_SERVING_FLEET_CANARY_FRACTION", float, 0.1,
            "serving fleet: fraction of requests routed to the canary "
            "cohort while a canary is active")
declare_env("MXNET_SERVING_FLEET_CANARY_MIN_N", int, 32,
            "serving fleet: minimum completed requests in BOTH cohorts "
            "before the canary SLO comparison may trigger a rollback")
declare_env("MXNET_SERVING_FLEET_CANARY_P99_X", float, 2.0,
            "serving fleet: canary p99 regression factor — canary p99 "
            "above baseline p99 times this rolls the canary back")
declare_env("MXNET_SERVING_FLEET_CANARY_ERR_X", float, 2.0,
            "serving fleet: canary error-rate regression factor — "
            "canary error rate above baseline rate times this (plus a "
            "1% absolute floor) rolls the canary back")
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
declare_env("MXNET_DEVICE_METRICS", bool, True,
            "device-resident metric accumulation in the training and "
            "eval loops (EvalMetric.accumulate: a sum and a count on the "
            "metric's device, one readback at sync); 0 restores the "
            "host readback of every batch")
# -- the distributed kvstore (kvstore.py, kvstore_server.py, wirecodec.py,
# faultinject.py, shmlane.py): the JAX package's knobs and defaults ---
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
            "dist_async elastic membership: servers/workers may join or "
            "leave mid-job — versioned roster on the slot-0 coordinator "
            "(with deterministic successor election when the "
            "coordinator itself dies), stripe-plan re-derivation + "
            "striped-state handoff on a roster bump, barriers "
            "renegotiate instead of failing (membership.py)")
declare_env("MXNET_KVSTORE_SNAPSHOT_S", float, 0.0,
            "elastic: seconds between each server's state-snapshot "
            "beats, fanned out to EVERY peer so the bank outlives any "
            "single server incl. the coordinator (the killed-server "
            "optimizer-state recovery source; 0 disables snapshots — "
            "weights still recover from the workers' quorum re-push)")
declare_env("MXNET_KVSTORE_ELASTIC_PUSH_LOG", int, 256,
            "elastic: per-worker cap on pushes remembered since each "
            "key's last pull, re-applied under the new layout when a "
            "server dies with them (older entries fall off: "
            "best-effort for barrier-free async jobs)")
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
            "dist_async: hierarchical reduction tier - workers sharing "
            "a host (membership.host_groups over the launch topology) "
            "sum their gradients on the host-group leader's device and "
            "only the leader ships the reduced gradient over the TCP "
            "wire, fanning pulled weights back in-host; wire bytes per "
            "step drop by about the workers-per-host factor.  Needs "
            "MXNET_KVSTORE_WORKERS_PER_HOST and MXT_MESH_URIS (both "
            "set by tools/launch.py --workers-per-host); static "
            "rosters only")
declare_env("MXNET_KVSTORE_WORKERS_PER_HOST", int, 0,
            "hierarchical kvstore tier: worker ranks per host - "
            "consecutive ranks group (launchers fill host slots in "
            "order), lowest rank leads.  0 means no topology is "
            "known: MXNET_KVSTORE_HIERARCHY=1 then refuses loudly "
            "instead of guessing a group that crosses hosts")
declare_env("MXNET_KVSTORE_MESH_FANIN_S", float, 120.0,
            "hierarchical kvstore tier: seconds the host-group leader "
            "waits for every follower's contribution to a push round "
            "(and a follower's collect waits for the leader's wire "
            "round) before failing loudly, naming the missing ranks "
            "and their last-heard ages")
declare_env("MXNET_KVSTORE_MESH_ACCEPTORS", int, 8,
            "hierarchical kvstore tier: serve threads in the leader's "
            "fan-in pool - follower connections spread across them so "
            "W followers' push frames decode concurrently; 1 is the "
            "serialized single-acceptor drain")
declare_env("MXNET_KVSTORE_SHM", str, "auto",
            "hierarchical kvstore tier: same-host shared-memory lane "
            "for follower<->leader frames (shmlane.py; negotiated per "
            "connection by the shm_hello wire op) - 'auto' tries it "
            "when the leader's endpoint is a local address, 'on'/'1' "
            "always tries, 'off'/'0' never; segment creation or attach "
            "failures leave the connection on TCP.  Lane bytes land in "
            "the shm_* counter family (profiler.shm_bytes_total)")
declare_env("MXNET_KVSTORE_SHM_RING_KB", int, 4096,
            "shm lane: ring capacity per direction in KiB - a frame "
            "larger than the ring rides the TCP path for that round "
            "(safe: the tier's channels run a one-envelope window)")
declare_env("MXNET_KVSTORE_SHM_STALL_S", float, 5.0,
            "shm lane: seconds a pushed request may sit unconsumed in "
            "the ring before the follower declares the lane wedged, "
            "marks it dead and fails over to TCP via the channel's "
            "reconnect-and-replay (exactly-once via the leader's dedup)")
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
declare_env("MXNET_FI_SHM_WEDGE_AFTER", int, None,
            "fault injection: the tier's leader drains exactly N shm-"
            "lane ring frames normally, then stops popping - the "
            "wedged-drain shape the follower's MXNET_KVSTORE_SHM_STALL_S "
            "watchdog turns into a TCP fallback with no lost envelope "
            "(composes with MXNET_FI_ONLY_RANK; unset = off)")
declare_env("MXNET_FI_ONLY_RANK", int, None,
            "fault injection: restrict the armed plan to this "
            "DMLC_WORKER_ID (unset = all ranks)")
declare_env("MXNET_FI_KILL_PROCESS_AFTER", int, None,
            "fault injection: SIGKILL this process after serving "
            "exactly this many enveloped data-channel replies — real "
            "process death for elastic-membership tests (unset = off)")
declare_env("MXNET_FI_ONLY_SERVER", int, None,
            "fault injection: restrict the barrier-stall and blackhole "
            "plans to this DMLC_SERVER_ID (unset = all servers)")
declare_env("MXNET_FI_ONLY_COORDINATOR", bool, False,
            "fault injection: restrict the process-kill plans to the "
            "process CURRENTLY holding the elastic roster coordinator "
            "role (kvstore_server keeps the flag current across "
            "failovers; composes with MXNET_FI_ONLY_SERVER and the "
            "KILL_PROCESS_AFTER / KILL_ON_BEAT_SEQ kill points)")
declare_env("MXNET_FI_KILL_ON_BEAT_SEQ", int, None,
            "fault injection: SIGKILL this process when its elastic "
            "beat loop sends beat number N — the deterministic beat-"
            "boundary kill point for coordinator-failover tests, where "
            "the enveloped-ack count is timing-dependent (unset = off)")
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
