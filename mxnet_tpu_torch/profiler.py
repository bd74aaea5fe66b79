"""Profiler counters (the serving path, Module, autograd and Gluon).

PyTorch counterpart of the subset of ``mxnet_tpu/profiler.py`` that
``serving/`` calls: dispatch counters, host-sync counters, channel events,
request-latency rings and the ``scope`` context manager.  The chrome-trace
event capture, the device trace and cluster tracing are not ported yet;
``scope`` is therefore always a no-op context.
"""
from __future__ import annotations

import contextlib
import math
import threading
import time
from collections import deque
from typing import Optional

from .base import MXNetError

_dispatch_counts: dict = {}
_dispatch_lock = threading.Lock()


def record_dispatch(kind: str):
    """Count one host-side dispatch event of ``kind``."""
    with _dispatch_lock:
        _dispatch_counts[kind] = _dispatch_counts.get(kind, 0) + 1


def dispatch_counts() -> dict:
    with _dispatch_lock:
        return dict(_dispatch_counts)


def reset_dispatch_counts():
    with _dispatch_lock:
        _dispatch_counts.clear()


_host_sync_counts: dict = {}
_host_sync_lock = threading.Lock()


def record_host_sync(kind: str):
    """Count one host-blocking device readback of ``kind``."""
    with _host_sync_lock:
        _host_sync_counts[kind] = _host_sync_counts.get(kind, 0) + 1


def host_syncs() -> dict:
    with _host_sync_lock:
        return dict(_host_sync_counts)


_channel_counts: dict = {}
_channel_lock = threading.Lock()


def record_channel_event(kind: str):
    """Count one transport event of ``kind`` (e.g. ``serving.busy_shed``)."""
    with _channel_lock:
        _channel_counts[kind] = _channel_counts.get(kind, 0) + 1


def channel_counts() -> dict:
    with _channel_lock:
        return dict(_channel_counts)


_LATENCY_WINDOW = 2048
_latency_lock = threading.Lock()
_latency: dict = {}   # kind -> {"durs": deque, "ts": deque, "count", "total"}


def record_latency(kind: str, dur_s: float, ts: Optional[float] = None):
    """Record one completed request of ``kind`` taking ``dur_s`` seconds;
    ``ts`` is the completion time (``time.monotonic()`` when omitted)."""
    if ts is None:
        ts = time.monotonic()
    with _latency_lock:
        st = _latency.get(kind)
        if st is None:
            st = _latency[kind] = {"durs": deque(maxlen=_LATENCY_WINDOW),
                                   "ts": deque(maxlen=_LATENCY_WINDOW),
                                   "count": 0, "total": 0.0}
        st["durs"].append(float(dur_s))
        st["ts"].append(float(ts))
        st["count"] += 1
        st["total"] += float(dur_s)


def percentile(samples, q) -> float:
    """Nearest-rank percentile (q in [0, 100]) over ``samples``."""
    xs = sorted(samples)
    if not xs:
        raise MXNetError("percentile of an empty sample set")
    rank = max(1, math.ceil((float(q) / 100.0) * len(xs)))
    return xs[min(rank, len(xs)) - 1]


def latency_stats(kind: str) -> Optional[dict]:
    """{count, window, p50_ms, p99_ms, mean_ms, max_ms, qps} for ``kind``
    or None before the first sample (same arithmetic as the JAX
    package's profiler)."""
    with _latency_lock:
        st = _latency.get(kind)
        if st is None:
            return None
        durs = list(st["durs"])
        ts = list(st["ts"])
        count = st["count"]
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


def reset_latency():
    with _latency_lock:
        _latency.clear()


def scope(name, category="operator"):
    """Context manager for dispatch sites (no event capture yet)."""
    return contextlib.nullcontext()
