"""Serving client: pipelined predict requests over the kvstore channel.

PyTorch counterpart of ``mxnet_tpu/serving/client.py``; it speaks the
same frames, so it drives a replica of either package.

Reuses :class:`mxnet_tpu_torch.kvstore._ServerConn` verbatim — the serving
wire IS the hardened kvstore wire, so a client gets the sliding-window
pipeline (``MXNET_SERVING_CLIENT_WINDOW`` envelopes in flight — wide by
default so the replica's batcher sees real concurrency from one
connection), reconnect + full-window replay through connection kills,
heartbeat liveness and TCP_NODELAY for free.  Replies are typed:

* a served result returns ``(version, [np outputs])``;
* an admission-control shed raises :class:`BusyError` (retryable — the
  model never ran);
* a reply that never arrives within an explicit ``get(timeout=...)``
  raises :class:`PredictTimeout` (retryable on ANOTHER replica —
  predict is pure, and a gray-failed replica that accepted the request
  but will never answer is indistinguishable from a slow one except by
  this clock);
* a real failure raises :class:`~mxnet_tpu_torch.base.MXNetError`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..base import MXNetError, env
from .batcher import BusyError
from .bucketed import _host_array


class PredictTimeout(MXNetError):
    """A predict (or control op) reply did not arrive within the
    caller's timeout.  The connection may be fine and merely slow, or
    gray-failed (accepting requests, never replying) — either way the
    request is safe to retry elsewhere, because predict is pure."""


def _timed_await(pending, timeout, what="request"):
    """Block for a ``_Pending`` reply with an optional timeout —
    the fleet's per-attempt clock on every wire op (kvstore._await is
    the unbounded form)."""
    if not pending.done.wait(timeout):
        raise PredictTimeout(
            f"serving {what} reply not received within {timeout}s")
    if pending.error is not None:
        raise MXNetError(f"kvstore server request failed: "
                         f"{pending.error}")
    return pending.value


class PredictFuture:
    """Handle for one in-flight predict; ``get()`` blocks for the typed
    reply."""

    __slots__ = ("_pending", "version")

    def __init__(self, pending):
        self._pending = pending
        self.version = None

    def get(self, timeout: Optional[float] = None):
        payload = _timed_await(self._pending, timeout, what="predict")
        if payload[0] == "busy":
            info = payload[1]
            raise BusyError(
                "serving replica shed the request (queue depth "
                f"{info.get('queue_depth')} >= limit {info.get('limit')})"
                " — retry with backoff or use another replica")
        _tag, version, outs = payload
        self.version = int(version)
        return [np.asarray(o) for o in outs]


class ServingClient:
    """Client for one :class:`~mxnet_tpu_torch.serving.ServingReplica`."""

    def __init__(self, uri, window=None, connect_timeout=60.0):
        from ..kvstore import _ServerConn
        w = int(env("MXNET_SERVING_CLIENT_WINDOW", 64)
                if window is None else window)
        self.uri = str(uri)
        self._conn = _ServerConn(uri, connect_timeout=connect_timeout,
                                 window=max(1, w))

    def predict_async(self, data, name="data",
                      canary=False) -> PredictFuture:
        """Enqueue one predict; returns a :class:`PredictFuture`.  Many
        futures may be outstanding — that is exactly what feeds the
        replica's dynamic batcher.  ``canary=True`` sends the canary-
        tagged twin op: same batcher and reply shape, but counted
        separately on the replica (serving.canary_predict), so a fleet
        canary fraction is provable server-side."""
        payload = self._payload(data, name)
        if canary:
            return PredictFuture(
                self._conn.request(("predict_canary", payload)))
        return PredictFuture(self._conn.request(("predict", payload)))

    def predict(self, data, name="data"):
        """Blocking predict: returns the output list (np arrays, padded
        rows already sliced off by the replica)."""
        return self.predict_async(data, name=name).get()

    @staticmethod
    def _payload(data, name) -> Dict[str, np.ndarray]:
        if not isinstance(data, dict):
            data = {name: data}
        out = {}
        for k, v in data.items():
            arr = _host_array(v)
            # ndim check BEFORE ascontiguousarray: the latter promotes
            # 0-d to 1-d and would mask a scalar input
            if arr.ndim < 1:
                raise MXNetError(f"predict input {k!r} needs a batch axis")
            out[str(k)] = np.ascontiguousarray(arr)
        return out

    def stats(self, timeout: Optional[float] = None) -> dict:
        """The replica's serving counters (version, queue depth,
        batches, shed count, draining flag, p50/p99/QPS latency dict,
        health verdict).  ``timeout`` bounds the wait — the fleet's
        scoreboard probe must not hang on a blackholed replica."""
        return _timed_await(self._conn.request(("serving_stats",)),
                            timeout, what="serving_stats")

    def refresh(self, timeout: Optional[float] = None) -> dict:
        """Force one weight-version check on the replica NOW; returns
        {version, refreshed, skipped}."""
        return _timed_await(self._conn.request(("serving_refresh",)),
                            timeout, what="serving_refresh")

    def drain(self, enable: bool = True,
              timeout: Optional[float] = None) -> dict:
        """Flip the replica's advisory drain flag (idempotent); returns
        ``{"draining": bool}``.  Routers observe it on the next stats
        poll; in-flight work still completes."""
        return _timed_await(self._conn.request(("drain", bool(enable))),
                            timeout, what="drain")

    def is_dead(self) -> bool:
        """Heartbeat silence past MXNET_KVSTORE_HEARTBEAT_TIMEOUT —
        the liveness half of a fleet scoreboard (a blackholed replica
        still acks heartbeats; only reply timeouts catch that)."""
        return self._conn.is_dead()

    def version(self) -> Optional[int]:
        return self.stats().get("version")

    def close(self):
        self._conn.close()

    def abort(self):
        """Abortive teardown for a gray-failed replica (accepting,
        heartbeating, never replying): fail the in-flight window NOW
        instead of draining — one swallowed reply has already
        misaligned this stream's FIFO acks for good, so the conn must
        be replaced, not reused (kvstore._ServerConn.abort)."""
        self._conn.abort()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
