"""Dynamic request batcher with queue-depth admission control.

PyTorch counterpart of ``mxnet_tpu/serving/batcher.py``: requests enqueue
as reply slots; ONE worker thread drains the queue into the largest ready
bucket — it dispatches the moment the queued rows fill the biggest
bucket, or when the OLDEST queued request has waited
``MXNET_SERVING_MAX_WAIT_MS``, whichever is first.  Requests past
``MXNET_SERVING_QUEUE_DEPTH`` complete at once with a typed BUSY reply.
A predict failure fails that batch's slots; a worker crash parks the
error, fails every queued slot and every later submit.  Each dispatch is
a ``serving.batch`` span (with ``MXNET_TRACE=1``) holding the rows, the
slots and the longest queue wait, and each shed request a
``busy_shed`` health note, which the BUSY-storm rule counts; a slot may
carry a detached span of its caller's, which gets its queue wait.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, List

import numpy as np

from ..base import MXNetError, env
from .. import health as _health
from .. import profiler as _prof
from .. import tracing as _tr
from .bucketed import rows_per_example


class BusyError(MXNetError):
    """Typed overload signal: the request was shed at admission (queue
    depth past ``MXNET_SERVING_QUEUE_DEPTH``); the model never ran."""


class _ReplySlot:
    """One request's reply rendezvous: ``reply`` is the
    ``("ok"|"err", payload)`` tuple, set when ``done`` fires."""

    __slots__ = ("done", "reply", "data", "n", "t_enqueue", "sig", "span")

    def __init__(self, data=None, n=0, sig=None):
        self.done = threading.Event()
        self.reply = None
        self.data = data
        self.n = n
        self.sig = sig
        self.span = None     # a detached span of the caller's
        self.t_enqueue = time.monotonic()

    def complete(self, reply):
        self.reply = reply
        self.done.set()


class DynamicBatcher:
    """Drain a request queue into bucketed predict dispatches."""

    def __init__(self, predictor, max_wait_s=None, queue_depth=None):
        self._predictor = predictor
        self._max_wait = float(
            env("MXNET_SERVING_MAX_WAIT_MS", 2.0) / 1000.0
            if max_wait_s is None else max_wait_s)
        self._queue_depth = int(env("MXNET_SERVING_QUEUE_DEPTH", 256)
                                if queue_depth is None else queue_depth)
        self._cv = threading.Condition()
        self._q: deque = deque()
        self._stop = False
        self._err = None
        self.batches = 0          # dispatches issued
        self.shed = 0             # requests answered BUSY
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    # -- intake --------------------------------------------------------------
    def submit(self, data, span=None) -> _ReplySlot:
        """Admit one request; ALWAYS returns a slot (completed on the
        spot for BUSY and validation failures).  ``span`` (a detached
        tracing span) is annotated with the request's queue wait at
        dispatch."""
        slot = _ReplySlot()
        slot.span = span
        try:
            datas, n, sig = self._validate(data)
        except MXNetError as exc:
            slot.complete(("err", f"{type(exc).__name__}: {exc}"))
            return slot
        slot.data, slot.n, slot.sig = datas, n, sig
        with self._cv:
            if self._err is not None:
                slot.complete(("err", "serving batcher failed: "
                               f"{self._err}"))
                return slot
            if self._stop:
                slot.complete(("err", "serving replica is stopping"))
                return slot
            if len(self._q) >= self._queue_depth:
                self.shed += 1
                _prof.record_channel_event("serving.busy_shed")
                # the health rules count these in a sliding window:
                # MXNET_HEALTH_BUSY_STORM sheds within
                # MXNET_HEALTH_BUSY_WINDOW_S make the process DEGRADED
                _health.note("busy_shed")
                slot.complete(("ok", ("busy", {
                    "queue_depth": len(self._q),
                    "limit": self._queue_depth})))
                return slot
            self._q.append(slot)
            self._cv.notify_all()
        return slot

    def _validate(self, data):
        if not isinstance(data, dict):
            raise MXNetError("predict payload must be a {name: array} "
                             f"dict, got {type(data).__name__}")
        datas: Dict[str, np.ndarray] = {}
        n = None
        for name, v in data.items():
            arr = np.asarray(v)
            if arr.ndim < 1:
                raise MXNetError(f"predict input {name!r} needs a batch "
                                 "axis")
            if n is None:
                n = int(arr.shape[0])
            elif int(arr.shape[0]) != n:
                raise MXNetError("predict inputs disagree on the row "
                                 "count")
            datas[str(name)] = arr
        if not datas or not n:
            raise MXNetError("empty predict payload")
        # only same-structure requests share a padded bucket
        sig = tuple(sorted((name, tuple(a.shape[1:]), str(a.dtype))
                           for name, a in datas.items()))
        return datas, n, sig

    @property
    def queue_depth(self) -> int:
        with self._cv:
            return len(self._q)

    # -- worker --------------------------------------------------------------
    def _loop(self):
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._dispatch(batch)
        except Exception as exc:  # noqa: BLE001 — sticky-error contract
            with self._cv:
                self._err = exc
                failed, self._q = list(self._q), deque()
            for slot in failed:
                slot.complete(("err", f"serving batcher failed: {exc}"))

    def _collect(self):
        """Block for work, then drain until the largest bucket is full
        or the oldest request's max-wait expires; returns the slots of
        ONE dispatch (same structure signature as the head), or None on
        stop.  The scan covers the whole queue; skipped slots keep their
        order and enqueue times."""
        max_rows = self._predictor.buckets[-1]
        with self._cv:
            while not self._q:
                if self._stop:
                    return None
                self._cv.wait(0.1)
            head_sig = self._q[0].sig
            deadline = self._q[0].t_enqueue + self._max_wait
            while not self._stop:
                rows = sum(s.n for s in self._q if s.sig == head_sig)
                if rows >= max_rows:
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                self._cv.wait(left)
            taken: List[_ReplySlot] = []
            kept: deque = deque()
            rows = 0
            while self._q:
                slot = self._q.popleft()
                if (slot.sig == head_sig
                        and (not taken or rows + slot.n <= max_rows)):
                    # the head always dispatches, even oversize (the
                    # predictor chunks it through the largest bucket)
                    taken.append(slot)
                    rows += slot.n
                else:
                    kept.append(slot)
            self._q = kept
        return taken

    def _dispatch(self, slots):
        data = {name: np.concatenate([s.data[name] for s in slots], axis=0)
                for name in slots[0].data}
        total = sum(s.n for s in slots)
        t_batch = time.monotonic()
        # the device half of a request's latency: the queue wait is
        # t_batch - t_enqueue a slot, the span holds forward and readback
        bsp = _tr.span_begin(
            "serving.batch", cat="serving", detach=True,
            args={"rows": int(total), "slots": len(slots),
                  "queue_wait_ms_max": round(
                      (t_batch - min(s.t_enqueue for s in slots)) * 1e3,
                      3)})
        try:
            version, outs = self._predictor.predict(data)
            per = [rows_per_example(o.shape[0], total) for o in outs]
        except Exception as exc:  # noqa: BLE001 — fail THIS batch only
            _tr.span_end(bsp, args={"error": type(exc).__name__})
            for slot in slots:
                slot.complete(("err", f"{type(exc).__name__}: {exc}"))
            return
        _tr.span_end(bsp)
        self.batches += 1
        lo = 0
        now = time.monotonic()
        for slot in slots:
            hi = lo + slot.n
            if slot.span is not None:
                slot.span.args = dict(
                    slot.span.args or {},
                    queue_wait_ms=round((t_batch - slot.t_enqueue) * 1e3,
                                        3))
            slot.complete(("ok", ("result", version,
                                  [o[lo * k:hi * k]
                                   for o, k in zip(outs, per)])))
            # end-to-end request latency: queue wait + padded forward +
            # readback
            _prof.record_latency("serving.request",
                                 now - slot.t_enqueue, ts=now)
            lo = hi

    def stop(self):
        """Stop the worker; fail everything still queued."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._thread.join(timeout=10.0)
        with self._cv:
            leftover, self._q = list(self._q), deque()
        for slot in leftover:
            slot.complete(("err", "serving replica is stopping"))
