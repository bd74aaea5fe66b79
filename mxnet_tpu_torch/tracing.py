"""Span tracing (Dapper-style) for the port.

PyTorch counterpart of ``mxnet_tpu/tracing.py``, with the same records
and the same journal files, so ``tools/trace_merge.py --spans`` and
``tools/postmortem.py`` read the port's files unchanged:

* **Spans**: ``span_begin`` / ``span_end`` (or ``with span(...):``) with
  a thread-local stack of open spans, so nested calls build a
  parent/child tree.  Durations come from the monotonic clock; the wall
  clock is placed through one anchor a process
  (``time.time_ns() - time.monotonic_ns()``, taken at import).
* **Propagation**: ``current_ctx()`` is the (trace_id, span_id) pair a
  request carries to another process, which opens a child span under
  it (``span_begin(ctx=...)``).
* **Flush**: spans land in a bounded ring and, when ``MXNET_TRACE_DIR``
  is set, are appended to ``<dir>/<role>-<rank>.trace.jsonl``, flushed
  and fsync'd every ``MXNET_TRACE_FLUSH_N`` spans and at exit; the
  reader skips a torn last line.

Master switch: ``MXNET_TRACE=1``.  Off (the default) every entry point
returns before taking a lock.  Importing this module registers nothing:
the exit flush is registered when the first span is recorded.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

from .base import env

# wall-clock anchor for the monotonic span clock: epoch_us(span) =
# (monotonic_ns + anchor) / 1e3, one mapping for every span of the
# process; the merge tool estimates the skew between processes.
_ANCHOR_NS = time.time_ns() - time.monotonic_ns()

_NULL = __import__("contextlib").nullcontext()

_lock = threading.Lock()
_tls = threading.local()


class _State:
    """Module config + ring, re-readable for tests (``reconfigure``)."""

    def __init__(self):
        self.on = False
        self.dir = ""
        self.ring = deque(maxlen=4096)
        self.flush_n = 32
        # cached at reconfigure(): role/rank and the journal path are
        # process-constant — re-deriving them from os.environ per span
        # would tax the hot path for nothing
        self.role = "local"
        self.rank = "0"
        self.path = None
        self.recorded = 0
        self._fh = None
        self._unflushed = 0
        # set when the journal dir proved unwritable: stop retrying the
        # open() on every span (reconfigure() re-arms)
        self._file_dead = False
        self.exit_flush = False   # the atexit flush is registered


_state = _State()


def reconfigure():
    """(Re-)read the MXNET_TRACE* env knobs — import calls this once;
    tests call it again after monkeypatching the env.  Closes any open
    trace file so the next span reopens under the new settings."""
    with _lock:
        _close_file_locked()
        _state._file_dead = False
        _state.on = bool(env("MXNET_TRACE", False))
        _state.dir = str(env("MXNET_TRACE_DIR", "") or "")
        _state.flush_n = max(1, int(env("MXNET_TRACE_FLUSH_N", 32)))
        _state.role, _state.rank = role_rank()
        _state.path = os.path.join(
            _state.dir, "%s-%s.trace.jsonl" % (_state.role, _state.rank)
        ) if _state.dir else None
        ring = max(16, int(env("MXNET_TRACE_RING", 4096)))
        if ring != _state.ring.maxlen:
            _state.ring = deque(_state.ring, maxlen=ring)


def enabled() -> bool:
    """The master switch (``MXNET_TRACE=1``) — THE guard every
    instrumentation site checks first, so a disabled trace costs one
    attribute read."""
    return _state.on


def role_rank():
    """This process's (role, rank) from the launcher's DMLC env —
    ``("local", "0")`` outside a launcher job.  THE one derivation,
    shared by span records, ``profiler.snapshot()`` and the health
    bundles, so they never disagree on how a process is labeled."""
    role = os.environ.get("DMLC_ROLE") or "local"
    rank = os.environ.get("DMLC_SERVER_ID" if role == "server"
                          else "DMLC_WORKER_ID") or "0"
    return role, rank


def trace_file_path() -> Optional[str]:
    """Where this process flushes spans (None when MXNET_TRACE_DIR is
    unset): ``<dir>/<role>-<rank>.trace.jsonl`` — unique per process in
    a launcher job, so the merge tool gets one timeline track each.
    Cached at :func:`reconfigure`, like everything derived from the
    process-constant env."""
    return _state.path


def new_id() -> str:
    return uuid.uuid4().hex[:16]


def now_us() -> float:
    """Epoch microseconds on the anchored monotonic clock (what span
    ``ts`` fields and the envelope send stamp use)."""
    return (time.monotonic_ns() + _ANCHOR_NS) / 1e3


class Span:
    """One in-flight span.  ``args`` may be mutated until span_end."""

    __slots__ = ("name", "cat", "trace", "span", "parent", "t0", "args",
                 "detached")

    def __init__(self, name, cat, trace, span_id, parent, args, detached):
        self.name = name
        self.cat = cat
        self.trace = trace
        self.span = span_id
        self.parent = parent
        self.t0 = time.monotonic_ns()
        self.args = args
        self.detached = detached

    def ctx(self):
        return (self.trace, self.span)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Optional[Span]:
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def current_ctx() -> Optional[tuple]:
    """(trace_id, span_id) of the thread's innermost open span, or None
    — the value a request carries to another process (the distributed
    kvstore's envelopes)."""
    sp = current_span()
    return None if sp is None else (sp.trace, sp.span)


def span_begin(name, cat="span", ctx=None, detach=False, args=None
               ) -> Optional[Span]:
    """Open a span.  ``ctx=(trace_id, parent_span_id)`` adopts a remote
    parent (the server side of a traced envelope); otherwise the
    thread's current span is the parent, and with neither this span
    roots a fresh trace.  ``detach=True`` keeps it OFF the thread-local
    stack — for spans that end on another thread (a batcher reply slot).
    Returns None (and does nothing) when tracing is off."""
    if not _state.on:
        return None
    if ctx is not None:
        trace, parent = str(ctx[0]), (str(ctx[1]) if ctx[1] else None)
    else:
        cur = current_span()
        if cur is not None:
            trace, parent = cur.trace, cur.span
        else:
            trace, parent = new_id(), None
    sp = Span(str(name), cat, trace, new_id(), parent, args, detach)
    if not detach:
        _stack().append(sp)
    return sp


def span_end(sp: Optional[Span], args=None) -> None:
    """Close a span opened by :func:`span_begin` (None is a no-op, so
    callers never re-check the master switch)."""
    if sp is None:
        return
    t1 = time.monotonic_ns()
    if not sp.detached:
        st = getattr(_tls, "stack", None)
        if st and sp in st:
            # normally the top; a crossed end (rare) removes in place
            st.remove(sp)
    if args:
        sp.args = dict(sp.args or {}, **args)
    _record(sp.name, sp.cat, sp.trace, sp.span, sp.parent,
            sp.t0, t1, sp.args)


class _SpanCtx:
    __slots__ = ("_sp", "_a")

    def __init__(self, name, cat, ctx, args):
        self._a = (name, cat, ctx, args)
        self._sp = None

    def __enter__(self):
        name, cat, ctx, args = self._a
        self._sp = span_begin(name, cat=cat, ctx=ctx, args=args)
        return self._sp

    def __exit__(self, *exc):
        span_end(self._sp)


def span(name, cat="span", ctx=None, args=None):
    """``with tracing.span("kv.pull"):`` — the one-liner form.  Returns
    a shared null context when tracing is off."""
    if not _state.on:
        return _NULL
    return _SpanCtx(name, cat, ctx, args)


def instant(name, cat="instant", args=None) -> None:
    """A zero-duration marker under the current span (dedup hits,
    roster bumps — things with a moment but no extent)."""
    if not _state.on:
        return
    cur = current_span()
    trace = cur.trace if cur is not None else new_id()
    parent = cur.span if cur is not None else None
    t = time.monotonic_ns()
    _record(str(name), cat, trace, new_id(), parent, t, t, args)


def add_span(name, t0_mono_ns, t1_mono_ns, cat="span", ctx=None,
             args=None) -> None:
    """Record an already-timed span (both ends on the monotonic clock)
    — for intervals that cross threads, like a pull handle's
    enqueue→resolved wire round."""
    if not _state.on:
        return
    if ctx is not None:
        trace, parent = str(ctx[0]), (str(ctx[1]) if ctx[1] else None)
    else:
        cur = current_span()
        trace = cur.trace if cur is not None else new_id()
        parent = cur.span if cur is not None else None
    _record(str(name), cat, trace, new_id(), parent,
            int(t0_mono_ns), int(t1_mono_ns), args)


def _record(name, cat, trace, span_id, parent, t0_ns, t1_ns, args):
    rec = {
        "name": name, "cat": cat,
        "trace": trace, "span": span_id, "parent": parent,
        "ts": round((t0_ns + _ANCHOR_NS) / 1e3, 3),
        "dur": round(max(0, t1_ns - t0_ns) / 1e3, 3),
        "pid": os.getpid(),
        "tid": threading.get_ident() % 100000,
        "role": _state.role, "rank": _state.rank,
    }
    if args:
        rec["args"] = args
    # json-encode OUTSIDE the lock: the lock should cover only the ring
    # append and the (ordered) file write, not per-record CPU work.
    # The periodic flush+fsync does stay under the lock — it is what
    # bounds a SIGKILL's span loss to MXNET_TRACE_FLUSH_N, runs once
    # per flush_n records, and keeping it ordered beats a second
    # writer thread for an opt-in debugging feature.
    line = None
    if _state.path is not None and not _state._file_dead:
        line = json.dumps(rec, sort_keys=True)
    if not _state.exit_flush:
        _register_exit_flush()
    with _lock:
        _state.ring.append(rec)
        _state.recorded += 1
        if line is not None:
            _write_locked(line)


def _register_exit_flush():
    with _lock:
        if _state.exit_flush:
            return
        _state.exit_flush = True
    atexit.register(flush)


def _write_locked(line):
    path = _state.path
    if path is None or _state._file_dead:
        return
    try:
        if _state._fh is None:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            _state._fh = open(path, "a")
        _state._fh.write(line + "\n")
        _state._unflushed += 1
        if _state._unflushed >= _state.flush_n:
            _flush_locked()
    except OSError:
        # tracing must never take the job down: close the journal, mark
        # it dead (no per-span open() retries against an unwritable
        # dir) and keep the ring — the stats op still serves counters
        _close_file_locked()
        _state._file_dead = True
        _state._unflushed = 0


def _flush_locked():
    if _state._fh is None:
        return
    try:
        _state._fh.flush()
        os.fsync(_state._fh.fileno())
    except OSError:
        pass
    _state._unflushed = 0


def _close_file_locked():
    _flush_locked()
    if _state._fh is not None:
        try:
            _state._fh.close()
        except OSError:
            pass
        _state._fh = None


def flush() -> None:
    """Force the file buffer to disk (span_end fsyncs every
    MXNET_TRACE_FLUSH_N spans on its own; atexit calls this too)."""
    with _lock:
        _flush_locked()


def ring_records() -> list:
    """The bounded in-memory ring, oldest first (the stats op's and the
    in-process tests' view — no file round trip needed)."""
    with _lock:
        return list(_state.ring)


def stats() -> dict:
    """The tracing block of ``profiler.snapshot()``."""
    with _lock:
        return {
            "enabled": _state.on,
            "recorded": _state.recorded,
            "ring": len(_state.ring),
            "ring_max": _state.ring.maxlen,
            "file": trace_file_path(),
        }


def reset() -> None:
    """Clear the ring and counters (tests); the file, being append-only
    evidence, is left alone."""
    with _lock:
        _state.ring.clear()
        _state.recorded = 0


def read_trace_file(path) -> list:
    """Parse one ``*.trace.jsonl`` — TORN-LINE TOLERANT: a process
    SIGKILLed mid-append leaves at most one undecodable line, which is
    skipped .
    Returns the span records in file order."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn tail from a SIGKILL mid-write
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


reconfigure()
