"""Happens-before race sanitizer: vector clocks over the threading shim.

The port's copy of ``mxnet_tpu/analysis/hb.py`` (it imports nothing of
JAX): in production ``track`` is the identity and ``HBLock`` a lock.

The runtime half of the conformance suite
(:mod:`mxnet_tpu.analysis.runtime` is the lock-ORDER half): observe
the real thread interleavings of the messy scenarios — kill-and-
replay, three-phase handoff, coordinator failover,
``_PullHandle._replan``, mesh fan-in — and flag SHARED-STATE accesses
with no happens-before edge between them.  A data race that today's
schedule happens to serialize is still a bug tomorrow; the
closed-channel hang and the unlocked-bank reads were exactly this
shape.

Design is a miniature of TSan/FastTrack:

* every thread carries a **vector clock**; edges join clocks at
  lock release→acquire (the ``threading.Lock``/``RLock`` shim, with
  the ``Condition`` ``_release_save``/``_acquire_restore`` protocol
  forwarded so cv parks stay visible), ``queue.Queue`` put→get
  (per-item stamping), and ``Thread`` start/join;
* the HOT shared containers (pull cache + push log, dedup windows,
  stats/snapshot banks, the membership ledger banks,
  ``_PullHandle`` entries) are wrapped by :func:`track` — a no-op
  returning the container unchanged unless a sanitizer is ACTIVE
  (``shim()``), so production pays one ``is None`` test per
  construction;
* an access pair with no ordering — write/write or read↔write,
  same container — raises :class:`RaceError` in strict mode AT the
  second access, carrying BOTH stacks; non-strict records it for
  ``assert_race_free()``.

Container checks are deliberately whole-structure: our shared dicts
are one-lock-guarded by design, and Python dict mutation is not
key-independent anyway (iteration vs insert).  Reentrant RLock
re-entry adds no new epoch; thread-ident reuse after a join can only
OVER-order (a missed race, never a false one).

Usage::

    with hb.shim(strict=True) as san:
        ...construct servers/stores and run the scenario...
    san.assert_race_free()
    assert san.op_count() > 0       # proves instrumentation was live
"""
from __future__ import annotations

import _thread
import contextlib
import threading
import traceback
from collections import OrderedDict, deque
from typing import Dict, List, Optional

__all__ = [
    "RaceError", "Sanitizer", "HBLock", "shim", "track", "active",
    "TrackedDict", "TrackedOrderedDict", "TrackedList", "TrackedDeque",
    "set_scheduler", "scheduler", "note_spsc",
]


class RaceError(RuntimeError):
    """Two accesses to tracked state with no happens-before edge."""


_ACTIVE: Optional["Sanitizer"] = None

# The pluggable yield hook: when a controlled scheduler is
# installed (analysis.sched), every interception point this shim
# already owns — lock acquire/release, queue put/get (via the patched
# Condition the queue's mutex rides), thread start/join, tracked
# container accesses — doubles as a SCHEDULING point.  None in
# production and under plain hb runs: one global load per op.
_SCHED = None


def set_scheduler(sch) -> None:
    """Install (or clear, with None) the controlled scheduler that the
    shim's yield points report to."""
    global _SCHED
    _SCHED = sch


def scheduler():
    return _SCHED


def active() -> Optional["Sanitizer"]:
    return _ACTIVE


def _stack() -> str:
    """Caller stack, trimmed of sanitizer internals — one half of a
    race report's evidence."""
    frames = traceback.extract_stack()
    keep = [f for f in frames
            if not f.filename.endswith("analysis/hb.py")
            and f.filename != threading.__file__]
    return "".join(traceback.format_list(keep[-8:]))


def _lock_site() -> str:
    """Allocation site of a lock born under the controlled scheduler —
    schedule journals name resources by where they were created."""
    import queue as _queue
    for f in reversed(traceback.extract_stack(limit=12)):
        fn = f.filename
        if fn.endswith("analysis/hb.py") or fn == threading.__file__ \
                or fn == _queue.__file__:
            continue
        return "%s:%d" % (fn.rsplit("/", 1)[-1], f.lineno)
    return "?"


class _Access:
    __slots__ = ("tid", "thread", "epoch", "write", "stack")

    def __init__(self, tid, thread, epoch, write, stack):
        self.tid = tid
        self.thread = thread
        self.epoch = epoch
        self.write = write
        self.stack = stack


class Sanitizer:
    """Vector clocks + the tracked-cell table.  Bookkeeping runs under
    a raw ``_thread`` lock so it can never appear in the graphs it
    checks."""

    def __init__(self, strict: bool = False):
        self.strict = strict
        self.closed = False
        self._meta = _thread.allocate_lock()
        self._clocks: Dict[int, Dict[int, int]] = {}
        self._sync: Dict[object, Dict[int, int]] = {}   # release clocks
        self._cells: Dict[int, Dict[str, object]] = {}  # cid -> cell
        self._owners: Dict[object, tuple] = {}  # SPSC key -> writer
        self._violations: List[str] = []
        self._ops = 0

    # -- clock plumbing (caller holds _meta) ---------------------------------
    def _vc(self, tid) -> Dict[int, int]:
        vc = self._clocks.get(tid)
        if vc is None:
            vc = self._clocks[tid] = {tid: 1}
        return vc

    @staticmethod
    def _join(dst, src) -> None:
        for t, c in src.items():
            if dst.get(t, 0) < c:
                dst[t] = c

    # -- queries -------------------------------------------------------------
    def violations(self) -> List[str]:
        with self._meta:
            return list(self._violations)

    def op_count(self) -> int:
        """Edges + tracked accesses observed — the liveness probe: a
        race-free result with zero ops means nothing was
        instrumented."""
        with self._meta:
            return self._ops

    def assert_race_free(self) -> None:
        with self._meta:
            if self._violations:
                raise RaceError(
                    "unsynchronized accesses recorded:\n" +
                    "\n".join(self._violations))

    # -- happens-before edges ------------------------------------------------
    def acquire_edge(self, key) -> None:
        """this thread ⊒ the last release of ``key``."""
        if self.closed:
            return
        tid = _thread.get_ident()
        with self._meta:
            rel = self._sync.get(key)
            if rel:
                self._join(self._vc(tid), rel)
            self._ops += 1

    def release_edge(self, key) -> None:
        """Publish this thread's clock at ``key``; start a new epoch."""
        if self.closed:
            return
        tid = _thread.get_ident()
        with self._meta:
            vc = self._vc(tid)
            self._sync[key] = dict(vc)
            vc[tid] = vc.get(tid, 1) + 1
            self._ops += 1

    def publish_snapshot(self) -> Dict[int, int]:
        """Clock snapshot + epoch bump — the sending half of a
        point-to-point edge (thread start, queue put)."""
        tid = _thread.get_ident()
        with self._meta:
            vc = self._vc(tid)
            snap = dict(vc)
            vc[tid] = vc.get(tid, 1) + 1
            self._ops += 1
        return snap

    def adopt(self, snap) -> None:
        """The receiving half (thread begin/join, queue get)."""
        if not snap:
            return
        tid = _thread.get_ident()
        with self._meta:
            self._join(self._vc(tid), snap)
            self._ops += 1

    # -- tracked accesses ----------------------------------------------------
    def access(self, cid: int, name: str, write: bool) -> None:
        if self.closed:
            return
        sch = _SCHED
        if sch is not None:
            sch.yield_point("track", name)
        tid = _thread.get_ident()
        me = _Access(tid, threading.current_thread().name, 0, write,
                     _stack())
        new_races = []
        with self._meta:
            vc = self._vc(tid)
            me.epoch = vc.get(tid, 1)
            cell = self._cells.get(cid)
            if cell is None:
                cell = self._cells[cid] = {"write": None, "reads": {}}
            self._ops += 1

            def unordered(prev):
                return prev.tid != tid \
                    and vc.get(prev.tid, 0) < prev.epoch

            w = cell["write"]
            if w is not None and unordered(w):
                new_races.append((w, me))
            if write:
                for r in cell["reads"].values():
                    if unordered(r):
                        new_races.append((r, me))
                cell["write"] = me
                cell["reads"] = {}
            else:
                cell["reads"][tid] = me
            # render while still holding _meta: another thread's race
            # could land in _violations between release and a strict
            # raise, and the error must carry THIS access's stacks
            messages = [
                "RACE on %s: %s by thread %r not ordered against "
                "%s by thread %r\n-- first access stack --\n%s"
                "-- second access stack --\n%s"
                % (name,
                   "write" if prev.write else "read", prev.thread,
                   "write" if cur.write else "read", cur.thread,
                   prev.stack, cur.stack)
                for prev, cur in new_races]
            self._violations.extend(messages)
        if new_races and self.strict:
            raise RaceError(messages[-1])

    def single_writer(self, key, name: str) -> None:
        """Enforce single-WRITER discipline on deliberately lock-free
        state (the shmlane SPSC ring indices): whole-structure vector
        clocks would false-positive there — the rings synchronize
        through the index stores themselves — but the design contract
        is exactly one writer thread per index, and THAT is checkable."""
        if self.closed:
            return
        tid = _thread.get_ident()
        msg = None
        with self._meta:
            self._ops += 1
            have = self._owners.get(key)
            if have is None:
                self._owners[key] = (
                    tid, threading.current_thread().name, _stack())
            elif have[0] != tid:
                msg = ("SPSC single-writer violation on %s: thread %r "
                       "writes an index owned by thread %r\n"
                       "-- owning write stack --\n%s"
                       "-- violating write stack --\n%s"
                       % (name, threading.current_thread().name,
                          have[1], have[2], _stack()))
                self._violations.append(msg)
        if msg is not None and self.strict:
            raise RaceError(msg)


class HBLock:
    """Instrumented lock recording release→acquire edges into a
    :class:`Sanitizer` (drop-in for ``threading.Lock``/``RLock``;
    forwards the ``Condition`` protocol so cv parks re-join the
    notifier's clock on wake)."""

    def __init__(self, san: Sanitizer, rlock: bool = False,
                 name: Optional[str] = None):
        self._inner = _thread.RLock() if rlock else _thread.allocate_lock()
        self._san = san
        self._rlock = rlock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sch = _SCHED
        if sch is not None:
            got = sch.lock_acquire(self, blocking, timeout)
            if got is not None:      # modeled: the scheduler owns blocking
                if not got:
                    return False
                # granted — uncontended among controlled threads, so the
                # real acquire below is immediate (token serialization
                # keeps the real lock state mirroring the model)
                self._inner.acquire()
                self._san.acquire_edge(id(self))
                return True
        if timeout == -1:
            ok = self._inner.acquire(blocking)
        else:
            ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san.acquire_edge(id(self))
        return ok

    def release(self) -> None:
        sch = _SCHED
        if sch is not None and sch.lock_release(self):
            self._san.release_edge(id(self))
            self._inner.release()
            sch.after_release(self)   # the post-release scheduling point
            return
        self._san.release_edge(id(self))
        self._inner.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        if locked is not None:
            return locked()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    # -- threading.Condition protocol ---------------------------------------
    def _release_save(self):
        self._san.release_edge(id(self))
        if hasattr(self._inner, "_release_save"):
            return self._inner._release_save()
        self._inner.release()
        return None

    def _acquire_restore(self, saved):
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        self._san.acquire_edge(id(self))

    def _is_owned(self):
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def __repr__(self):
        if self.name:
            return "<HBLock %s %#x>" % (self.name, id(self))
        return "<HBLock %#x>" % id(self)


# -- tracked containers -------------------------------------------------------
class _TrackedMixin:
    """Shared access hooks; subclasses name their read/write ops."""

    def _hb_init(self, san: Sanitizer, name: str):
        self._hb_san = san
        self._hb_name = name

    def _hb(self, write: bool):
        self._hb_san.access(id(self), self._hb_name, write)


def _reads(*names):
    def deco(cls):
        for n in names:
            def make(n=n):
                base = getattr(cls.__mro__[1], n)

                def read_op(self, *a, **k):
                    self._hb(False)
                    return base(self, *a, **k)
                read_op.__name__ = n
                return read_op
            setattr(cls, n, make())
        return cls
    return deco


def _writes(*names):
    def deco(cls):
        for n in names:
            def make(n=n):
                base = getattr(cls.__mro__[1], n)

                def write_op(self, *a, **k):
                    self._hb(True)
                    return base(self, *a, **k)
                write_op.__name__ = n
                return write_op
            setattr(cls, n, make())
        return cls
    return deco


@_reads("__getitem__", "get", "__contains__", "__iter__", "__len__",
        "keys", "values", "items", "copy")
@_writes("__setitem__", "__delitem__", "pop", "popitem", "clear",
         "update", "setdefault")
class TrackedDict(dict, _TrackedMixin):
    def __init__(self, data, san, name):
        dict.__init__(self, data)
        self._hb_init(san, name)


@_reads("__getitem__", "get", "__contains__", "__iter__", "__len__",
        "keys", "values", "items", "copy")
@_writes("__setitem__", "__delitem__", "pop", "popitem", "clear",
         "update", "setdefault", "move_to_end")
class TrackedOrderedDict(OrderedDict, _TrackedMixin):
    def __init__(self, data, san, name):
        OrderedDict.__init__(self, data)
        self._hb_init(san, name)


@_reads("__getitem__", "__iter__", "__len__", "__contains__", "index",
        "count")
@_writes("__setitem__", "__delitem__", "append", "extend", "insert",
         "pop", "remove", "clear", "sort", "reverse")
class TrackedList(list, _TrackedMixin):
    def __init__(self, data, san, name):
        list.__init__(self, data)
        self._hb_init(san, name)


@_reads("__getitem__", "__iter__", "__len__", "__contains__")
@_writes("append", "appendleft", "extend", "extendleft", "pop",
         "popleft", "remove", "clear")
class TrackedDeque(deque, _TrackedMixin):
    def __init__(self, data, san, name):
        deque.__init__(self, data)
        self._hb_init(san, name)


def track(obj, name: str):
    """Wrap a hot shared container for race checking — identity when
    no sanitizer is active (the production path: one None test per
    CONSTRUCTION, zero per access)."""
    san = _ACTIVE
    if san is None or san.closed:
        return obj
    if isinstance(obj, OrderedDict):
        return TrackedOrderedDict(obj, san, name)
    if isinstance(obj, dict):
        return TrackedDict(obj, san, name)
    if isinstance(obj, list):
        return TrackedList(obj, san, name)
    if isinstance(obj, deque):
        return TrackedDeque(obj, san, name)
    return obj


def note_spsc(key, name: str, write: bool) -> None:
    """Probe for the shmlane rings' free-running indices and dead
    flag: a scheduling point under the controlled scheduler, plus
    single-writer enforcement for index WRITES (the only invariant a
    lock-free SPSC ring actually promises).  The dead flag is a sticky
    monotonic bit both sides may set, so it probes with
    ``write=False``.  No-ops to two global loads in production."""
    sch = _SCHED
    if sch is not None:
        sch.yield_point("spsc", name)
    san = _ACTIVE
    if san is not None and not san.closed and write:
        san.single_writer(key, name)


# -- the shim -----------------------------------------------------------------
class _Stamped:
    """Queue item carrying its producer's clock (put→get edge)."""

    __slots__ = ("item", "san", "snap")

    def __init__(self, item, san, snap):
        self.item = item
        self.san = san
        self.snap = snap


_UNWRAP_INSTALLED = False


def _ensure_unwrap_get():
    """Install the unwrapping ``queue.Queue.get`` ONCE, permanently: a
    queue stamped inside a shim block may still hold ``_Stamped``
    items when the block exits (a _ServerConn drain during teardown),
    and a restored plain ``get`` would hand the wrapper to the
    consumer.  The permanent form costs one isinstance test per get
    and only ever activates after the first shim use."""
    global _UNWRAP_INSTALLED
    if _UNWRAP_INSTALLED:
        return
    import queue as _queue
    orig_get = _queue.Queue.get

    def get(self, *a, **k):
        out = orig_get(self, *a, **k)
        if isinstance(out, _Stamped):
            san = _ACTIVE
            if san is not None and san is out.san:
                san.adopt(out.snap)
            return out.item
        return out

    _queue.Queue.get = get
    _UNWRAP_INSTALLED = True


@contextlib.contextmanager
def shim(strict: bool = False, san: Optional[Sanitizer] = None):
    """Monkeypatch ``threading.Lock``/``RLock`` (every lock constructed
    in the block is an :class:`HBLock` — Conditions and Events pick it
    up automatically), ``queue.Queue.put``/``get`` (per-item clock
    stamping) and ``Thread.start``/``join`` (fork/join edges), and
    activate :func:`track`.  Yields the :class:`Sanitizer`.

    Objects outlive the block safely: on exit the sanitizer closes, so
    escaped locks/containers keep working but stop recording."""
    global _ACTIVE
    import queue as _queue
    s = san if san is not None else Sanitizer(strict=strict)
    prev_active = _ACTIVE
    _ensure_unwrap_get()   # permanent: stamped items outlive the block
    orig_lock, orig_rlock = threading.Lock, threading.RLock
    orig_start, orig_join = threading.Thread.start, threading.Thread.join
    orig_put = _queue.Queue.put

    def make_lock():
        sch = _SCHED
        return HBLock(s, name=_lock_site() if sch is not None else None)

    def make_rlock():
        sch = _SCHED
        return HBLock(s, rlock=True,
                      name=_lock_site() if sch is not None else None)

    def start(self):
        sch = _SCHED if not s.closed else None
        if not s.closed:
            snap = s.publish_snapshot()
            orig_run = self.run
            if sch is not None:
                sch.thread_spawn(self)   # logical id = creation order

            def run():
                s.adopt(snap)
                if sch is not None:
                    sch.thread_begin(self)   # parks until scheduled
                try:
                    orig_run()
                finally:
                    self._hb_final = s.publish_snapshot()
                    if sch is not None:
                        sch.thread_end(self)
            self.run = run
        if sch is not None:
            # deterministic start: the _started handshake runs
            # passthrough, then a rendezvous + one scheduling point
            return sch.thread_start(self, orig_start)
        return orig_start(self)

    def join(self, timeout=None):
        sch = _SCHED
        if sch is not None:
            r = sch.thread_join(self, timeout)
            if r == "timeout":
                # the modeled wait consumed the budget; poke the real
                # join only to sync an already-exited thread state
                orig_join(self, 0.001)
                final = getattr(self, "_hb_final", None)
                if final is not None and not self.is_alive() \
                        and not s.closed:
                    s.adopt(final)
                return
        orig_join(self, timeout)
        final = getattr(self, "_hb_final", None)
        if final is not None and not self.is_alive() and not s.closed:
            s.adopt(final)

    def put(self, item, *a, **k):
        # stamping changes item identity, so only plain Queues (a
        # PriorityQueue's heap must compare raw items)
        if not s.closed and type(self) is _queue.Queue:
            item = _Stamped(item, s, s.publish_snapshot())
        return orig_put(self, item, *a, **k)

    threading.Lock = make_lock
    threading.RLock = make_rlock
    threading.Thread.start = start
    threading.Thread.join = join
    _queue.Queue.put = put
    _ACTIVE = s
    try:
        yield s
    finally:
        threading.Lock = orig_lock
        threading.RLock = orig_rlock
        threading.Thread.start = orig_start
        threading.Thread.join = orig_join
        _queue.Queue.put = orig_put
        _ACTIVE = prev_active
        s.closed = True
