"""Deterministic fault injection for the dist kvstore transport.


The port's copy of ``mxnet_tpu/faultinject.py`` (it imports nothing of
JAX), so the JAX package's failure tests port as they are.
The reference's ps-lite layer survives transient transport faults
(kvstore_dist.h:55 server-recovery mode); proving the same property here
needs faults that happen ON DEMAND, at an exact message, every run.  This
module is that switchboard: the kvstore client transport
(``kvstore._ServerConn``) and server (``kvstore_server``) call the hooks
below from ``_send_msg`` / ``_recv_msg`` / the accept loop, and a test —
or an env-configured worker process — arms a plan:

* **kill the connection** when the Nth data-channel message is about to
  be sent (``before_send``), has just been sent (``after_send`` — the
  request reached the server but its ack will be lost, so the replay
  must be deduped), or while awaiting its ack (``on_recv``);
* **delay acks** server-side (widens race windows deterministically);
* **refuse connects** client-side and/or **drop accepts** server-side
  (exercises connect/reconnect backoff);
* **kill the process** after exactly N enveloped replies
  (``kill_process_after_acks``) or at beat number N of the elastic beat
  loop (``kill_on_beat_seq``) — REAL SIGKILL, the preemption shape the
  elastic membership and coordinator-failover machinery must survive;
  target one server id (``MXNET_FI_ONLY_SERVER``) and/or the process
  currently holding the COORDINATOR role
  (``MXNET_FI_ONLY_COORDINATOR``, kept current across failovers by
  ``note_coordinator``).

Heartbeat channels are exempt (the hooks are only called with
``fi_role`` set on DATA-channel traffic), so a plan severs exactly the
request/reply stream the test targets.

Context managers for in-process tests::

    with faultinject.kill_connection_after(3, point="after_send"):
        kv.push("w", grad)          # 3rd message dies post-send
        kv.pull("w", out=out)       # reconnect + replay, exactly-once

Env activation for multi-process tests (read once at import; see
``tests/dist/dist_fault_injection.py``)::

    MXNET_FI_KILL_AFTER=5 MXNET_FI_KILL_POINT=after_send \
    MXNET_FI_ONLY_RANK=0  python tools/launch.py -n 2 -s 1 ...

All state is process-global and lock-guarded; ``reset()`` disarms
everything.  No plan armed = every hook is a cheap no-op.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time

KILL_POINTS = ("before_send", "after_send", "on_recv")

_lock = threading.RLock()


class _Plan:
    """The armed fault plan + its counters (guarded by _lock)."""

    def __init__(self):
        self.kill_after = None          # 1-indexed message to kill at
        self.kill_point = "before_send"
        self.kill_unacked = None        # sever when k envelopes in flight
        self.sent = 0                   # data-channel messages counted
        self.kills_fired = 0
        self.delay_ack_s = 0.0
        self.refuse_connects = 0        # remaining connects to refuse
        self.connects_refused = 0
        self.refuse_accepts = 0         # remaining accepts to drop
        self.accepts_refused = 0
        self.only_rank = None           # limit the plan to one worker rank
        self.kill_process_after = None  # SIGKILL self after n served acks
        self.acks_served = 0            # enveloped replies counted
        self.only_server = None         # limit process kill to one server id
        self.only_coordinator = False   # limit process kill to the
        #                                 CURRENT roster coordinator
        self.kill_on_beat_seq = None    # SIGKILL self at beat number n
        self.stall_barrier_s = 0.0      # injected barrier-arrival delay
        self.stall_barrier_times = 0    # remaining stalls to inject
        self.blackhole_after = None     # go reply-silent after n replies
        self.bh_seen = 0                # server replies counted
        self.blackholed = 0             # replies swallowed
        self.shm_wedge_after = None     # stop draining the shm ring
        #                                 after n popped frames
        self.shm_drained = 0            # lane frames drained so far
        self.shm_wedged = 0             # drains swallowed by the wedge


_plan = _Plan()

# Whether THIS process currently holds the elastic roster COORDINATOR
# role.  kvstore_server keeps it current (ctor role, every beat tick,
# and at failover promotion), so MXNET_FI_ONLY_COORDINATOR plans track
# the role across a succession instead of a fixed server id.
_is_coordinator = False


def note_coordinator(flag: bool) -> None:
    """Record whether this process is the roster coordinator right now
    (called by kvstore_server; the ONLY_COORDINATOR filter reads it)."""
    global _is_coordinator
    _is_coordinator = bool(flag)


def _rank_active():
    if _plan.only_rank is None:
        return True
    return os.environ.get("DMLC_WORKER_ID", "0") == str(_plan.only_rank)


def _server_active():
    if _plan.only_server is not None and \
            os.environ.get("DMLC_SERVER_ID", "0") != str(_plan.only_server):
        return False
    if _plan.only_coordinator and not _is_coordinator:
        return False
    return True


def reset():
    """Disarm every fault and zero the counters."""
    global _plan
    with _lock:
        _plan = _Plan()


def stats() -> dict:
    """Counters for test assertions (kills fired, refusals served)."""
    with _lock:
        return {"kills_fired": _plan.kills_fired,
                "connects_refused": _plan.connects_refused,
                "accepts_refused": _plan.accepts_refused,
                "messages_seen": _plan.sent,
                "acks_served": _plan.acks_served,
                "replies_blackholed": _plan.blackholed,
                "shm_frames_wedged": _plan.shm_wedged}


def configure(kill_after=None, kill_point="before_send", delay_ack_s=0.0,
              refuse_connects=0, refuse_accepts=0, only_rank=None,
              kill_unacked=None, kill_process_after=None, only_server=None,
              only_coordinator=False, kill_on_beat_seq=None,
              stall_barrier_s=0.0, stall_barrier_times=1,
              blackhole_after=None, shm_wedge_after=None):
    """Arm a plan directly (the non-context-manager form; multi-process
    scripts use this after deciding per-rank what to inject)."""
    if kill_point not in KILL_POINTS:
        raise ValueError(f"kill_point must be one of {KILL_POINTS}, "
                         f"got {kill_point!r}")
    with _lock:
        _plan.kill_after = int(kill_after) if kill_after else None
        _plan.kill_point = kill_point
        _plan.kill_unacked = int(kill_unacked) if kill_unacked else None
        _plan.sent = 0
        _plan.kills_fired = 0
        _plan.delay_ack_s = float(delay_ack_s)
        _plan.refuse_connects = int(refuse_connects)
        _plan.connects_refused = 0
        _plan.refuse_accepts = int(refuse_accepts)
        _plan.accepts_refused = 0
        _plan.only_rank = only_rank
        _plan.kill_process_after = (int(kill_process_after)
                                    if kill_process_after else None)
        _plan.acks_served = 0
        _plan.only_server = only_server
        _plan.only_coordinator = bool(only_coordinator)
        _plan.kill_on_beat_seq = (int(kill_on_beat_seq)
                                  if kill_on_beat_seq else None)
        _plan.stall_barrier_s = float(stall_barrier_s)
        _plan.stall_barrier_times = (int(stall_barrier_times)
                                     if stall_barrier_s > 0 else 0)
        _plan.blackhole_after = (int(blackhole_after)
                                 if blackhole_after is not None else None)
        _plan.bh_seen = 0
        _plan.blackholed = 0
        _plan.shm_wedge_after = (int(shm_wedge_after)
                                 if shm_wedge_after is not None else None)
        _plan.shm_drained = 0
        _plan.shm_wedged = 0


@contextlib.contextmanager
def kill_connection_after(n, point="before_send"):
    """Sever the data channel at the Nth message (1-indexed), once."""
    if point not in KILL_POINTS:
        raise ValueError(f"point must be one of {KILL_POINTS}, got {point!r}")
    with _lock:
        _plan.kill_after = int(n)
        _plan.kill_point = point
        _plan.sent = 0
        _plan.kills_fired = 0
    try:
        yield
    finally:
        with _lock:
            _plan.kill_after = None
            _plan.sent = 0


@contextlib.contextmanager
def kill_when_unacked(k):
    """Sever the data channel the first time ``k`` envelopes are in
    flight (sent, unacked) at once — the mid-WINDOW kill for the
    pipelined transport: the reconnect must replay all ``k`` in seq
    order, exactly-once."""
    with _lock:
        _plan.kill_unacked = int(k)
    try:
        yield
    finally:
        with _lock:
            _plan.kill_unacked = None


@contextlib.contextmanager
def kill_process_after_acks(n):
    """SIGKILL THIS PROCESS the moment it has served ``n`` enveloped
    data-channel replies — REAL process death (no atexit, no socket
    shutdown handshake, no Python unwind), the preemption shape the
    elastic-membership machinery must survive.  Heartbeat pings and raw
    messages are exempt, so the count is deterministic: it advances
    only on the exactly-once request stream.  Env form:
    ``MXNET_FI_KILL_PROCESS_AFTER`` (+ ``MXNET_FI_ONLY_SERVER`` to
    target one DMLC_SERVER_ID in a launcher-spawned job)."""
    with _lock:
        _plan.kill_process_after = int(n)
        _plan.acks_served = 0
    try:
        yield
    finally:
        with _lock:
            _plan.kill_process_after = None


@contextlib.contextmanager
def kill_on_beat_seq(n):
    """SIGKILL THIS PROCESS when its elastic beat loop sends beat number
    ``n`` — the deterministic BEAT-boundary kill point.  The enveloped-
    ack count (``kill_process_after_acks``) is the right dial for a
    data-shard server, but the COORDINATOR also serves barrier
    rendezvous and roster ops whose ack ordering is timing-dependent;
    the beat seq is process-monotonic and advances only in the beat
    loop, so a coordinator death lands at an exact protocol boundary
    every run.  Env form: ``MXNET_FI_KILL_ON_BEAT_SEQ`` (compose with
    ``MXNET_FI_ONLY_SERVER`` / ``MXNET_FI_ONLY_COORDINATOR``)."""
    with _lock:
        _plan.kill_on_beat_seq = int(n)
    try:
        yield
    finally:
        with _lock:
            _plan.kill_on_beat_seq = None


@contextlib.contextmanager
def delay_barrier_release(ms, times=1):
    """Deterministically WEDGE the next ``times`` barrier rendezvous:
    the server sleeps ``ms`` milliseconds before registering the next
    arriving barrier request, so every other rank's park — and the
    delayed rank's own reply, hence its release — stretch by exactly
    that long.  The CPU-testable stall the ``mxnet_tpu.health``
    watchdogs exist for: no real wedge (dead peer, wedged lock) is
    needed to prove a trip fires within its budget.  Env form:
    ``MXNET_FI_STALL_BARRIER_MS`` (one stall; composes with
    ``MXNET_FI_ONLY_SERVER`` / ``MXNET_FI_ONLY_COORDINATOR``)."""
    with _lock:
        _plan.stall_barrier_s = float(ms) / 1000.0
        _plan.stall_barrier_times = int(times)
    try:
        yield
    finally:
        with _lock:
            _plan.stall_barrier_s = 0.0
            _plan.stall_barrier_times = 0


@contextlib.contextmanager
def blackhole_after_replies(n):
    """GRAY failure: serve ``n`` enveloped data-channel replies
    normally, then swallow every later one — the connection stays open,
    requests are still read and handled, heartbeats still ack, but no
    reply ever leaves.  To a liveness check the server looks perfectly
    healthy; to a caller every request stalls forever.  The stall shape
    a router's reply timeout (not its heartbeat feed) must catch.  Env
    form: ``MXNET_FI_BLACKHOLE_AFTER`` (composes with
    ``MXNET_FI_ONLY_SERVER`` / ``MXNET_FI_ONLY_COORDINATOR``)."""
    with _lock:
        _plan.blackhole_after = int(n)
        _plan.bh_seen = 0
        _plan.blackholed = 0
    try:
        yield
    finally:
        with _lock:
            _plan.blackhole_after = None
            _plan.bh_seen = 0


@contextlib.contextmanager
def shm_wedge_after_frames(n):
    """WEDGE the same-host shm lane: the leader drains ``n`` more ring
    frames normally, then stops popping — requests pile up unconsumed,
    exactly what a descheduled/deadlocked leader drain looks like.  The
    follower's stall watchdog (MXNET_KVSTORE_SHM_STALL_S) must notice
    the ring not moving and fail over to TCP via the ordinary
    reconnect-and-replay path, with zero lost envelopes — CPU-testable
    without a real hang.  Env form: ``MXNET_FI_SHM_WEDGE_AFTER``
    (composes with ``MXNET_FI_ONLY_RANK`` to target one leader)."""
    with _lock:
        _plan.shm_wedge_after = int(n)
        _plan.shm_drained = 0
        _plan.shm_wedged = 0
    try:
        yield
    finally:
        with _lock:
            _plan.shm_wedge_after = None
            _plan.shm_drained = 0


@contextlib.contextmanager
def delay_acks(seconds):
    """Sleep before every server reply (both sides keep working — this
    only stretches the ack latency, deterministically)."""
    with _lock:
        prev, _plan.delay_ack_s = _plan.delay_ack_s, float(seconds)
    try:
        yield
    finally:
        with _lock:
            _plan.delay_ack_s = prev


@contextlib.contextmanager
def refuse_connects(m):
    """Fail the next M client connect attempts with ConnectionRefused."""
    with _lock:
        _plan.refuse_connects = int(m)
    try:
        yield
    finally:
        with _lock:
            _plan.refuse_connects = 0


@contextlib.contextmanager
def refuse_accepts(m):
    """Close the next M server-accepted connections immediately."""
    with _lock:
        _plan.refuse_accepts = int(m)
    try:
        yield
    finally:
        with _lock:
            _plan.refuse_accepts = 0


# -- transport hooks (called by kvstore / kvstore_server) --------------------
def _sever(sock, point, n):
    try:
        sock.close()
    except OSError:
        pass
    raise ConnectionError(
        f"faultinject: connection killed at {point} of message #{n}")


def client_send(sock):
    """Before a data-channel message is written to the socket."""
    with _lock:
        if _plan.kill_after is None or not _rank_active():
            return
        _plan.sent += 1
        if _plan.sent != _plan.kill_after \
                or _plan.kill_point != "before_send":
            return
        _plan.kill_after = None     # fire once
        _plan.kills_fired += 1
        n = _plan.sent
    _sever(sock, "before_send", n)


def _client_post_send(sock, point):
    with _lock:
        if (_plan.kill_after is None or not _rank_active()
                or _plan.sent != _plan.kill_after
                or _plan.kill_point != point):
            return
        _plan.kill_after = None     # fire once
        _plan.kills_fired += 1
        n = _plan.sent
    _sever(sock, point, n)


def client_sent(sock):
    """After a data-channel message hit the socket (the ack-loss case:
    the server will apply the request, the client will never hear)."""
    _client_post_send(sock, "after_send")


def client_recv(sock):
    """Before blocking on a data-channel reply."""
    _client_post_send(sock, "on_recv")


def client_window(sock, unacked):
    """After a data-channel send, with the count of unacked envelopes
    currently in flight (the sliding-window depth)."""
    with _lock:
        if (_plan.kill_unacked is None or not _rank_active()
                or unacked < _plan.kill_unacked):
            return
        _plan.kill_unacked = None   # fire once
        _plan.kills_fired += 1
        n = _plan.sent
    _sever(sock, f"window_unacked[{unacked}]", n)


def client_connect(uri):
    """Before a data-channel connect/reconnect attempt."""
    with _lock:
        if _plan.refuse_connects <= 0 or not _rank_active():
            return
        _plan.refuse_connects -= 1
        _plan.connects_refused += 1
    raise ConnectionRefusedError(f"faultinject: refused connect to {uri}")


def server_accept(conn) -> bool:
    """Called with every accepted connection; True = injected refusal
    (the connection is already closed, skip serving it)."""
    with _lock:
        if _plan.refuse_accepts <= 0:
            return False
        _plan.refuse_accepts -= 1
        _plan.accepts_refused += 1
    try:
        conn.close()
    except OSError:
        pass
    return True


def server_reply_delay():
    """Called before every server reply send."""
    with _lock:
        d = _plan.delay_ack_s
    if d > 0:
        time.sleep(d)


def server_blackhole() -> bool:
    """Called before every server data-channel reply send; True =
    swallow the reply (the caller returns without writing a byte).
    Counts only the replies that reach this hook, so heartbeat acks and
    raw control replies (``fi_role=None`` sends) are exempt — exactly
    the gray-failure contract: liveness keeps answering while the
    request stream goes silent."""
    with _lock:
        if _plan.blackhole_after is None or not _server_active():
            return False
        _plan.bh_seen += 1
        if _plan.bh_seen <= _plan.blackhole_after:
            return False
        _plan.blackholed += 1
        return True


def shm_drain_gate() -> bool:
    """Called by the mesh leader's lane drain before each ring pop that
    has a frame waiting; False = the armed wedge swallows the drain
    (the ring appears stuck to the follower, whose stall watchdog then
    drives the TCP fallback).  Counts only pops that would have
    succeeded, so the wedge lands after exactly N delivered frames."""
    with _lock:
        if _plan.shm_wedge_after is None or not _rank_active():
            return True
        if _plan.shm_drained < _plan.shm_wedge_after:
            _plan.shm_drained += 1
            return True
        _plan.shm_wedged += 1
        return False


def barrier_stall():
    """Called by the server at every barrier arrival, BEFORE the
    arrival registers.  Fires the armed one-shot(s) of
    :func:`delay_barrier_release` — the sleep happens outside every
    lock, so only the stalled rendezvous (and the ranks parked on it)
    feel it."""
    with _lock:
        if _plan.stall_barrier_times <= 0 or _plan.stall_barrier_s <= 0 \
                or not _server_active():
            return
        _plan.stall_barrier_times -= 1
        d = _plan.stall_barrier_s
    time.sleep(d)


def _sigkill_self():
    """SIGKILL this process (separate function so in-process tests can
    monkeypatch the trigger without actually dying)."""
    import signal
    import sys
    sys.stdout.flush()
    sys.stderr.flush()
    os.kill(os.getpid(), signal.SIGKILL)


def server_replied():
    """Called after every ENVELOPED server reply hit the socket (raw
    messages and heartbeat pings are exempt, keeping the count
    deterministic).  Fires the armed process kill — SIGKILL, not an
    exception: elastic tests need real process death, with the served
    state genuinely lost."""
    with _lock:
        if _plan.kill_process_after is None or not _server_active():
            return
        _plan.acks_served += 1
        if _plan.acks_served < _plan.kill_process_after:
            return
        _plan.kill_process_after = None     # fire once
        _plan.kills_fired += 1
    _sigkill_self()


def server_beat(seq):
    """Called by the elastic beat loop with every beat it sends (the seq
    is process-monotonic across all peers).  Fires the armed beat-
    boundary SIGKILL — real process death at an exact beat number, the
    deterministic way to kill a COORDINATOR whose enveloped-ack count
    is timing-dependent (it serves barrier rendezvous)."""
    with _lock:
        if _plan.kill_on_beat_seq is None or not _server_active():
            return
        if int(seq) < _plan.kill_on_beat_seq:
            return
        _plan.kill_on_beat_seq = None       # fire once
        _plan.kills_fired += 1
    _sigkill_self()


def _arm_from_env():
    """One-shot env activation (multi-process tests: the launcher can't
    reach into a worker, but its environment can)."""
    ka = os.environ.get("MXNET_FI_KILL_AFTER")
    ku = os.environ.get("MXNET_FI_KILL_UNACKED")
    rc = os.environ.get("MXNET_FI_REFUSE_CONNECTS")
    ra = os.environ.get("MXNET_FI_REFUSE_ACCEPTS")
    dl = os.environ.get("MXNET_FI_DELAY_ACK_MS")
    kp = os.environ.get("MXNET_FI_KILL_PROCESS_AFTER")
    kb = os.environ.get("MXNET_FI_KILL_ON_BEAT_SEQ")
    sb = os.environ.get("MXNET_FI_STALL_BARRIER_MS")
    bh = os.environ.get("MXNET_FI_BLACKHOLE_AFTER")
    sw = os.environ.get("MXNET_FI_SHM_WEDGE_AFTER")
    orank = os.environ.get("MXNET_FI_ONLY_RANK")
    osrv = os.environ.get("MXNET_FI_ONLY_SERVER")
    ocoord = os.environ.get("MXNET_FI_ONLY_COORDINATOR")
    if not (ka or ku or rc or ra or dl or kp or kb or sb or bh or sw):
        return
    configure(
        kill_after=int(ka) if ka else None,
        kill_point=os.environ.get("MXNET_FI_KILL_POINT", "before_send"),
        kill_unacked=int(ku) if ku else None,
        delay_ack_s=float(dl) / 1000.0 if dl else 0.0,
        refuse_connects=int(rc) if rc else 0,
        refuse_accepts=int(ra) if ra else 0,
        only_rank=int(orank) if orank else None,
        kill_process_after=int(kp) if kp else None,
        only_server=int(osrv) if osrv else None,
        only_coordinator=bool(ocoord) and
        ocoord.lower() not in ("0", "false", "off", ""),
        kill_on_beat_seq=int(kb) if kb else None,
        stall_barrier_s=float(sb) / 1000.0 if sb else 0.0,
        blackhole_after=int(bh) if bh else None,
        shm_wedge_after=int(sw) if sw else None)


_arm_from_env()
