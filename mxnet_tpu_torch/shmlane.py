"""Same-host shared-memory lane for the hierarchical tier.

The port's copy of ``mxnet_tpu/shmlane.py``: the header layout, the
record framing and the frames in the rings are the JAX package's byte
for byte, so a follower of either package shares a lane with a leader of
the other.  Under ``MXNET_KVSTORE_HIERARCHY`` the followers of a host
group talk to their leader over a channel of their own; on one host
that channel's frames need not cross a socket.  This module holds one
POSIX shared-memory segment per follower data connection with a pair of
SPSC byte rings (follower->leader requests, leader->follower replies),
carrying the EXACT frame bytes the socket would (wirecodec v2 binary
frames or the legacy pickle frames, first byte self-discriminating), so
envelope, dedup and replay semantics are untouched: a frame is one
memcpy into the ring and no socket syscall (``profiler.send_syscalls``
counts only socket writes).

**Negotiation** (`shm_hello`, a first-class wire op in the protocol
table): the FOLLOWER creates the segment right after the mesh channel
dials, then sends ``("shm_hello", <segment name>)`` enveloped over the
socket; a leader that can attach replies the lane version and serves
that connection's later frames from the ring, a leader that can't
(cross-host peer — the segment name doesn't resolve — or an old
leader that errs on the unknown op) leaves the connection on TCP.
``MXNET_KVSTORE_SHM`` gates the attempt: ``auto`` (default) tries when
the mesh endpoint is a local address, ``on``/``1`` always tries,
``off``/``0`` never.

**Window-1 contract.**  Mesh channels run a one-envelope window
(kvstore._ServerConn window=1), so requests and replies strictly
alternate: each ring holds at most one frame at a time, a frame too
big for the ring simply rides the socket for that round (no
reordering is possible with one envelope in flight), and ring-full
can't happen.  The lane refuses wider windows.

**Failure = the transport the channel already survives.**  A wedged
leader drain (injectable: MXNET_FI_SHM_WEDGE_AFTER) leaves the
follower's request sitting unconsumed; the follower's stall watchdog
(MXNET_KVSTORE_SHM_STALL_S) marks the lane dead in the shared header
and surfaces a ConnectionError into the ordinary reconnect path — the
channel re-dials a fresh socket and REPLAYS its window over TCP, and
the leader's per-client dedup keeps the replay exactly-once.  Closing
the old socket is what makes duplicate replies impossible: any reply
the leader raced onto the dying lane/socket dies with them.

**Ring layout** (all little-endian, u32 free-running indices):

    header[64]: magic 'MXSL' | version | flags (bit0 = lane dead) | _
                req ring desc {data_off, cap, widx, ridx}
                rsp ring desc {data_off, cap, widx, ridx}
    records:    u32 length | payload   (one wire frame per record)
                length 0xFFFFFFFF = wrap marker (skip to ring start);
                a tail gap < 4 bytes is an implicit skip both sides
                compute.

Indices are free-running mod 2^32 (u32 stores are single aligned
writes — never torn); the writer publishes payload bytes BEFORE its
widx store and the reader advances ridx only after copying out, which
on x86-TSO (and through the GIL in-process) is the whole memory-order
story.  Each ring is strictly single-producer/single-consumer: the
follower's IO thread vs the leader's acceptor thread that owns the
connection.
"""
from __future__ import annotations

import struct
import time

from .analysis import hb as _hb
from .base import MXNetError, env as _env

VERSION = 1
_MAGIC = 0x4D58534C          # 'MXSL'
_HEADER = 64
_WRAP = 0xFFFFFFFF
_M32 = 0xFFFFFFFF
_FLAG_DEAD = 0x1
# desc field offsets inside a 16-byte ring descriptor
_D_DATA, _D_CAP, _D_WIDX, _D_RIDX = 0, 4, 8, 12
_REQ_DESC, _RSP_DESC = 16, 32


def mode() -> str:
    """Normalized MXNET_KVSTORE_SHM: 'auto' | 'on' | 'off'."""
    raw = str(_env("MXNET_KVSTORE_SHM", "auto")).strip().lower()
    if raw in ("1", "on", "true", "yes"):
        return "on"
    if raw in ("0", "off", "false", "no", "none"):
        return "off"
    return "auto"


def _is_local_host(host: str) -> bool:
    """Best-effort 'does this mesh endpoint live on THIS host'.  The
    cheap pre-filter for auto mode only: a wrong True still fails
    safe (the leader's attach raises, the err reply keeps the
    connection on TCP), a wrong False just skips the optimization."""
    import socket
    h = (host or "").strip().lower()
    if h in ("localhost", "::1", "0.0.0.0", "") or h.startswith("127."):
        return True
    try:
        if h == socket.gethostname().lower():
            return True
        local = socket.gethostbyname_ex(socket.gethostname())[2]
        return socket.gethostbyname(h) in local
    except OSError:
        return False


def client_enabled(host: str) -> bool:
    """Should a follower ATTEMPT the lane against this mesh host?"""
    m = mode()
    if m == "off":
        return False
    if m == "on":
        return True
    return _is_local_host(host)


def ring_bytes() -> int:
    return max(64 * 1024,
               int(_env("MXNET_KVSTORE_SHM_RING_KB", 4096)) * 1024)


class _Ring:
    """One SPSC byte ring over a slice of the shared segment.  Not an
    owner — just index arithmetic over the lane's buffer; `desc` is
    the byte offset of its {data_off, cap, widx, ridx} descriptor."""

    __slots__ = ("_buf", "_desc", "_data", "_cap", "_tag")

    def __init__(self, buf, desc, tag=""):
        self._buf = buf
        self._desc = desc
        self._data = struct.unpack_from("<I", buf, desc + _D_DATA)[0]
        self._cap = struct.unpack_from("<I", buf, desc + _D_CAP)[0]
        self._tag = tag    # "<segment>.req" / "<segment>.rsp"

    @staticmethod
    def format(buf, desc, data_off, cap):
        struct.pack_into("<IIII", buf, desc, data_off, cap, 0, 0)

    def _widx(self):
        return struct.unpack_from("<I", self._buf, self._desc + _D_WIDX)[0]

    def _ridx(self):
        return struct.unpack_from("<I", self._buf, self._desc + _D_RIDX)[0]

    @property
    def cap(self):
        return self._cap

    def backlog(self) -> int:
        """Unconsumed bytes (record framing included)."""
        return (self._widx() - self._ridx()) & _M32

    def reader_pos(self) -> int:
        """The consumer's free-running index — the follower's stall
        watchdog snapshots it to see whether the leader is draining."""
        return self._ridx()

    def try_push(self, parts, total) -> bool:
        """Write one record (``parts`` concatenated, ``total`` bytes)
        or return False when it can't fit RIGHT NOW (window-1 traffic
        means that only ever happens for a frame bigger than the
        ring).  Single producer: only the channel's IO thread calls
        this."""
        cap = self._cap
        if total + 4 > cap:
            return False
        widx, ridx = self._widx(), self._ridx()
        # the ring is deliberately lock-free: the one invariant is one
        # writer thread per index, and the probe sits inside the
        # read-indices -> publish-widx window so the controlled
        # scheduler can preempt exactly there
        _hb.note_spsc(("shmring", self._tag, "widx"),
                      "shmlane.%s.widx" % (self._tag or "ring"), True)
        free = cap - ((widx - ridx) & _M32)
        pos = widx % cap
        room = cap - pos
        skip = 0
        if room < 4 + total:
            skip = room          # wrap: pad the tail, restart at 0
            pos = 0
        if free < skip + 4 + total:
            return False
        buf = self._buf
        if skip >= 4:
            struct.pack_into("<I", buf, self._data + (widx % cap), _WRAP)
        # payload before the length prefix is visible?  Order doesn't
        # matter within the record — the reader only looks past ridx
        # after the widx store below publishes the whole record.
        struct.pack_into("<I", buf, self._data + pos, total)
        off = self._data + pos + 4
        for p in parts:
            m = memoryview(p)
            n = m.nbytes
            if not n:    # casting a 0-in-shape ndarray view raises
                continue
            buf[off:off + n] = m.cast("B")
            off += n
        struct.pack_into("<I", buf, self._desc + _D_WIDX,
                         (widx + skip + 4 + total) & _M32)
        return True

    def try_pop(self):
        """Pop one whole record as bytes, or None when the ring is
        empty.  Single consumer: only the acceptor thread owning the
        connection (leader side) / the IO thread (follower side)."""
        buf = self._buf
        cap = self._cap
        while True:
            widx, ridx = self._widx(), self._ridx()
            _hb.note_spsc(("shmring", self._tag, "ridx"),
                          "shmlane.%s.ridx" % (self._tag or "ring"),
                          True)
            used = (widx - ridx) & _M32
            if used == 0:
                return None
            pos = ridx % cap
            room = cap - pos
            if room < 4:
                # implicit tail skip (writer never starts a prefix here)
                struct.pack_into("<I", buf, self._desc + _D_RIDX,
                                 (ridx + room) & _M32)
                continue
            length = struct.unpack_from("<I", buf, self._data + pos)[0]
            if length == _WRAP:
                struct.pack_into("<I", buf, self._desc + _D_RIDX,
                                 (ridx + room) & _M32)
                continue
            if length + 4 > used or length + 4 > room:
                raise MXNetError(
                    f"shm ring corruption: record length {length} "
                    f"exceeds ring state (used={used}, room={room})")
            rec = bytes(buf[self._data + pos + 4:
                            self._data + pos + 4 + length])
            struct.pack_into("<I", buf, self._desc + _D_RIDX,
                             (ridx + 4 + length) & _M32)
            return rec


# segments created by THIS process — an in-process attach (tests run
# leader and follower in one interpreter) must not unregister a name
# the creator side still owns with the resource tracker
_CREATED_HERE: set = set()


class ShmLane:
    """One follower<->leader lane: a shared segment with the request
    and reply rings.  ``create`` (follower, owns/unlinks the segment)
    or ``attach`` (leader) — see the module docstring for the
    protocol."""

    def __init__(self, shm, created):
        self._shm = shm
        self._buf = shm.buf
        self.created = created
        self.name = shm.name
        self._closed = False
        self._stall = None     # (reader_pos snapshot, monotonic)
        if created:
            cap = (shm.size - _HEADER) // 2
            cap -= cap % 8
            _Ring.format(self._buf, _REQ_DESC, _HEADER, cap)
            _Ring.format(self._buf, _RSP_DESC, _HEADER + cap, cap)
            struct.pack_into("<IIII", self._buf, 0,
                             _MAGIC, VERSION, 0, 0)
        else:
            magic, version = struct.unpack_from("<II", self._buf, 0)
            if magic != _MAGIC:
                raise MXNetError(
                    f"shm lane {shm.name}: bad magic 0x{magic:08x}")
            if version != VERSION:
                raise MXNetError(
                    f"shm lane {shm.name}: version {version} != "
                    f"{VERSION} (mixed builds on one host?)")
        self._req = _Ring(self._buf, _REQ_DESC, "%s.req" % shm.name)
        self._rsp = _Ring(self._buf, _RSP_DESC, "%s.rsp" % shm.name)

    # -- lifecycle --------------------------------------------------------
    @classmethod
    def create(cls, nbytes=None):
        """Follower side: allocate a fresh auto-named segment holding
        both rings (the name travels in shm_hello)."""
        from multiprocessing import shared_memory
        size = _HEADER + 2 * max(8 * 1024,
                                 (nbytes or ring_bytes()))
        shm = shared_memory.SharedMemory(create=True, size=size)
        _CREATED_HERE.add(shm.name)
        return cls(shm, created=True)

    @classmethod
    def attach(cls, name):
        """Leader side: map the follower's segment by name.  Raises
        (FileNotFoundError and friends) for a cross-host peer — the
        caller errs the hello and the connection stays on TCP.  The
        attacher must NOT be tracked by multiprocessing's resource
        tracker: on this Python, SharedMemory registers every mapping
        unconditionally, and a tracked attacher exiting would unlink a
        segment its creator still owns (plus leak warnings)."""
        from multiprocessing import shared_memory
        shm = shared_memory.SharedMemory(name=name)
        if shm.name not in _CREATED_HERE:
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(shm._name, "shared_memory")
            except Exception:  # noqa: BLE001 — tracker detail, best-effort
                pass
        return cls(shm, created=False)

    def mark_dead(self):
        """Publish lane death in the shared header — both sides poll
        it; the survivor stops serving the rings immediately."""
        if self._closed:
            return
        # sticky monotonic bit BOTH sides may set — a yield point but
        # not a single-writer probe
        _hb.note_spsc(("shmdead", self.name), "shmlane.dead", False)
        try:
            flags = struct.unpack_from("<I", self._buf, 8)[0]
            struct.pack_into("<I", self._buf, 8, flags | _FLAG_DEAD)
        except (ValueError, struct.error):
            pass

    def dead(self) -> bool:
        if self._closed:
            return True
        _hb.note_spsc(("shmdead", self.name), "shmlane.dead", False)
        try:
            return bool(struct.unpack_from("<I", self._buf, 8)[0]
                        & _FLAG_DEAD)
        except (ValueError, struct.error):
            return True

    def close(self):
        """Unmap this side's view (idempotent).  The creator's close
        also unlinks — see destroy."""
        if self._closed:
            return
        self._closed = True
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass

    def destroy(self):
        """Tear the lane down for good: unmap, and (creator only)
        unlink the segment name.  The leader's mapping — if any —
        stays valid until its own close; POSIX keeps unlinked segments
        alive while mapped."""
        self.close()
        if self.created:
            try:
                self._shm.unlink()
            except (OSError, FileNotFoundError):
                pass
            _CREATED_HERE.discard(self.name)

    # -- frame traffic ----------------------------------------------------
    def _send(self, ring, kind, obj, binary_ok) -> bool:
        from . import profiler as _prof
        from .kvstore_server import _frame_parts
        if self._closed or self.dead():
            return False
        parts, frame_bytes, codec_bytes, pickle_bytes = _frame_parts(
            obj, binary_ok)
        try:
            if not ring.try_push(parts, frame_bytes):
                return False    # oversized frame: this round rides TCP
        except (ValueError, struct.error):
            return False        # buffer yanked under us (teardown race)
        if codec_bytes:
            _prof.record_serialization("codec_bytes", codec_bytes)
        if pickle_bytes:
            _prof.record_serialization("pickle_bytes", pickle_bytes)
        # ring bytes land in the shm_ family; NO send_syscalls — the
        # whole point is that nothing crossed a socket
        _prof.record_channel_bytes(kind, frame_bytes)
        return True

    def _recv(self, ring, kind):
        from . import profiler as _prof
        from . import wirecodec as _codec
        from .kvstore_server import _frame_obj
        if self._closed:
            return None
        rec = ring.try_pop()
        if rec is None:
            return None
        if len(rec) < 13 or _codec.frame_len(rec[:13]) != len(rec):
            raise MXNetError(
                f"shm lane {self.name}: ring record of {len(rec)} bytes "
                f"is not one wire frame — lane corrupt")
        _prof.record_channel_bytes(kind, len(rec))
        return _frame_obj(rec)

    def send_request(self, obj, binary_ok=True) -> bool:
        """Follower→leader.  True = the frame is in the ring."""
        return self._send(self._req, "shm_sent", obj, binary_ok)

    def recv_request(self):
        """Leader side: pop one request frame, or None.  The armed
        MXNET_FI_SHM_WEDGE_AFTER plan gates each would-succeed pop."""
        from . import faultinject
        if self._closed or self._req.backlog() == 0:
            return None
        if not faultinject.shm_drain_gate():
            return None
        return self._recv(self._req, "shm_recv")

    def send_reply(self, obj, binary_ok=True) -> bool:
        """Leader→follower.  False = caller replies over the socket."""
        return self._send(self._rsp, "shm_sent", obj, binary_ok)

    def recv_reply(self):
        return self._recv(self._rsp, "shm_recv")

    # -- follower stall watchdog ------------------------------------------
    def request_backlog(self) -> int:
        return self._req.backlog()

    def drain_stalled(self, budget_s: float) -> bool:
        """True when the request ring has sat NON-EMPTY with no reader
        progress for ``budget_s`` seconds — the leader stopped
        draining (wedged, descheduled for good, or dead without
        closing).  Progress resets the clock, an empty ring clears
        it."""
        if self._req.backlog() == 0:
            self._stall = None
            return False
        pos = self._req.reader_pos()
        now = time.monotonic()
        if self._stall is None or self._stall[0] != pos:
            self._stall = (pos, now)
            return False
        return (now - self._stall[1]) > budget_s
