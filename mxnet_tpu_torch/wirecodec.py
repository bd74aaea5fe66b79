"""Registry-generated binary wire codec: pickle off the hot path.

The port's copy of ``mxnet_tpu/wirecodec.py`` (it imports nothing of
JAX): the same frames, byte for byte, so a worker of either package
talks to a server of the other.

The dist kvstore frame (kvstore_server.py) historically pickled a
message SKELETON per envelope — cheap next to the tensor bytes, but a
per-frame ``pickle.dumps``/``_restricted_loads`` round that the hot
ops (push/pull envelopes, their acks, mesh rounds, serving predicts)
pay millions of times per job.  This module replaces it with a flat
tag-encoded descriptor for exactly the ops the protocol registry
declares ``codec(binary)`` (mxnet_tpu.analysis.protocol — the op set
below is GENERATED from those declarations; ``analysis --check``
drift-fails a stale copy), so steady-state training and serving
serialize zero pickled bytes.

Frame layout v2 (binary)::

    0xB1      magic (one byte)
    >Q  total length of everything after this field
    >I  descriptor length D
    D bytes   tag-encoded DESCRIPTOR: the message with every ndarray
              replaced by a dtype+shape record
    ...       the raw tensor buffers, concatenated in ENCOUNTER order

The arithmetic after the magic byte is the classic ``>QI`` header
(total = 4 + D + sum of buffer bytes), and the receive side still maps
``np.frombuffer`` views over one contiguous body read.  A legacy
pickle frame's first byte is the high byte of its ``>Q`` total — i.e.
always ``0x00`` for any frame under 2**56 bytes — so the two formats
self-discriminate on the first byte and a receiver accepts BOTH at all
times.  Negotiation therefore only gates what a sender EMITS:

* a client opens every persistent connection with a raw (pickled)
  ``("codec_hello", 1)``; a new server registers the connection and
  replies ``("ok", <its version>)``; binary frames flow both ways.
* an old server answers ``("err", "ValueError: unknown op ...")`` and
  an old mesh leader acks raw messages with ``("ok", None)`` — both
  decode as version 0, and the connection stays pure pickle.
* ``MXNET_KVSTORE_CODEC=pickle`` pins either side to version 0 (the
  mixed-version escape hatch ci/run_ci.sh exercises); ``auto`` and
  ``binary`` negotiate.

Cold/extension traffic (roster, stats, handoff, shipped optimizers)
deliberately stays on the allowlisted pickle path — those payloads
carry real classes.  Only envelopes whose inner op is in the generated
``HOT_OPS`` set, and ``("ok"/"err", payload)`` replies, are binary-
eligible; anything the vocabulary below cannot express falls back to
pickle per message, never per job.

The decoder is hostile-input hardened to the same contract as the
restricted unpickler: any malformed length/count/dtype/overrun raises,
the serving loop drops that connection, and the server keeps serving
everyone else (tests/test_wirecodec.py mirrors the hostile-pickle
tests).
"""
from __future__ import annotations

import struct
import threading
import weakref

import numpy as np

from .base import env as _env
from .compression import RowSparsePayload, WirePayload, validate_rowsparse

# codec-table:begin (generated: python -m mxnet_tpu.analysis --codec-table)
HOT_OPS = frozenset({
    "mesh_collect",
    "mesh_push",
    "predict",
    "pull",
    "pull_rowsparse",
    "push",
    "push_multi",
})
CODEC_TABLE_FINGERPRINT = "f46bdbfc897f"
# codec-table:end

CODEC_VERSION = 1

# first byte of a v2 frame; a legacy pickle frame starts with the high
# byte of its >Q total, which is 0x00 for anything under 2**56 bytes
FRAME_MAGIC = 0xB1

HELLO_OP = "codec_hello"

# -- descriptor tags ----------------------------------------------------------
_T_NONE = 0x00
_T_TRUE = 0x01
_T_FALSE = 0x02
_T_INT = 0x03      # >q
_T_FLOAT = 0x04    # >d
_T_STR = 0x05      # >I utf-8 length + bytes
_T_BYTES = 0x06    # >I length + bytes
_T_TUPLE = 0x07    # >I count + items
_T_LIST = 0x08     # >I count + items
_T_DICT = 0x09     # >I count + (key, value) item pairs
_T_NDARRAY = 0x0A  # >B dtype-str length + dtype str + >B ndim + >q*ndim
_T_PAYLOAD = 0x0B  # WirePayload: kind, shape, threshold, data items
_T_ROWSPARSE = 0x0C  # RowSparsePayload: nrows, indices ndarray, data

_INT64_MIN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1
_MAX_DEPTH = 64
_MAX_NDIM = 32


class Unencodable(Exception):
    """The message contains something outside the codec vocabulary —
    the caller falls back to the pickle frame for this message."""


def codec_mode() -> str:
    """The MXNET_KVSTORE_CODEC knob, normalized: 'auto' and 'binary'
    negotiate the binary codec per connection; 'pickle' pins the
    legacy framing (never hellos, answers hellos with version 0)."""
    mode = str(_env("MXNET_KVSTORE_CODEC", "auto")).strip().lower()
    return mode if mode in ("auto", "binary", "pickle") else "auto"


def local_version() -> int:
    """The version this process advertises in hello replies."""
    return 0 if codec_mode() == "pickle" else CODEC_VERSION


# -- per-connection negotiation ----------------------------------------------
# sock -> negotiated peer version.  Weak keys: a connection's entry
# dies with the socket object, so reconnects (fresh sockets) start
# un-negotiated by construction and closed sockets never pin memory.
_neg_lock = threading.Lock()
_negotiated: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def register(sock, version) -> None:
    """Record that the peer on ``sock`` speaks codec ``version``.
    A 'pickle'-pinned process never registers — it neither sends nor
    advertises binary frames (it still DECODES them; the format is
    self-describing, and a hostile peer can emit either regardless)."""
    if codec_mode() == "pickle":
        return
    if not isinstance(version, int) or isinstance(version, bool):
        return
    if version >= 1:
        with _neg_lock:
            try:
                _negotiated[sock] = int(version)
            except TypeError:
                pass   # unweakrefable test double: stays pickle


def sock_binary(sock) -> bool:
    """True when this side may EMIT binary frames on ``sock``."""
    with _neg_lock:
        try:
            ver = _negotiated.get(sock)
        except TypeError:
            return False
    return ver is not None and ver >= 1


def hello_msg():
    return (HELLO_OP, CODEC_VERSION)


def is_hello(msg) -> bool:
    return (isinstance(msg, tuple) and len(msg) == 2
            and msg[0] == HELLO_OP)


def handle_hello(sock, msg):
    """Server side of the negotiation: when ``msg`` is a codec hello,
    register the peer's version for ``sock`` and return the reply to
    send; None when ``msg`` is any other message."""
    if not is_hello(msg):
        return None
    register(sock, msg[1])
    return ("ok", local_version())


def client_hello(sock, send_msg, recv_msg,
                 byte_kinds=("control", "control_recv")) -> int:
    """Client side: one synchronous hello round on a fresh connection
    (before any pipelined traffic).  Returns the peer's version — 0
    for old peers (an old server errs on the unknown op, an old mesh
    leader acks raw messages with ``("ok", None)``), in which case the
    connection simply stays pickle.  Never called when this process is
    pinned to pickle."""
    if codec_mode() == "pickle":
        return 0
    send_msg(sock, hello_msg(), byte_kind=byte_kinds[0])
    reply = recv_msg(sock, byte_kind=byte_kinds[1])
    ver = 0
    if (isinstance(reply, tuple) and len(reply) == 2
            and reply[0] == "ok" and isinstance(reply[1], int)
            and not isinstance(reply[1], bool)):
        ver = int(reply[1])
    if ver >= 1:
        register(sock, ver)
    return ver


# -- what goes binary ---------------------------------------------------------
def is_hot(obj) -> bool:
    """Binary-eligible messages: exactly-once envelopes whose inner op
    is registry-declared hot, and ``("ok"/"err", payload)`` replies
    (acks of hot envelopes; a cold reply that happens to fit the
    vocabulary rides along harmlessly).  Cold requests — roster ops,
    stats, handoffs, shipped optimizer blobs — stay pickle."""
    if not (isinstance(obj, tuple) and obj):
        return False
    if obj[0] == "req" and len(obj) >= 4:
        inner = obj[3]
        return (isinstance(inner, tuple) and bool(inner)
                and inner[0] in HOT_OPS)
    return obj[0] in ("ok", "err") and len(obj) == 2


# -- encode -------------------------------------------------------------------
def _enc(obj, out, bufs, depth=0):
    if depth > _MAX_DEPTH:
        raise Unencodable("nesting too deep")
    if obj is None:
        out.append(_T_NONE)
    elif obj is True:
        out.append(_T_TRUE)
    elif obj is False:
        out.append(_T_FALSE)
    elif type(obj) is int:
        if not (_INT64_MIN <= obj <= _INT64_MAX):
            raise Unencodable("int out of int64 range")
        out.append(_T_INT)
        out += struct.pack(">q", obj)
    elif type(obj) is float:
        out.append(_T_FLOAT)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        out.append(_T_STR)
        out += struct.pack(">I", len(raw))
        out += raw
    elif type(obj) is bytes:
        out.append(_T_BYTES)
        out += struct.pack(">I", len(obj))
        out += obj
    elif type(obj) is tuple or type(obj) is list:
        out.append(_T_TUPLE if type(obj) is tuple else _T_LIST)
        out += struct.pack(">I", len(obj))
        for x in obj:
            _enc(x, out, bufs, depth + 1)
    elif type(obj) is dict:
        out.append(_T_DICT)
        out += struct.pack(">I", len(obj))
        for k, v in obj.items():
            _enc(k, out, bufs, depth + 1)
            _enc(v, out, bufs, depth + 1)
    elif isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
        # same contiguity contract as the pickle frame's _pack: the
        # buffer is the C-contiguous copy/view, the LOGICAL shape is
        # the original's (ascontiguousarray promotes 0-d to 1-d)
        arr = np.ascontiguousarray(obj)
        dt = arr.dtype.str.encode("ascii")
        if len(dt) > 255 or arr.ndim > _MAX_NDIM \
                or len(obj.shape) > _MAX_NDIM:
            raise Unencodable("ndarray dtype/ndim outside codec bounds")
        out.append(_T_NDARRAY)
        out.append(len(dt))
        out += dt
        out.append(len(obj.shape))
        for dim in obj.shape:
            out += struct.pack(">q", dim)
        bufs.append(arr)
    elif isinstance(obj, WirePayload):
        out.append(_T_PAYLOAD)
        _enc(obj.kind, out, bufs, depth + 1)
        _enc(tuple(obj.shape) if obj.shape is not None else None,
             out, bufs, depth + 1)
        _enc(obj.threshold, out, bufs, depth + 1)
        _enc(obj.data, out, bufs, depth + 1)
    elif isinstance(obj, RowSparsePayload):
        # indices and value rows each ride as a zero-copy tensor
        # buffer; anything the ndarray branch can't express (e.g. a
        # _Buf placeholder from the pickle path) falls back there
        out.append(_T_ROWSPARSE)
        _enc(int(obj.nrows), out, bufs, depth + 1)
        if not isinstance(obj.indices, np.ndarray):
            raise Unencodable("row-sparse indices not an ndarray")
        _enc(obj.indices, out, bufs, depth + 1)
        _enc(obj.data, out, bufs, depth + 1)
    else:
        raise Unencodable(type(obj).__name__)


def encode_frame(obj):
    """Encode ``obj`` as one v2 frame: ``(head, bufs)`` where ``head``
    is the magic + ``>QI`` header + descriptor in ONE buffer (built in
    place — no header/skeleton concat copy) and ``bufs`` are the raw
    tensor buffers to follow in order.  None when the message falls
    outside the codec vocabulary (caller falls back to pickle)."""
    out = bytearray(13)
    bufs = []
    try:
        _enc(obj, out, bufs)
    except Unencodable:
        return None
    desc_len = len(out) - 13
    total = 4 + desc_len + sum(a.nbytes for a in bufs)
    out[0] = FRAME_MAGIC
    struct.pack_into(">QI", out, 1, total, desc_len)
    return out, bufs


# -- decode (hostile-input hardened) ------------------------------------------
class _Reader:
    __slots__ = ("desc", "pos", "body", "body_off")

    def __init__(self, desc, body):
        self.desc = desc
        self.pos = 0
        self.body = body
        self.body_off = 0

    def take(self, n):
        if n < 0 or self.pos + n > len(self.desc):
            raise ValueError("wirecodec: descriptor overrun")
        out = self.desc[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self):
        return self.take(1)[0]

    def u32(self):
        return struct.unpack(">I", self.take(4))[0]

    def i64(self):
        return struct.unpack(">q", self.take(8))[0]

    def remaining(self):
        return len(self.desc) - self.pos


def _dec(r, depth=0):
    if depth > _MAX_DEPTH:
        raise ValueError("wirecodec: descriptor nesting too deep")
    tag = r.byte()
    if tag == _T_NONE:
        return None
    if tag == _T_TRUE:
        return True
    if tag == _T_FALSE:
        return False
    if tag == _T_INT:
        return r.i64()
    if tag == _T_FLOAT:
        return struct.unpack(">d", r.take(8))[0]
    if tag == _T_STR:
        return r.take(r.u32()).decode("utf-8")
    if tag == _T_BYTES:
        return bytes(r.take(r.u32()))
    if tag in (_T_TUPLE, _T_LIST):
        n = r.u32()
        if n > r.remaining():   # every item costs >= 1 descriptor byte
            raise ValueError("wirecodec: container count overruns "
                             "descriptor")
        items = [_dec(r, depth + 1) for _ in range(n)]
        return tuple(items) if tag == _T_TUPLE else items
    if tag == _T_DICT:
        n = r.u32()
        if 2 * n > r.remaining():
            raise ValueError("wirecodec: dict count overruns descriptor")
        out = {}
        for _ in range(n):
            k = _dec(r, depth + 1)
            try:
                out[k] = _dec(r, depth + 1)
            except TypeError as exc:
                raise ValueError("wirecodec: unhashable dict key") \
                    from exc
        return out
    if tag == _T_NDARRAY:
        dt_raw = r.take(r.byte())
        try:
            dtype = np.dtype(dt_raw.decode("ascii"))
        except (TypeError, ValueError, UnicodeDecodeError) as exc:
            raise ValueError("wirecodec: bad dtype %r" % dt_raw) from exc
        if dtype.hasobject:
            raise ValueError("wirecodec: object dtype refused")
        ndim = r.byte()
        if ndim > _MAX_NDIM:
            raise ValueError("wirecodec: ndim %d over cap" % ndim)
        shape = tuple(r.i64() for _ in range(ndim))
        count = 1
        for dim in shape:
            if dim < 0:
                raise ValueError("wirecodec: negative dimension")
            count *= dim
        nbytes = count * dtype.itemsize
        if nbytes > len(r.body) - r.body_off:
            raise ValueError("wirecodec: tensor buffer overruns body")
        arr = np.frombuffer(r.body, dtype=dtype, count=count,
                            offset=r.body_off).reshape(shape)
        r.body_off += nbytes
        return arr
    if tag == _T_PAYLOAD:
        kind = _dec(r, depth + 1)
        shape = _dec(r, depth + 1)
        threshold = _dec(r, depth + 1)
        data = _dec(r, depth + 1)
        return WirePayload(kind, shape, threshold, data)
    if tag == _T_ROWSPARSE:
        nrows = _dec(r, depth + 1)
        if not isinstance(nrows, int) or isinstance(nrows, bool):
            raise ValueError("wirecodec: row-sparse nrows not an int")
        indices = _dec(r, depth + 1)
        data = _dec(r, depth + 1)
        try:
            return validate_rowsparse(
                RowSparsePayload(indices, nrows, data))
        except (ValueError, TypeError, OverflowError) as exc:
            raise ValueError(f"wirecodec: {exc}") from exc
    raise ValueError("wirecodec: unknown tag 0x%02x" % tag)


def decode_frame(desc, body):
    """Decode one v2 frame's descriptor + contiguous buffer body.
    Raises ValueError on ANY malformed input — the serving loops treat
    that exactly like a hostile pickle: connection dropped, server
    keeps serving (strict full consumption: trailing descriptor or
    body bytes are an error, not padding)."""
    r = _Reader(desc, body)
    obj = _dec(r)
    if r.pos != len(desc):
        raise ValueError("wirecodec: %d trailing descriptor byte(s)"
                         % (len(desc) - r.pos))
    if r.body_off != len(body):
        raise ValueError("wirecodec: %d trailing body byte(s)"
                         % (len(body) - r.body_off))
    return obj


def frame_len(prefix) -> int:
    """Frame-in-ring framing arithmetic: the COMPLETE byte length of
    the frame whose first 13 bytes begin ``prefix``, for either format.
    A v2 binary frame occupies 13 header bytes (magic + ``>QI``) plus
    ``total - 4`` descriptor/body bytes = ``9 + total``; a legacy
    pickle frame 12 header bytes plus ``total - 4`` = ``8 + total``.
    The same-host shm lane (the hierarchical tier's, ROADMAP E2) stores
    ONE frame per length-prefixed ring record, and both ends
    cross-check the record length against this before decoding —
    shared memory has no short reads, so a mismatch means ring
    corruption and kills the lane (TCP fallback), never a partial
    frame."""
    view = memoryview(prefix)
    if view.nbytes < 13:
        raise ValueError("wirecodec: frame prefix shorter than 13 bytes")
    if view[0] == FRAME_MAGIC:
        total, desc_len = struct.unpack(">QI", view[1:13])
        if desc_len + 4 > total:
            raise ValueError("wirecodec: descriptor overruns frame")
        return 9 + int(total)
    total, skel_len = struct.unpack(">QI", view[0:12])
    if skel_len + 4 > total:
        raise ValueError("wirecodec: skeleton overruns frame")
    return 8 + int(total)
