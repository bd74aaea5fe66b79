"""Async parameter-server process: the backend of kvstore ``dist_async``.

PyTorch counterpart of ``mxnet_tpu/kvstore_server.py`` without elastic
membership (ROADMAP E2; reference: src/kvstore/kvstore_dist_server.h,
python/mxnet/kvstore_server.py:28-75).  A server applies each worker's
push to its stored weight the moment it arrives (the non-sync branch of
``DataHandleDefault``, kvstore_dist_server.h:405-430):

* transport: one framed message per request over TCP: the binary codec
  (:mod:`.wirecodec`) for the hot ops, a pickled skeleton with raw
  tensor buffers for the rest, decoded through a class allowlist.  The
  frames are the JAX package's, so a worker of either package talks to
  a server of the other; the marker classes go on the wire under the
  JAX package's names (``mxnet_tpu.kvstore_server._Buf`` ...), which
  this module maps to its own classes without importing that package.
* apply: one store lock (the reference server's run loop is serial
  too), exactly-once replay through a per-client dedup window, barriers
  by per-rank sequence numbers, heartbeat ages in barrier failures.
* placement: the store and the updater live on the HOST (``cpu()``, the
  port's optimizer over CPU tensors), by design: the JAX package's
  launcher pins its servers to the CPU (tools/launch.py) and the
  reference gives servers no GPU context, so a server never creates a
  CUDA context and the card belongs to the workers.

The roster and handoff ops answer as the JAX package's non-elastic
server answers them (roster ops: "not the roster coordinator"); asking
for ``elastic=True`` or ``MXNET_KVSTORE_ELASTIC`` raises, naming E2.

Process model: ``tools/launch.py -s S`` starts S copies of the user's
command with ``DMLC_ROLE=server``; importing :mod:`mxnet_tpu_torch` in
such a process enters the blocking server loop and exits when the job
is torn down (:func:`_init_kvstore_server_module`, the reference's
``_init_kvstore_server_module``).

Worker-side counterpart: :class:`mxnet_tpu_torch.kvstore.KVStoreDistAsync`.
"""
from __future__ import annotations

import os
import pickle
import socket
import struct
import sys
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from . import faultinject
from . import profiler as _prof
from . import tracing as _tr
from . import wirecodec as _codec
from . import health as _health
from .analysis import hb as _hb
from .base import MXNetError, env as _env
from .compression import (RowSparsePayload, WirePayload,
                          decompress as _decompress,
                          validate_rowsparse as _validate_rowsparse)

# reference command codes (kvstore_dist_server.h:44-45): kStopServer=-1
# tears down, kSyncMode=-2 switches the reference server to sync
# aggregation (a documented no-op here — this server IS the async mode,
# and doubles as the channel-flush sync token), and any head >= 0 routes
# to the controller (CommandHandle :150-162), where head 0 carries the
# pickled optimizer (python/mxnet/kvstore.py set_optimizer).
K_CONTROLLER = 0
K_STOP_SERVER = -1
K_SYNC_MODE = -2


# -- wire frame ---------------------------------------------------------------
# A message is ONE frame:
#
#     >Q  total length of everything after this field
#     >I  skeleton length S
#     S bytes   pickled SKELETON: the message with every ndarray replaced
#               by a _Buf(index, dtype, shape) placeholder
#     ...       the raw tensor buffers, concatenated in index order
#
# Tensors therefore never pass through pickle: the sender writes each
# array's memoryview straight to the socket (no tobytes() copy) and the
# receiver maps np.frombuffer views over one contiguous read.  The
# skeleton — the only remaining pickled bytes from a peer — is decoded
# through a class-allowlisted Unpickler (below).


class _Buf:
    """Skeleton placeholder for a raw tensor buffer riding after it."""

    __slots__ = ("i", "dtype", "shape")

    def __init__(self, i, dtype, shape):
        self.i = i
        self.dtype = dtype
        self.shape = tuple(shape)

    def __reduce__(self):
        return (_Buf, (self.i, self.dtype, self.shape))

    @property
    def nbytes(self):
        return (int(np.prod(self.shape, dtype=np.int64))
                * np.dtype(self.dtype).itemsize)


def _pack(obj, bufs):
    """Replace every ndarray in ``obj`` with a _Buf placeholder,
    appending the (contiguous) array to ``bufs``.  Object-dtype arrays
    cannot ride a raw buffer and stay in the skeleton."""
    if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
        # NOTE: ascontiguousarray promotes 0-d to 1-d — keep the
        # logical shape from the original array
        arr = np.ascontiguousarray(obj)
        ref = _Buf(len(bufs), arr.dtype.str, obj.shape)
        bufs.append(arr)
        return ref
    if isinstance(obj, tuple):
        return tuple(_pack(x, bufs) for x in obj)
    if isinstance(obj, list):
        return [_pack(x, bufs) for x in obj]
    if isinstance(obj, dict):
        return {k: _pack(v, bufs) for k, v in obj.items()}
    if isinstance(obj, WirePayload):
        return WirePayload(obj.kind, obj.shape, obj.threshold,
                           _pack(obj.data, bufs))
    if isinstance(obj, RowSparsePayload):
        return RowSparsePayload(_pack(obj.indices, bufs), obj.nrows,
                                _pack(obj.data, bufs))
    return obj


def _unpack(obj, body, offsets):
    if isinstance(obj, _Buf):
        return np.frombuffer(
            body, dtype=np.dtype(obj.dtype),
            count=int(np.prod(obj.shape, dtype=np.int64)),
            offset=offsets[obj.i]).reshape(obj.shape)
    if isinstance(obj, tuple):
        return tuple(_unpack(x, body, offsets) for x in obj)
    if isinstance(obj, list):
        return [_unpack(x, body, offsets) for x in obj]
    if isinstance(obj, dict):
        return {k: _unpack(v, body, offsets) for k, v in obj.items()}
    if isinstance(obj, WirePayload):
        return WirePayload(obj.kind, obj.shape, obj.threshold,
                           _unpack(obj.data, body, offsets))
    if isinstance(obj, RowSparsePayload):
        return RowSparsePayload(_unpack(obj.indices, body, offsets),
                                obj.nrows,
                                _unpack(obj.data, body, offsets))
    return obj


def _collect_bufs(obj, refs):
    if isinstance(obj, _Buf):
        refs.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _collect_bufs(x, refs)
    elif isinstance(obj, dict):
        for v in obj.values():
            _collect_bufs(v, refs)
    elif isinstance(obj, WirePayload):
        _collect_bufs(obj.data, refs)
    elif isinstance(obj, RowSparsePayload):
        _collect_bufs(obj.indices, refs)
        _collect_bufs(obj.data, refs)


# -- restricted deserialization ----------------------------------------------
# _recv_msg decodes bytes from ANY connected peer; a stock pickle.loads
# would let that peer name arbitrary importable callables (os.system,
# ...).  The pickled skeletons and blobs only ever reference the wire's
# marker classes, the optimizer-state array class, this package's own
# classes and a handful of numpy reconstruction helpers, so find_class
# admits exactly those (JAX package: kvstore_server.py:167-257).
_SAFE_BUILTINS = frozenset({
    "complex", "frozenset", "set", "slice", "range", "bytearray",
    "object", "tuple", "list", "dict",
})
_SAFE_GLOBALS = frozenset({
    ("collections", "OrderedDict"),
    ("numpy", "dtype"),
    ("numpy", "ndarray"),
    ("numpy._core.multiarray", "_reconstruct"),
    ("numpy._core.multiarray", "scalar"),
    ("numpy.core.multiarray", "_reconstruct"),   # older numpy pickles
    ("numpy.core.multiarray", "scalar"),
    ("copyreg", "_reconstructor"),
    ("copyreg", "__newobj__"),
    ("_codecs", "encode"),
})
# The wire marker classes and the optimizer-state array travel under the
# JAX package's names, so frames and state blobs read the same in either
# package; this map resolves them to the port's own classes (filled
# below, once the classes exist).
_WIRE_NAMES = {}
# Only CLASSES from these modules: the optimizer, scheduler and
# symbol objects a shipped optimizer carries.
_SAFE_MXT_MODULES = (
    "mxnet_tpu_torch.optimizer", "mxnet_tpu_torch.lr_scheduler",
    "mxnet_tpu_torch.ndarray", "mxnet_tpu_torch.initializer",
    "mxnet_tpu_torch.gluon.parameter",
    # Module.init_optimizer ships optimizers carrying sym/idx2name
    # context (reference: optimizer.py Optimizer attributes)
    "mxnet_tpu_torch.symbol", "mxnet_tpu_torch.attribute",
    "mxnet_tpu_torch.name",
)


def _env_allowlist():
    """Operator-extensible trust: MXNET_KVSTORE_PICKLE_ALLOWLIST is a
    comma-separated list of ``module`` or ``module:name`` entries (a
    bare module admits every name in it) -- the escape hatch for a
    user-defined optimizer class shipped to the servers (the launcher
    propagates the env to every role)."""
    raw = os.environ.get("MXNET_KVSTORE_PICKLE_ALLOWLIST", "")
    entries = []
    for item in raw.split(","):
        item = item.strip()
        if item:
            mod, _, name = item.partition(":")
            entries.append((mod, name or None))
    return entries


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        mapped = _WIRE_NAMES.get((module, name))
        if mapped is not None:
            return mapped
        if module == "builtins" and name in _SAFE_BUILTINS:
            return super().find_class(module, name)
        if (module, name) in _SAFE_GLOBALS:
            return super().find_class(module, name)
        if any(module == m or module.startswith(m + ".")
               for m in _SAFE_MXT_MODULES):
            import inspect
            obj = super().find_class(module, name)
            if inspect.isclass(obj):
                return obj
        for mod, ename in _env_allowlist():
            if module == mod and (ename is None or name == ename):
                return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"kvstore wire: refusing to unpickle {module}.{name} "
            "(not in the transport allowlist; for custom optimizer/"
            "updater classes set MXNET_KVSTORE_PICKLE_ALLOWLIST="
            f"{module}:{name} on every job role)")


def _restricted_loads(data):
    """pickle.loads through the transport allowlist -- for wire skeletons
    and peer-supplied control blobs (shipped optimizers, state blobs)."""
    import io
    return _RestrictedUnpickler(io.BytesIO(data)).load()


class _WirePickler(pickle._Pickler):
    """A pickler that writes the wire's marker classes and the
    optimizer-state array under the JAX package's names (the map
    :data:`_WIRE_NAMES` read backwards), everything else as usual."""

    def save_global(self, obj, name=None):
        alias = _WIRE_ALIASES.get(obj)
        if alias is None:
            return super().save_global(obj, name)
        self.save(alias[0])
        self.save(alias[1])
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _wire_dumps(obj, protocol=pickle.HIGHEST_PROTOCOL):
    """``pickle.dumps(obj, protocol)`` with the wire's names (frame
    skeletons take the highest protocol, state blobs the default, as in
    the JAX package)."""
    import io
    buf = io.BytesIO()
    _WirePickler(buf, protocol=protocol).dump(obj)
    return buf.getvalue()


from .optimizer import (_JAX_ARRAY, _JAX_NDARRAY,  # noqa: E402
                        _JaxNDArray, _reconstruct_array)
_WIRE_NAMES.update({
    ("mxnet_tpu.kvstore_server", "_Buf"): _Buf,
    ("mxnet_tpu.compression", "WirePayload"): WirePayload,
    ("mxnet_tpu.compression", "RowSparsePayload"): RowSparsePayload,
    _JAX_NDARRAY: _JaxNDArray,
    _JAX_ARRAY: _reconstruct_array,
})
_WIRE_ALIASES = {cls: name for name, cls in _WIRE_NAMES.items()
                 if name != _JAX_ARRAY}


def _set_nodelay(sock):
    """Disable Nagle on a kvstore data socket.  A frame is two-plus
    ``sendall`` calls (header+skeleton, then each raw tensor buffer);
    with Nagle on, the small header write can sit in the kernel waiting
    on the peer's delayed ACK before the tensor bytes follow — a
    ~40 ms-class stall per frame on a real network (docs/PERF_NOTES.md
    round 9).  Loopback never shows it, which is exactly why it must be
    set unconditionally at connect/accept rather than found later on a
    chip."""
    import socket as _socket
    try:
        sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
    except (OSError, AttributeError):
        pass   # non-TCP socket (tests stub with socketpairs)


def _iov_max() -> int:
    try:
        return min(int(os.sysconf("SC_IOV_MAX")), 1024)
    except (AttributeError, OSError, ValueError):
        return 16


_IOV_MAX = _iov_max()


def _send_vec(sock, parts) -> int:
    """Write ``parts`` (bytes-likes) in order with as few syscalls as
    possible: vectored ``sendmsg`` chunked at IOV_MAX with a partial-
    send resume loop, or per-part ``sendall`` when the platform lacks
    sendmsg / MXNET_KVSTORE_SENDMSG=0.  Returns the syscall count."""
    # drop zero-length parts BEFORE casting (empty iovecs would stall
    # the loop, and casting a 0-in-shape ndarray view raises)
    parts = [m.cast("B") for m in (memoryview(p) for p in parts)
             if m.nbytes]
    n = 0
    if not (_env("MXNET_KVSTORE_SENDMSG", 1)
            and hasattr(sock, "sendmsg")):
        for p in parts:
            sock.sendall(p)
            n += 1
        return n
    i = 0
    while i < len(parts):
        sent = sock.sendmsg(parts[i:i + _IOV_MAX])
        n += 1
        while sent > 0:
            pn = parts[i].nbytes
            if sent >= pn:
                sent -= pn
                i += 1
            else:
                parts[i] = parts[i][sent:]
                sent = 0
    return n


def _frame_parts(obj, binary_ok):
    """Encode ``obj`` into its on-wire frame as an ordered list of
    bytes-likes plus counter meta ``(parts, frame_bytes, codec_bytes,
    pickle_bytes)``.  The socket path scatter-gathers the parts through
    ``sendmsg`` (:func:`_send_msg`); receivers self-discriminate on the
    first byte (0xB1 = v2 binary frame, 0x00 = the legacy pickle
    frame's ``>Q`` high byte)."""
    if binary_ok and _codec.is_hot(obj):
        enc = _codec.encode_frame(obj)
        if enc is not None:
            head, bufs = enc
            total = len(head) + sum(a.nbytes for a in bufs)
            return [head] + list(bufs), total, len(head) - 13, 0
    bufs = []
    skel = _wire_dumps(_pack(obj, bufs))
    total = 4 + len(skel) + sum(a.nbytes for a in bufs)
    # header as its own buffer — NOT `header + skel`, which would
    # copy the whole skeleton to save one iovec
    parts = [struct.pack(">QI", total, len(skel)), skel]
    parts += bufs
    return parts, 8 + total, 0, len(skel)


def _send_msg(sock, obj, fi_role=None, byte_kind="sent"):
    """Zero-copy framed send: the registry-generated binary codec for
    hot messages on negotiated connections (wirecodec frame v2), the
    skeleton-pickle frame for everything else — one vectored syscall
    per frame either way (_send_vec).  ``fi_role`` tags DATA-channel
    traffic for the deterministic fault-injection hooks ("client" may
    be severed at an exact message, "server" may delay acks); untagged
    sends (heartbeats, hellos) are exempt so a plan hits only what it
    targets.  ``byte_kind`` names the byte counter family the frame
    lands in: the default "sent" is the TCP data wire to the parameter
    servers; the hierarchical tier's in-host mesh channels count under
    "ici_sent" (or "shm_sent" when the same-host lane carries them),
    and control-plane traffic (heartbeats, roster beats, hellos) under
    "control" so bench.py reports gradients, mesh, and control
    separately (profiler.wire_bytes_total / ici_bytes_total /
    shm_bytes_total / control_bytes_total)."""
    if fi_role == "client":
        faultinject.client_send(sock)
    elif fi_role == "server":
        faultinject.server_reply_delay()
        if faultinject.server_blackhole():
            # injected gray failure: the reply is swallowed, the
            # connection stays open — the caller believes it sent
            return
    parts, frame_bytes, codec_bytes, pickle_bytes = _frame_parts(
        obj, _codec.sock_binary(sock))
    if codec_bytes:
        _prof.record_serialization("codec_bytes", codec_bytes)
    if pickle_bytes and not _prof.is_control_byte_kind(byte_kind):
        _prof.record_serialization("pickle_bytes", pickle_bytes)
    _prof.record_channel_bytes(byte_kind, frame_bytes)
    _prof.record_serialization("send_syscalls", _send_vec(sock, parts))
    if fi_role == "client":
        faultinject.client_sent(sock)


def _recv_exact(sock, n):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return bytes(buf)


def _recv_msg(sock, fi_role=None, byte_kind="recv"):
    """Receive one frame of either format — a v2 binary frame's first
    byte is the 0xB1 magic, a legacy pickle frame's is the always-zero
    high byte of its ``>Q`` total, so the receiver self-discriminates
    and accepts both regardless of negotiation (which only gates what
    a sender emits)."""
    if fi_role == "client":
        faultinject.client_recv(sock)
    hdr = _recv_exact(sock, 12)
    if hdr[0] == _codec.FRAME_MAGIC:
        hdr += _recv_exact(sock, 1)
        total, desc_len = struct.unpack(">QI", hdr[1:13])
        if desc_len + 4 > total:
            raise ValueError("wirecodec: descriptor overruns frame")
        desc = _recv_exact(sock, desc_len)
        body = _recv_exact(sock, total - 4 - desc_len)
        _prof.record_channel_bytes(byte_kind, 9 + total)
        return _codec.decode_frame(desc, body)
    total, skel_len = struct.unpack(">QI", hdr)
    skel = _restricted_loads(_recv_exact(sock, skel_len))
    body = _recv_exact(sock, total - 4 - skel_len)
    _prof.record_channel_bytes(byte_kind, 8 + total)
    refs = []
    _collect_bufs(skel, refs)
    if not refs:
        return skel
    offsets, off = {}, 0
    for ref in sorted(refs, key=lambda r: r.i):
        offsets[ref.i] = off
        off += ref.nbytes
    return _unpack(skel, body, offsets)


class KVStoreServer:
    """One async parameter-server shard.

    Holds a slice of the key space (workers route each key to
    ``crc32(key) % num_servers``); applies the installed optimizer to
    every arriving gradient immediately (async SGD), or stores the pushed
    value verbatim when no optimizer is installed (the reference's
    assign-on-merge semantics, kvstore_local.h:173).
    """

    def __init__(self, server_id=0, num_workers=1,
                 host="127.0.0.1", port=0, hb_timeout=None,
                 elastic=None, uri=None):
        if elastic or (elastic is None
                       and _env("MXNET_KVSTORE_ELASTIC", False)):
            raise MXNetError(
                "kvstore server: elastic membership (MXNET_KVSTORE_ELASTIC)"
                " is not ported to mxnet_tpu_torch yet (ROADMAP E2)")
        self.server_id = server_id
        self.num_workers = num_workers
        # the hot shared containers are hb-tracked: identity in
        # production, race-checked wrappers under the happens-before
        # sanitizer's shim (mxnet_tpu.analysis.hb)
        self._store = _hb.track({}, "KVStoreServer._store")
        self._updater = None
        self._lock = threading.Lock()
        self._barrier_cv = threading.Condition()
        # barrier state is per-rank SEQUENCE-numbered, not a bare count:
        # an arrival (rank, b) is released once every live rank's
        # highest arrival reaches b.  In the common case (all ranks at
        # the same b) the last arrival releases everyone — exactly the
        # old counting behavior — but a worker whose barrier reply died
        # with a failing coordinator can RETRY the same logical barrier
        # (same b) against the successor idempotently, instead of
        # entering a phantom extra rendezvous that would skew every
        # later barrier and hang the job's final one.
        self._barrier_high = {}   # rank -> highest bseq arrived
        self._barrier_done = {}   # rank -> highest bseq released
        # joiners align to the cohort: a rank that joins (or rejoins)
        # mid-job may arrive with a sequence below the cohort's pending
        # rendezvous; its first arrival is offset there ONE-SHOT and
        # the offset rides the reply so the CLIENT adopts the effective
        # sequence — deliberately no server-side offset state, so a
        # failover successor starting empty loses nothing
        self._barrier_joined = set()   # ranks whose next arrival aligns
        # the client identity last seen BARRIERING per rank: a fresh
        # client generation under an old rank id (a job resumed against
        # live servers) starts a fresh sequence — stale release marks
        # must not no-op its first rendezvous
        self._barrier_client = {}
        self._stop = threading.Event()
        self._listener = socket.create_server((host, port))
        self._listener.settimeout(0.5)
        self.port = self._listener.getsockname()[1]
        self._threads = []
        self._conns = []
        # exactly-once: per-client (rank, nonce) dedup window.  A client
        # that reconnects replays its unacked request with the SAME
        # (client_id, seq); the cached reply is returned without
        # re-applying — a replayed push that was already applied is
        # acked idempotently (reference analog: ps-lite resender).
        # The channel is serial, so the live replay set is ONE envelope —
        # but the window must stay >= 2: a zombie connection's handler
        # can process its final buffered request AFTER the replay (and
        # the client's next request) completed on the new connection,
        # and that late duplicate must still hit the cache.  Pull
        # replies embed whole arrays, so the window is deliberately
        # small; client windows are LRU-capped too (a relaunched client
        # arrives under a fresh nonce and must not pin the old one).
        # With the PIPELINED client (MXNET_KVSTORE_WINDOW envelopes in
        # flight) a reconnect replays the whole window, so the reply
        # cache must cover it: default 2x the client window (plus the
        # zombie-duplicate slack), read from the same env the launcher
        # exports to every role.
        self._dedup_window = int(_env(
            "MXNET_KVSTORE_DEDUP_WINDOW",
            max(8, 2 * int(_env("MXNET_KVSTORE_WINDOW", 8)))))
        self._dedup_clients = 256
        self._dedup = _hb.track(OrderedDict(),
                                "KVStoreServer._dedup")
        self._dedup_cv = threading.Condition()
        self.dedup_count = 0          # replays served from the window
        # liveness: last ping (or enveloped request) per worker rank.
        # Barrier waits stay UNBOUNDED by design — but a rank that was
        # alive and went silent past hb_timeout turns the wait into an
        # error naming the missing ranks instead of blocking forever.
        self._hb_timeout = float(
            hb_timeout if hb_timeout is not None
            else _env("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", 15.0))
        self._hb_seen = {}            # rank -> last monotonic timestamp
        # extension ops: subsystems riding the kvstore wire (the serving
        # tier) register additional envelope types here instead of
        # forking the frame/allowlist/exactly-once stack.  Dispatch is
        # the LAST resort in _handle, so an extension can never shadow a
        # core op.
        self._ext_ops = {}
        self.uri = uri or f"{host}:{self.port}"
        # the non-elastic server's answers to the cold ops it shares
        # with the elastic plane: roster beats bank a peer's snapshot and
        # counters (newest sequence wins), handoffs apply once per
        # (wire key, generation)
        self._peer_snapshots = _hb.track(
            {}, "KVStoreServer._peer_snapshots")
        self._peer_stats = _hb.track({}, "KVStoreServer._peer_stats")
        self._handoff_gen = _hb.track(
            {}, "KVStoreServer._handoff_gen")
        self._handoff_state_gen = _hb.track(
            {}, "KVStoreServer._handoff_state_gen")
        self._handoff_base_gen = _hb.track(
            {}, "KVStoreServer._handoff_base_gen")

    def register_op(self, op: str, fn) -> None:
        """Register an extension envelope type: ``fn(msg, rank) ->
        reply payload``.  The handler runs under the same exactly-once
        envelope, allowlisted decode and error-reply contract as the
        built-in ops; core op names are reserved."""
        if op in ("ping", "init", "push", "push_multi", "pull",
                  "pull_rows", "pull_rowsparse", "assign",
                  "get_states", "set_states",
                  "command", "barrier", "req", "stats", "roster_get",
                  "roster_join", "roster_leave", "roster_dead",
                  "roster_beat", "roster_snapshot", "handoff",
                  "handoff_state", "ledger_report", "roster_fwd",
                  "codec_hello"):
            raise ValueError(f"cannot override core kvstore op {op!r}")
        self._ext_ops[op] = fn

    # -- request handlers ----------------------------------------------------
    def _apply_push(self, key, arr):
        """reference kvstore_dist_server.h:405-430: async branch applies the
        updater right away; a pushed value with no updater replaces the
        stored one (assign, not add).  A compressed payload (2bit/fp16
        wire mode) is dequantized here — the stored weight stays fp32."""
        if isinstance(arr, RowSparsePayload):
            return self._apply_push_sparse(key, arr)
        if isinstance(arr, WirePayload):
            arr = _decompress(arr)
        grad = _host_nd(arr)
        with self._lock:
            stored = self._store.get(key)
            if stored is None:
                raise KeyError(f"push to uninitialized key {key!r}")
            if self._updater is not None:
                # child of the srv.push envelope span: on the merged
                # timeline the optimizer apply separates from
                # decode/lock time (docs/OBSERVABILITY.md)
                # protocol: span(phase)
                with _tr.span("srv.updater_apply", cat="server"):
                    self._updater(_key_int(key), grad, stored)
            else:
                stored._set_data(grad._data)

    def _apply_push_sparse(self, key, p):
        """Row-sparse push: only the touched rows arrived.  Re-validate
        the descriptor here — the binary codec already gated it, but
        the pickle path has no decode-time check — then hand the
        updater a RowSparseNDArray so the optimizer's sparse impl
        touches exactly those rows (momentum rows included)."""
        from .ndarray.sparse import RowSparseNDArray
        _validate_rowsparse(p)
        data = p.data
        if isinstance(data, WirePayload):
            data = _decompress(data)
        idx = np.asarray(p.indices, dtype=np.int64)
        with self._lock:
            stored = self._store.get(key)
            if stored is None:
                raise KeyError(f"push to uninitialized key {key!r}")
            if p.nrows != int(stored.shape[0]):
                raise ValueError(
                    f"row-sparse push to key {key!r}: payload declares "
                    f"{p.nrows} rows, stored table has "
                    f"{int(stored.shape[0])}")
            if tuple(np.shape(data))[1:] != tuple(stored.shape)[1:]:
                raise ValueError(
                    f"row-sparse push to key {key!r}: row shape "
                    f"{tuple(np.shape(data))[1:]} does not match stored "
                    f"{tuple(stored.shape)[1:]}")
            if self._updater is not None:
                grad = RowSparseNDArray(_host_nd(data), _host_nd(idx),
                                        tuple(stored.shape))
                # protocol: span(phase)
                with _tr.span("srv.updater_apply", cat="server"):
                    self._updater(_key_int(key), grad, stored)
            elif idx.size:
                # assign semantics, restricted to the touched rows
                new = stored._data.clone()
                new[_host_tensor(idx)] = _host_tensor(data).to(new.dtype)
                stored._set_data(new)

    def _handle(self, msg, rank=None, client=None):
        op = msg[0]
        if op == "ping":  # protocol: replay(idempotent) reply(none)
            # heartbeat: out-of-band liveness (its own connection — the
            # data channel may legitimately block in a barrier)
            if len(msg) > 1:
                self._note_ping(msg[1])
            return None
        if op == "init":  # protocol: replay(idempotent) reply(none)
            # first init wins; later inits of the same key are ignored
            # (reference: the server keeps the first-arriving value,
            # kvstore_dist_server.h DataHandleDefault init path)
            _, key, arr = msg
            with self._lock:
                if key not in self._store:
                    self._store[key] = _host_nd(arr)
            return None
        if op == "push":  # protocol: replay(dedup-window) reply(none) codec(binary)
            _, key, arr = msg
            self._apply_push(key, arr)
            return None
        if op == "push_multi":  # protocol: replay(dedup-window) reply(none) codec(binary)
            # coalesced small-key push: one envelope, applied in order
            # (the worker groups sub-threshold keys bound for this shard
            # into a single frame — one RTT instead of K)
            _, entries = msg
            for key, arr in entries:
                self._apply_push(key, arr)
            return None
        if op == "assign":  # protocol: replay(idempotent) reply(none)
            # store the pushed value VERBATIM, bypassing any installed
            # updater, creating the key if absent.  Control-plane
            # metadata (the serving weight-version counter) must be a
            # plain register: routing it through "push" would hand it to
            # the SGD updater as a gradient.
            _, key, arr = msg
            if isinstance(arr, WirePayload):
                arr = _decompress(arr)
            with self._lock:
                stored = self._store.get(key)
                if stored is None:
                    self._store[key] = _host_nd(arr)
                else:
                    stored._set_data(_host_tensor(arr))
            return None
        if op == "pull":  # protocol: replay(pure) reply(ndarray) codec(binary)
            _, key = msg
            with self._lock:
                stored = self._store.get(key)
                if stored is None:
                    raise KeyError(f"pull of uninitialized key {key!r}")
                return _host_np(stored)
        if op == "pull_rows":  # protocol: replay(pure) reply(rows + full shape)
            # O(requested rows) row-sparse pull (reference:
            # DataHandleRowSparse, kvstore_dist_server.h:211 — only the
            # requested rows travel)
            _, key, ids = msg
            with self._lock:
                stored = self._store.get(key)
                if stored is None:
                    raise KeyError(f"pull of uninitialized key {key!r}")
                full = _host_np(stored)
                return full[ids], full.shape
        if op == "pull_rowsparse":  # protocol: replay(pure) reply(rows + full shape) codec(binary)
            # binary-codec row-sparse pull: the id list arrives as one
            # i64 tensor buffer and the row block replies zero-copy —
            # wire cost is rows_touched x row_bytes + 8 x rows_touched,
            # never the full table (reference: PullRowSparse)
            _, key, ids = msg
            ids = np.asarray(ids, dtype=np.int64).reshape(-1)
            with self._lock:
                stored = self._store.get(key)
                if stored is None:
                    raise KeyError(f"pull of uninitialized key {key!r}")
                full = _host_np(stored)
                if ids.size and (int(ids.min()) < 0
                                 or int(ids.max()) >= full.shape[0]):
                    raise ValueError(
                        f"pull_rowsparse of key {key!r}: row ids out of "
                        f"range for {full.shape[0]} rows")
                return np.ascontiguousarray(full[ids]), full.shape
        if op == "get_states":  # protocol: replay(pure) reply(states blob | None)
            # optimizer-state checkpointing: this shard's {key: state}
            # dict, optionally with the optimizer itself (reference:
            # server-side optimizer states live in the server,
            # kvstore_dist_server.h:131).  Return only keys the shard
            # OWNS (is in _store): set_states broadcasts the full merged
            # union to every server, so after further training the
            # updater also holds stale loaded copies of OTHER shards'
            # keys — without this filter a save→load→train→save flow
            # with ≥2 servers lets a stale copy overwrite the owner's
            # fresh state in the client-side merge (ADVICE r5).
            dump = bool(msg[1]) if len(msg) > 1 else False
            with self._lock:
                if self._updater is None:
                    return None
                states = self._updater.states
                if self._store:
                    owned = {_key_int(k) for k in self._store}
                    states = {k: v for k, v in states.items()
                              if k in owned}
                # an EMPTY store means this shard never saw an init/push
                # (pure load→save relay, e.g. checkpoint migration):
                # return everything — the client-side merge prefers each
                # key's OWNER, so these can never shadow fresh state
                return _states_blob(
                    states, self._updater.optimizer if dump else None)
        if op == "set_states":  # protocol: replay(idempotent) reply(none)
            _, blob = msg
            with self._lock:
                if self._updater is None:
                    raise RuntimeError(
                        "set_states before an optimizer was installed")
                # decode the peer-supplied blob through the transport
                # allowlist (Updater.set_states accepts the loaded dict)
                self._updater.set_states(_restricted_loads(blob))
            return None
        if op == "command":  # protocol: replay(idempotent) reply(none)
            _, head, body = msg
            return self._command(head, body)
        if op == "barrier":  # protocol: replay(idempotent) reply(generation | generation, realign)
            return self._barrier(rank, msg[1] if len(msg) > 1 else None,
                                 client=client)
        if op == "stats":  # protocol: replay(pure) reply(profiler snapshot + stats_bank)
            # the universal observability envelope: EVERY server (and
            # every subclass — the serving replica generalizes its old
            # serving_stats through this) answers with the full
            # profiler snapshot plus server identity and the last-
            # known-stats bank of its peers (docs/OBSERVABILITY.md)
            return self._stats_payload()
        if op in ("roster_get", "roster_join", "roster_leave",
                  "roster_dead", "roster_fwd"):  # protocol: replay(idempotent) reply(error)
            # the roster lives on an elastic job's coordinator (E2); a
            # static server answers as the JAX package's does
            raise RuntimeError(_NOT_COORDINATOR)
        if op == "roster_beat":  # protocol: replay(idempotent) reply(none)
            # a peer server's liveness beat, optionally carrying its
            # state snapshot and counters: banked, newest sequence wins
            _, suri, seq, snap = msg[:4]
            stats = msg[4] if len(msg) > 4 else None
            self._bank_peer_snapshot(suri, seq, snap)
            if stats is not None:
                self._bank_peer_stats(suri, seq, stats)
            return None
        if op == "roster_snapshot":  # protocol: replay(pure) reply(snapshot struct)
            _, ident = msg
            with self._lock:
                have = self._peer_snapshots.get(ident)
            if have is None:
                raise RuntimeError(_NOT_COORDINATOR)
            return have[1]
        if op == "ledger_report":  # protocol: replay(pure) reply(report dict)
            # ("ledger_report", True) is the SLIM form the promotion
            # sweep uses (generation + beat seq only); the bare op also
            # names the live key set, for operator forensics
            return self._ledger_report(
                slim=bool(msg[1]) if len(msg) > 1 else False)
        if op == "handoff":  # protocol: replay(per-generation) reply(applied bool)
            _, gen, wire_key, arr, bkey = msg
            return self._apply_handoff(int(gen), wire_key, arr, bkey)
        if op == "handoff_state":  # protocol: replay(per-generation) reply(applied bool)
            _, gen, wire_key, state, bkey = msg
            return self._apply_handoff_state(int(gen), wire_key, state,
                                             bkey)
        ext = self._ext_ops.get(op)
        if ext is not None:
            return ext(msg, rank)
        raise ValueError(f"unknown op {op!r}")

    # -- exactly-once delivery ----------------------------------------------
    def _traced_exactly_once(self, cid, seq, inner, wctx):
        """The exactly-once path under a server-side span.  ``wctx`` is
        the envelope's optional trace field ``(trace_id, parent
        span_id, client send epoch-us)``: with it the span is a CHILD
        of the worker-side call — and a REPLAYED envelope carries the
        original field, so reconnects annotate the same trace; with
        tracing on but an untraced client the span roots fresh.  The
        send stamp rides into span args for the merge tool's
        clock-offset estimate (tools/trace_merge.py --spans)."""
        if not _tr.enabled():
            return self._exactly_once(cid, seq, inner)
        op = inner[0] if isinstance(inner, (tuple, list)) and inner \
            else "?"
        args = None
        if wctx is not None and len(wctx) > 2:
            args = {"client_send_us": float(wctx[2])}
        sp = _tr.span_begin(
            "srv.%s" % op, cat="server",
            ctx=(wctx[0], wctx[1]) if wctx is not None else None,
            args=args)
        try:
            return self._exactly_once(cid, seq, inner)
        finally:
            _tr.span_end(sp)

    def _exactly_once(self, client_id, seq, inner):
        """Serve one enveloped request with at-most-once application.

        A replayed (client_id, seq) that already completed returns the
        CACHED reply (``dedup_count`` ticks); one still in flight on
        another connection thread (e.g. the original connection died
        while its handler blocks in a barrier) is WAITED for, never
        double-entered — the replay then also gets the cached reply."""
        cid = tuple(client_id) if isinstance(client_id, list) else client_id
        if isinstance(cid, tuple) and cid:
            self._note_ping(cid[0])   # any request is liveness evidence
        with self._dedup_cv:
            st = self._dedup.get(cid)
            if st is None:
                st = self._dedup[cid] = {"inflight": set(),
                                         "replies": OrderedDict()}
            self._dedup.move_to_end(cid)
            while len(self._dedup) > self._dedup_clients:
                old_cid, old_st = next(iter(self._dedup.items()))
                if old_st["inflight"]:
                    break   # never drop a window with work in flight
                self._dedup.popitem(last=False)
            while seq in st["inflight"] and not self._stop.is_set():
                self._dedup_cv.wait(0.1)
            if seq in st["replies"]:
                self.dedup_count += 1
                # a replayed envelope served from cache: mark it on the
                # trace — the replay carries the ORIGINAL trace field,
                # so this instant lands in the original trace, proving
                # the reconnect was absorbed idempotently
                # protocol: span(phase)
                _tr.instant("srv.dedup_hit", args={"seq": seq})
                return st["replies"][seq]
            st["inflight"].add(seq)
        rank = cid[0] if isinstance(cid, tuple) and cid else None
        reply = None
        try:
            try:
                reply = ("ok", self._handle(inner, rank=rank, client=cid))
            except Exception as exc:  # noqa: BLE001 — to the client
                reply = ("err", f"{type(exc).__name__}: {exc}")
        finally:
            # cache + un-inflight atomically: a replay racing this exact
            # moment must see either "in flight" or the cached reply,
            # never a gap it could re-apply through
            with self._dedup_cv:
                st["inflight"].discard(seq)
                if reply is not None:
                    st["replies"][seq] = reply
                    while len(st["replies"]) > self._dedup_window:
                        st["replies"].popitem(last=False)
                self._dedup_cv.notify_all()
        return reply

    # -- liveness ------------------------------------------------------------
    def _note_ping(self, rank):
        try:
            rank = int(rank)
        except (TypeError, ValueError):
            return
        with self._barrier_cv:
            self._hb_seen[rank] = time.monotonic()

    def _silent_ranks(self):
        """Worker ranks that HAVE been heard from and then went silent
        past hb_timeout.  A rank that never pinged is indistinguishable
        from one that is still starting up — never declared dead.
        Caller holds _barrier_cv."""
        if self._hb_timeout <= 0:
            return set()
        now = time.monotonic()
        live = self._live_worker_ranks()
        return {r for r, t in self._hb_seen.items()
                if r in live and now - t > self._hb_timeout}

    def _live_worker_ranks(self):
        return set(range(self.num_workers))

    def _heartbeat_ages(self, ranks):
        """Per-rank last-heartbeat age, for barrier failures that must
        carry EVIDENCE, not just rank ids.  Caller holds _barrier_cv."""
        now = time.monotonic()
        parts = []
        for r in sorted(ranks):
            t = self._hb_seen.get(r)
            parts.append("rank %s: %s" % (
                r, "never heard from" if t is None
                else "last heartbeat %.1fs ago" % (now - t)))
        return "; ".join(parts)

    def _ledger_report(self, slim=False):
        """This server's generation and beat sequence (a static server:
        the newest generation a handoff carried, 0 before any, and beat
        0), with its live key set unless ``slim``."""
        gen = 0
        with self._lock:
            # any generation this shard WITNESSED raises the floor: a
            # handoff applied at G proves G was issued even if no beat
            # reply ever carried it here (the coordinator can die within
            # one beat interval of issuing G — the correlated-preemption
            # window).  Without this the successor could resume AT G and
            # the per-(wire key, generation) handoff dedup would swallow
            # the next round's handoffs as duplicates.
            for d in (self._handoff_gen, self._handoff_state_gen,
                      self._handoff_base_gen):
                if d:
                    gen = max(gen, max(d.values()))
            keys = None if slim else sorted(self._store)
        out = {"uri": self.uri, "generation": int(gen),
               "beat_seq": 0}
        if keys is not None:
            out["keys"] = keys
        return out

    def _bank_peer_snapshot(self, uri, seq, snap):
        """Bank one peer's beat snapshot locally — the every-server half
        of the bank that must outlive server 0 (membership.bank_newest
        is the shared newest-seq-wins rule)."""
        from .membership import bank_newest
        with self._lock:
            bank_newest(self._peer_snapshots, uri, seq, snap)

    def _bank_peer_stats(self, uri, seq, stats):
        """Bank one peer's piggybacked counter snapshot (same
        newest-seq-wins rule as state snapshots; served by the "stats"
        envelope's stats_bank field)."""
        from .membership import bank_newest
        with self._lock:
            bank_newest(self._peer_stats, uri, seq, stats)

    def _stats_payload(self):
        """The ``("stats",)`` reply: the FULL profiler snapshot
        (dispatch/host-sync/channel counts, gauges, byte counters,
        latency rings, tracing state — profiler.snapshot is the one
        source every consumer shares) plus this server's identity and
        its last-known-stats bank of peers, which OUTLIVES any member's
        death the way the state-snapshot bank does.  Subclasses extend
        rather than replace (the serving replica adds its serving
        section on top)."""
        snap = _prof.snapshot()
        snap["server"] = {
            "server_id": self.server_id,
            "uri": self.uri,
            "num_workers": self.num_workers,
            "dedup_count": self.dedup_count,
            "elastic": False,
            "coordinator": False,
            "beat_seq": 0,
            "roster_generation": 0,
            # the store and the updater live on the host; this process
            # never makes a CUDA context (the reference's servers have
            # no GPU context)
            "device": "cpu",
            "cuda_initialized": torch.cuda.is_initialized(),
        }
        with self._lock:
            snap["stats_bank"] = {
                u: dict(entry[1], beat_seq=int(entry[0]))
                for u, entry in self._peer_stats.items()
                if isinstance(entry[1], dict)}
        return snap

    def _apply_handoff(self, gen, wire_key, arr, bkey):
        """Install a handed-off VALUE (the workers' quorum re-push, or a
        snapshot restripe).  First delivery per (wire_key, generation)
        wins; duplicates — every worker races to hand off the same
        bytes, and replays ride the exactly-once envelope on top — are
        acked without re-applying.  The first handoff of a logical key
        in a generation purges that key's stale wire forms (old stripe
        keys / whole-key form) plus their optimizer state, so a
        re-striped layout never leaves orphans behind."""
        if isinstance(arr, WirePayload):
            arr = _decompress(arr)
        with self._lock:
            if gen <= self._handoff_gen.get(wire_key, -1):
                _prof.record_channel_event("kvstore.handoff_dup")
                return False
            if self._handoff_base_gen.get(bkey, -1) < gen:
                self._handoff_base_gen[bkey] = gen
                stale = [k for k in self._store
                         if k == bkey or k.startswith(bkey + "@s")]
                for k in stale:
                    del self._store[k]
                    if self._updater is not None:
                        self._updater.states.pop(_key_int(k), None)
                        self._updater.states_synced.pop(_key_int(k), None)
            self._handoff_gen[wire_key] = gen
            self._store[wire_key] = _host_nd(arr)
        _prof.record_channel_event("kvstore.handoff_applied")
        return True

    def _apply_handoff_state(self, gen, wire_key, state, bkey):
        """Install handed-off OPTIMIZER STATE for one wire key (from the
        coordinator's snapshot of the departed server, restriped by the
        handing-off worker).  Same first-per-generation dedup as value
        handoff; a None state clears the slot so the optimizer re-creates
        fresh state (the non-row-decomposable fallback)."""
        idx = _key_int(wire_key)
        with self._lock:
            if self._updater is None:
                return False
            if gen <= self._handoff_state_gen.get(wire_key, -1):
                _prof.record_channel_event("kvstore.handoff_dup")
                return False
            self._handoff_state_gen[wire_key] = gen
            st = _state_to_nd(state)
            if st is None:
                self._updater.states.pop(idx, None)
                self._updater.states_synced.pop(idx, None)
            else:
                self._updater.states[idx] = st
                self._updater.states_synced[idx] = True
        _prof.record_channel_event("kvstore.handoff_state_applied")
        return True

    def _command(self, head, body):
        """reference kvstore_dist_server.h:149-162 ``CommandHandle``."""
        if head == K_STOP_SERVER:
            self._stop.set()
            with self._barrier_cv:
                self._barrier_cv.notify_all()
            return None
        if head == K_CONTROLLER:
            from . import optimizer as opt
            with self._lock:
                # peer-supplied blob: decode through the transport
                # allowlist, never stock pickle
                self._updater = opt.get_updater(_restricted_loads(body))
            return None
        return None  # kSyncMode etc.: accepted, no-op in the async server

    def _barrier_target_ranks(self):
        """The live worker ranks a barrier must rendezvous (re-read
        every evaluation, so an eviction mid-wait shrinks the set).
        Caller holds _barrier_cv."""
        return set(range(self.num_workers))

    def _barrier_release_locked(self):
        """Advance the per-rank release floor: an arrival ``(rank, b)``
        releases once every LIVE rank's highest arrival reaches ``b``
        (the floor).  Caller holds _barrier_cv; True when anything
        released."""
        live = self._barrier_target_ranks()
        if not live:
            return False
        floor = min(self._barrier_high.get(r, 0) for r in live)
        released = False
        for r, high in self._barrier_high.items():
            done = min(high, floor)
            if done > self._barrier_done.get(r, 0):
                self._barrier_done[r] = done
                released = True
        if released:
            self._barrier_cv.notify_all()
        return released

    def _barrier_released(self, rank, bseq):
        """Caller holds _barrier_cv."""
        return bseq <= self._barrier_done.get(rank, 0)

    def _barrier_floor_locked(self):
        """The cohort's release floor — min done over live ranks that
        have ARRIVED at least once (a not-yet-arrived fellow joiner
        must not drag the floor to zero).  A joining worker seeds its
        barrier sequence here, so raw client sequences are cohort-
        aligned from the first call.  Caller holds _barrier_cv."""
        live = self._barrier_target_ranks()
        arrived = [r for r in live if self._barrier_high.get(r, 0) > 0]
        if not arrived:
            return 0
        return min(self._barrier_done.get(r, 0) for r in arrived)

    def _barrier(self, rank=None, bseq=None, client=None):
        """Rendezvous every live worker (reference: Postoffice::Barrier).

        Arrivals carry a per-rank barrier SEQUENCE number ``bseq`` (the
        worker's count of barrier() calls; server-assigned
        ``high(rank)+1`` when absent): arrival ``(rank, b)`` is released
        once every live rank's highest arrival is >= ``b``.  In
        lockstep this is exactly the old counting barrier — the last
        arrival releases everyone — but it is additionally IDEMPOTENT:
        a worker whose barrier reply died with a failing COORDINATOR
        retries the same ``(rank, b)`` against the successor and is
        released immediately if the rendezvous already happened,
        instead of entering a phantom extra barrier that would skew
        every later rendezvous (and hang the job's final one).  That
        idempotence is what makes the barrier exact through the
        succession window.

        The wait itself stays UNBOUNDED (a slow worker is legal) — but
        when the heartbeat registry shows a missing rank went SILENT
        past hb_timeout:

        * **static roster** — the wait fails naming the dead ranks AND
          each one's last-heartbeat age (operators get evidence, not
          just ids);
        * **elastic coordinator** — the barrier RENEGOTIATES instead of
          failing: the silent rank is evicted (generation bump), the
          floor re-reads the live roster, and the parked survivors are
          released the moment the shrunken set has all arrived.
          Returns the roster generation so workers piggyback bump
          discovery on every barrier.  An evicted rank that was merely
          slow and arrives later is re-admitted (join, another bump)
          with a fresh barrier sequence."""
        # deterministic stall injection (faultinject.delay_barrier_release
        # / MXNET_FI_STALL_BARRIER_MS): delays THIS arrival's handling
        # before it registers, so every other rank's park — and this
        # rank's reply — stretch by exactly the armed delay.  The
        # CPU-testable wedge the health watchdog gates trip on.
        faultinject.barrier_stall()
        with self._barrier_cv:
            if client is not None and rank is not None:
                prev = self._barrier_client.get(rank)
                if prev is not None and prev != client:
                    # a NEW client generation is barriering under an
                    # old rank id (trainer resumed against live
                    # servers): its sequence restarts at 1, so it
                    # realigns exactly like a joiner — one-shot offset
                    # to the cohort's pending rendezvous, adopted
                    # client-side via the reply.  Without this the
                    # predecessors' release marks would turn the
                    # resumed job's first rendezvous into instant
                    # no-ops.
                    self._barrier_joined.add(rank)
                self._barrier_client[rank] = client
            if rank is None:
                # anonymous raw-message arrival: tracked under a
                # synthetic rank outside every live set — it waits for
                # the live workers' rendezvous without being waited for
                rank = -1
            joined = rank in self._barrier_joined
            self._barrier_joined.discard(rank)
            if joined:
                # align the joiner to the cohort's earliest pending
                # rendezvous: the ARRIVED live ranks' release floor + 1
                # (a fellow just-joined rank that has not arrived yet
                # must not drag the alignment down to rendezvous 1)
                others = [r for r in self._barrier_target_ranks()
                          if r != rank
                          and self._barrier_high.get(r, 0) > 0]
                first = (min(self._barrier_done.get(r, 0)
                             for r in others) + 1) if others else 1
            realign = 0
            if bseq is None:
                # server-assigned sequence (legacy raw arrivals, tests):
                # already in effective terms
                bseq = self._barrier_high.get(rank, 0) + 1
                if joined:
                    bseq = max(bseq, first)
            else:
                bseq = int(bseq)
                if joined and first > bseq:
                    # one-shot: this arrival runs at the cohort's
                    # sequence, and the offset rides the reply so the
                    # client bumps its own counter — raw sequences are
                    # globally aligned again from the next call, with
                    # no server-side offset to lose at a failover
                    realign = first - bseq
                    bseq = first
            self._barrier_high[rank] = max(
                self._barrier_high.get(rank, 0), bseq)
            self._barrier_release_locked()
            # the park (arrival -> release) is a span nested under the
            # srv.barrier envelope span: on the merged timeline the
            # rendezvous skew between ranks — and a renegotiation's
            # eviction window — reads directly off the park widths
            # protocol: span(phase)
            park = _tr.span_begin("srv.barrier_park", cat="server",
                                  args={"rank": rank, "bseq": bseq})
            # the park is a registered health wait: a rendezvous parked
            # past MXNET_HEALTH_BARRIER_STALL_S trips the server-side
            # watchdog too, so BOTH halves of a wedged barrier degrade
            wtok = _health.wait_begin("srv.barrier_park")
            try:
                while not self._barrier_released(rank, bseq) \
                        and not self._stop.is_set():
                    self._barrier_cv.wait(0.1)
                    if self._barrier_released(rank, bseq) \
                            or self._stop.is_set():
                        break
                    live = self._barrier_target_ranks()
                    waiting_for = {r for r in live
                                   if self._barrier_high.get(r, 0) < bseq}
                    silent = self._silent_ranks() & waiting_for
                    if not silent:
                        continue
                    arrived = sorted(
                        r for r in live
                        if self._barrier_high.get(r, 0) >= bseq)
                    ages = self._heartbeat_ages(silent)
                    raise RuntimeError(
                        "barrier timed out: worker rank(s) %s missing "
                        "(no heartbeat for > %.1fs; %s); "
                        "arrived rank(s): %s"
                        % (sorted(silent), self._hb_timeout, ages,
                           arrived))
            finally:
                _tr.span_end(park)
                _health.wait_end(wtok)
            # the payload is the roster generation on an elastic
            # coordinator (E2), None on a static server
            return (None, realign) if realign else None


    # -- connection plumbing -------------------------------------------------
    def _serve_conn(self, conn):
        recv_kind = "recv"
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        msg = _recv_msg(conn, byte_kind=recv_kind)
                    except (ConnectionError, OSError):
                        return
                    reply_kind = "sent"
                    if msg and msg[0] == "req":
                        # client envelope: (op, client_id, seq, inner
                        # [, trace]) — the exactly-once path (reconnect
                        # + replay); the optional 5th element is the
                        # span context propagated from the worker
                        _, cid, seq, inner = msg[:4]
                        reply = self._traced_exactly_once(
                            cid, seq, inner,
                            msg[4] if len(msg) > 4 else None)
                        role = "server"
                    else:
                        # raw message (codec hellos, heartbeat pings,
                        # legacy callers): NOT fault-injection
                        # targetable — a delay-acks plan must never
                        # stall the liveness signal (faultinject.py's
                        # heartbeat-exemption contract)
                        hello = _codec.handle_hello(conn, msg)
                        if hello is not None:
                            reply = hello
                        else:
                            try:
                                reply = ("ok", self._handle(msg))
                            except Exception as exc:  # noqa: BLE001
                                reply = ("err",
                                         f"{type(exc).__name__}: {exc}")
                        role = None
                        if msg and msg[0] in ("ping", "roster_beat",
                                              "roster_leave"):
                            # these ops live on DEDICATED control
                            # sockets (heartbeat threads, beat loops) —
                            # latch this connection's byte family to
                            # "control" so wire_bytes_per_step measures
                            # gradients only.  codec_hello must NOT
                            # latch: every socket (incl. data) hellos
                            # once at connect
                            recv_kind = "control_recv"
                            reply_kind = "control"
                    try:
                        _send_msg(conn, reply, fi_role=role,
                                  byte_kind=reply_kind)
                    except (ConnectionError, OSError):
                        # the client died / reconnected while we worked:
                        # the reply stays in the dedup window, so the
                        # replay on the new connection is acked from
                        # cache — drop this connection only
                        return
        except Exception:  # noqa: BLE001 — conn died mid-reply
            pass

    def run(self):
        """Blocking accept loop; returns after a kStopServer command."""
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                if faultinject.server_accept(conn):
                    continue   # injected refusal: already closed
                _set_nodelay(conn)
                t = threading.Thread(target=self._serve_conn, args=(conn,),
                                     daemon=True)
                t.start()
                self._threads.append(t)
                self._conns.append(conn)
        finally:
            self._listener.close()

    def stop(self):
        self._stop.set()
        with self._barrier_cv:
            self._barrier_cv.notify_all()
        # close live connections too: a handler blocked in _recv_msg only
        # re-checks _stop after servicing a request, so without this a
        # "stopped" server still answers one more op per connection —
        # clients must see EOF promptly (and the crash-simulation tests
        # rely on exactly that)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass

    def start_background(self):
        """Run the accept loop in a daemon thread (in-process tests)."""
        # analysis: allow(bare-thread): a crash unwinds through run()'s finally, closing the listener — every client observes it as refused connects within its retry budget, and in-flight conns keep their own _serve_conn handlers
        t = threading.Thread(target=self.run, daemon=True)
        t.start()
        return t


def _key_int(k):
    try:
        return int(k)
    except (TypeError, ValueError):
        return k


_NOT_COORDINATOR = (
    "not the roster coordinator (roster ops go to slot 0 of the live "
    "roster of an elastic job; set MXNET_KVSTORE_ELASTIC=1)")


def _host_tensor(arr):
    """A wire array as a CPU tensor of its own (the frame's bytes are
    read-only and shared)."""
    return torch.from_numpy(np.array(arr, copy=True))


def _host_nd(arr):
    """A wire array as a CPU NDArray: the server's store and updater
    live on the host."""
    from .ndarray import NDArray
    return NDArray(_host_tensor(arr))


def _host_np(stored):
    """A stored CPU NDArray as numpy for a reply (bfloat16, which numpy
    lacks, as float32)."""
    t = stored._data
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _states_blob(states, optimizer=None):
    """An updater's ``{key: state}`` as the states blob both packages'
    ``Updater.set_states`` read (with the optimizer when given)."""
    from .optimizer import Optimizer, _numpy_state
    out = {k: tuple(None if st is None else _JaxNDArray(_numpy_state(st))
                    for st in Optimizer._state_tuple(v))
           for k, v in states.items()}
    return _wire_dumps((out, optimizer) if optimizer is not None else out,
                       pickle.DEFAULT_PROTOCOL)


def _state_to_nd(state):
    """Wire numpy state -> the CPU NDArray shapes Updater stores."""
    if state is None:
        return None
    if isinstance(state, np.ndarray):
        return _host_nd(state)
    if isinstance(state, (tuple, list)):
        parts = tuple(_state_to_nd(s) for s in state)
        return None if all(p is None for p in parts) else parts
    return None


def _init_kvstore_server_module():
    """Turn a ``DMLC_ROLE=server`` process into a blocking server, then
    exit — the reference hook verbatim (python/mxnet/kvstore_server.py:75:
    importing the library in a server-role process never returns to user
    code)."""
    if os.environ.get("DMLC_ROLE") != "server":
        return
    # This function blocks INSIDE `import mxnet_tpu_torch`, so the package
    # module would stay flagged as initializing forever, and any
    # connection thread that triggers `import mxnet_tpu_torch.*`
    # (pickle.loads of an optimizer does) would block on the parent
    # module's import lock.  The package body is fully executed at this
    # point (this hook is its last statement), so clear the flag, and
    # pre-import everything the request handlers touch.
    import mxnet_tpu_torch  # noqa: PLC0415 — self, already in sys.modules
    spec = getattr(mxnet_tpu_torch, "__spec__", None)
    if spec is not None:
        spec._initializing = False
    from . import optimizer as _opt  # noqa: F401 — handler dependency
    from . import ndarray as _nd     # noqa: F401
    sid = int(os.environ.get("DMLC_SERVER_ID", "0"))
    uris = os.environ.get("MXT_SERVER_URIS", "")
    num_workers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
    host, port, my = "127.0.0.1", 0, None
    if uris:
        my = uris.split(",")[sid]
        host, port = my.rsplit(":", 1)
        port = int(port)
        # loopback-advertised servers (local launcher) bind loopback ONLY
        # — _recv_msg unpickles from any peer, so never expose the port
        # beyond what the deployment needs; ssh-mode servers must accept
        # remote workers and bind all interfaces (trusted-cluster model,
        # see module docstring)
        if host not in ("127.0.0.1", "localhost"):
            host = "0.0.0.0"
    # identity on the roster = the ADVERTISED uri (the bind host may be
    # 0.0.0.0 in ssh mode; workers and the coordinator know us by the
    # launcher-assigned address)
    server = KVStoreServer(server_id=sid, num_workers=num_workers,
                           host=host, port=port, uri=my)
    print(f"kvstore server {sid} listening on port {server.port}",
          flush=True)
    server.run()
    sys.exit(0)
