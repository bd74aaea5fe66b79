"""KVStore: key-value parameter synchronization.

PyTorch counterpart of ``mxnet_tpu/kvstore.py`` (reference:
include/mxnet/kvstore.h, src/kvstore/kvstore_local.h, kvstore_dist.h):

* ``local`` / ``device`` / ``nccl`` -- one process: ``push`` sums the
  pushed copies, then runs the updater on the stored value or stores
  the sum; ``pull``, ``assign``, ``row_sparse_pull`` and
  update-on-kvstore through ``set_optimizer``.
* ``dist_sync`` / ``dist_device_sync`` / ``dist`` -- several processes
  over the gloo group of :mod:`.distributed`: rank 0's init is
  broadcast, a push is summed across the processes in rank order
  (``distributed.allreduce_sum``) and every process applies the
  identical update, so the stores stay replicated with no server.
* ``dist_async`` -- :class:`KVStoreDistAsync`, the worker side of the
  parameter servers of :mod:`.kvstore_server`: pushes ride a pipelined
  channel per server (fire and forget), big arrays stripe across the
  servers, small keys bound for one server coalesce, pushes may be
  compressed (2-bit by the kernel Q1 on the card, with the residual
  kept there), and the servers run the optimizer.  Launch with
  ``tools/launch.py -n W -s S``.

torch tensors are mutable where JAX arrays are not, so the store never
shares a tensor with its caller: ``init``, ``assign`` and a ``push``
without an updater store a copy, ``pull`` copies into ``out``, and an
updater rebinds the store's own array.  Under
``MXNET_KVSTORE_ELASTIC`` the distributed store follows the live roster
of its servers (:mod:`.membership`): a channel failure repairs the
roster, re-derives the striping, hands off the moved keys' state and
re-pushes the logged gradients a dead server took with it.  Under
``MXNET_KVSTORE_HIERARCHY`` the workers of a host form a group
(``tools/launch.py --workers-per-host N``): the followers hand their
gradients to the group's leader (:class:`_MeshLeader`) over an in-host
channel, the shared-memory lane of :mod:`.shmlane` where it can be set
up, the leader sums them on its device and alone pushes the sum over
the wire (compressed there, by Q1 on the card), and the followers'
pulls are served from the leader's wire round.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
import warnings
from typing import Dict

import numpy as np
import torch

from .analysis import hb as _hb
from .base import MXNetError
from .compression import RowSparsePayload
from .ndarray import NDArray
from . import optimizer as opt
from . import tracing as _tr
from . import health as _health
# one key coercion for the worker's and the server's updater indexing
from .kvstore_server import _key_int as _key_int_impl

# the store types of one process (reference: kvstore.cc:34 Create)
LOCAL_TYPES = ("local", "local_allreduce_cpu", "local_allreduce_device",
               "device", "nccl")
DIST_TYPES = ("dist_sync", "dist_device_sync", "dist_async", "dist")
# the distributed store's stripe separator (membership.STRIPE_SEP),
# reserved in key names
_STRIPE_SEP = "@s"


def _key(k):
    return str(k)


def _write_row_sparse_out(outs, rows, idx, full_shape):
    """Put gathered rows (a tensor) and their ids (an int64 tensor) into
    each out array: a RowSparseNDArray is re-armed in place with the rows
    and their ids on its own device (nothing dense is built), a dense one
    becomes zeros with those rows set."""
    from .ndarray.sparse import RowSparseNDArray
    for o in outs:
        if isinstance(o, RowSparseNDArray):
            dev = o.data._data.device
            RowSparseNDArray.__init__(o, rows.to(dev, copy=True),
                                      idx.to(dev, copy=True),
                                      tuple(full_shape))
        else:
            dev = o._data.device
            dense = torch.zeros(tuple(full_shape), dtype=rows.dtype,
                                device=dev)
            o._set_data(dense.index_copy_(0, idx.to(dev), rows.to(dev)))


def _from_host(val, device, dtype=None):
    """A host numpy value (a wire reply's read-only view) as a tensor of
    its own on ``device``, cast to ``dtype`` when given."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # read-only buffer
        t = torch.from_numpy(np.asarray(val))
    if dtype is not None and t.dtype != dtype:
        return t.to(device=device, dtype=dtype)
    return t.to(device, copy=True)


def _host_np(a):
    """A follower's gradient as the host array its mesh_push frame
    carries (numpy as is; a tensor read back, bf16 as float32, which
    numpy lacks)."""
    if not isinstance(a, torch.Tensor):
        return np.ascontiguousarray(a)
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.detach().contiguous().cpu().numpy()


def _local_allreduce_sum(parts):
    """Sum one key's group contributions where the leader's gradient
    lives: the port's counterpart of the JAX package's
    ``parallel/mesh.py`` ``local_allreduce_sum``.  ``parts[0]`` is the
    leader's own gradient (a tensor on its device, or numpy); the
    followers' host parts are uploaded to that device and added to it
    in the JAX package's stack order, the leader first, then the
    contributions in ``collect_push`` order.  For two members that is
    one float32 add, bit for bit the JAX sum.  Returns a tensor on the
    leader's device (numpy when the leader's part is numpy)."""
    head = parts[0]
    if not isinstance(head, torch.Tensor):
        acc = np.asarray(head)
        for p in parts[1:]:
            acc = acc + np.asarray(p, dtype=acc.dtype)
        return acc
    acc = head.detach()
    for p in parts[1:]:
        if not isinstance(p, torch.Tensor):
            with warnings.catch_warnings():
                # a decoded frame's array is read-only; it is only read
                warnings.simplefilter("ignore", UserWarning)
                p = torch.from_numpy(np.ascontiguousarray(p))
        acc = acc + p.to(device=acc.device, dtype=acc.dtype)
    return acc


class KVStore:
    """The single-process store (reference: KVStoreLocal,
    kvstore_local.h), and the replicated ``dist_sync`` store over the
    gloo group."""

    def __init__(self, kvtype="local"):
        self.type = kvtype
        self._store: Dict[str, NDArray] = {}
        self._updater = None
        self._optimizer = None
        self._gcompress = None

    @property
    def _dist(self) -> bool:
        return self.type.startswith("dist")

    @property
    def rank(self) -> int:
        if not self._dist:
            return 0
        from . import distributed as _dist
        return _dist.rank()

    @property
    def num_workers(self) -> int:
        if not self._dist:
            return 1
        from . import distributed as _dist
        return _dist.size()

    def init(self, key, value):
        """Store a copy of each value; on a distributed store rank 0's
        value is authoritative (reference: the first worker's init wins,
        kvstore_dist_server.h)."""
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            if k in self._store:
                raise MXNetError(f"duplicate init of key {k}")
            val = vs[0]._data.detach().clone()
            if self._dist and self.num_workers > 1:
                from . import distributed as _dist
                val = _dist.broadcast_from_root(val.cpu()).to(val.device)
            self._store[k] = NDArray(val)

    def push(self, key, value, priority=0):
        """Sum the pushed copies of each key (and, on a distributed store,
        across the processes, in rank order), then run the updater on the
        stored value, or store the sum (reference: KVStoreLocal::PushImpl,
        kvstore_local.h:149; without an updater the store holds the sum,
        kvstore_local.h:173)."""
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            agg = self._reduce(vs)
            if self._dist and self.num_workers > 1:
                from . import distributed as _dist
                agg = _dist.allreduce_sum(agg.cpu()).to(agg.device)
            if k not in self._store:
                raise MXNetError(f"push to uninitialized key {k}")
            if self._updater is not None:
                self._updater(_key_int(k), NDArray(agg), self._store[k])
            else:
                self._store[k]._set_data(
                    agg.clone() if agg is vs[0]._data else agg)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Copy each stored value into its out array(s), on their devices
        (reference: KVStoreLocal::PullImpl)."""
        assert out is not None
        keys, outs = self._canon(key, out)
        for k, os_ in zip(keys, outs):
            if k not in self._store:
                raise MXNetError(f"pull of uninitialized key {k}")
            src = self._store[k]._data
            for o in os_:
                o._set_data(src.to(o._data.device, copy=True))

    def assign(self, key, value):
        """Store each value as it is, bypassing any updater, creating
        missing keys (the JAX package's control-plane register; no
        reference analog)."""
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            val = vs[0]._data.detach().clone()
            if k in self._store:
                self._store[k]._set_data(val)
            else:
                self._store[k] = NDArray(val)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names, deduplicated and sorted
        (reference: KVStoreLocal::PullRowSparseImpl): a RowSparseNDArray
        ``out`` gets the rows and their ids, a dense one zeros with those
        rows.  The ids are made unique on the store's device, which waits
        for the count."""
        assert out is not None and row_ids is not None
        keys, outs = self._canon(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        for k, os_, rid in zip(keys, outs, row_ids):
            _check_stripe_sep(self.type, k)
            if k not in self._store:
                raise MXNetError(f"pull of uninitialized key {k}")
            src = self._store[k]._data
            idx = torch.unique(rid._data.to(src.device, torch.int64))
            _write_row_sparse_out(os_, src.index_select(0, idx), idx,
                                  src.shape)

    def set_optimizer(self, optimizer):
        """Run ``optimizer`` inside the store on every push (reference:
        kvstore.py:353, update-on-kvstore)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def _set_updater(self, updater):
        self._updater = updater

    def set_gradient_compression(self, compression_params):
        """``{'type': '2bit', 'threshold': t}`` or ``{'type': 'fp16'}``
        (reference: kvstore.py set_gradient_compression, MXNet 0.12).  A
        local store refuses it, as the reference's does; a store with no
        wire (``dist_sync``) validates and records it; ``dist_async``
        compresses each push."""
        from .compression import GradientCompression
        if self.type.startswith("local"):
            raise MXNetError(
                "gradient compression is not supported for kvstore type "
                f"{self.type!r} (reference: local stores don't compress)")
        self._gcompress = GradientCompression(compression_params)

    def barrier(self):
        """Global barrier (reference: Postoffice::Barrier); nothing to wait
        for in one process."""
        from . import distributed as _dist
        _dist.barrier("mxnet_tpu_kvstore_barrier")

    def num_dead_nodes(self) -> int:
        """reference: kvstore.h:328.  The job-wide count: the gloo group
        has no partial failure; dist_async stores register theirs with
        :func:`distributed.num_dead_nodes`."""
        from . import distributed as _dist
        return _dist.num_dead_nodes()

    def server_stats(self, rank: int = 0) -> dict:
        """The profiler snapshot of "server" ``rank``: a store with no
        server processes is its own server, so the local process's
        ``profiler.snapshot()`` comes back (JAX package:
        kvstore.py:245-255).  :class:`KVStoreDistAsync` asks its
        servers."""
        from . import profiler as _prof
        if rank != 0:
            raise MXNetError(
                f"kvstore type {self.type!r} has no server rank {rank}")
        return _prof.snapshot()

    def _send_command_to_servers(self, head, body):
        """No server processes here (:class:`KVStoreDistAsync` sends)."""

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer installed")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer installed")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())

    @staticmethod
    def _reduce(vs):
        """The sum of the pushed copies, on the first one's device (a
        pushed sparse array is read dense, as in the JAX package)."""
        if len(vs) == 1:
            return vs[0]._data
        dev = vs[0]._data.device
        datas = [v._data.to(dev) for v in vs]
        if len(datas) == 2:
            return datas[0] + datas[1]
        return torch.sum(torch.stack(datas), dim=0)

    _key_int = staticmethod(_key_int_impl)

    @staticmethod
    def _canon(key, value):
        single = not isinstance(key, (list, tuple))
        keys = [key] if single else list(key)
        if single:
            values = [value if isinstance(value, (list, tuple)) else [value]]
        else:
            values = [v if isinstance(v, (list, tuple)) else [v]
                      for v in value]
        return [_key(k) for k in keys], values


_key_int = _key_int_impl


def _check_stripe_sep(kvtype, k):
    if _STRIPE_SEP in k:
        raise MXNetError(
            f"kvstore {kvtype}: key {k!r} contains the reserved stripe "
            f"separator '{_STRIPE_SEP}' - rename the parameter")


class _ServerConn:
    """Ordered async channel to one parameter server.

    Operations enqueue; one IO thread per server runs a SLIDING-WINDOW
    pipeline: up to ``MXNET_KVSTORE_WINDOW`` (default 8) envelopes are
    in flight at once, acks are consumed from the head of a FIFO of
    pending slots.  A ``push`` therefore returns before the server
    applies it (the async overlap the reference gets by running
    ``ZPush`` inside an engine async op, kvstore_dist.h:53-80) and a
    burst of N requests costs ~1 RTT instead of N — the pipelined
    ZPush/ZPull behavior of ps-lite, where the old loop was
    stop-and-wait.  Per-server FIFO ordering is preserved exactly
    (requests are sent in enqueue order, acks arrive in that order on
    one TCP stream), so a later ``pull`` still observes every prior
    push from THIS worker; ``MXNET_KVSTORE_WINDOW=1`` degrades to the
    old send-one-await-one behavior bit for bit.

    **Fault tolerance** (reference: ps-lite resender + the server-
    recovery mode, kvstore_dist.h:55).  Every request travels in an
    envelope ``("req", (rank, nonce), seq, msg)``; on transport death
    the IO thread reconnects with capped exponential backoff
    (``MXNET_KVSTORE_RETRY_*``) and REPLAYS the ENTIRE unacked window
    in seq order — the server's per-client dedup window acks
    already-applied replays idempotently, so a connection killed with
    k envelopes in flight still applies each exactly once.  Retries
    are bounded: exhausting ``MXNET_KVSTORE_RETRY_MAX`` reconnect
    attempts surfaces the original transport error as the permanent
    channel failure, failing every in-flight request.

    **Liveness.**  A low-rate heartbeat thread pings the server on its
    OWN socket (the data channel legitimately blocks unboundedly in
    barrier waits); ``is_dead()`` reports silence past
    ``MXNET_KVSTORE_HEARTBEAT_TIMEOUT`` and feeds ``num_dead_nodes()``.
    """

    def __init__(self, uri, connect_timeout=60.0, window=None, rank=None,
                 byte_kinds=("sent", "recv")):
        import collections
        import socket as _socket
        import time
        import uuid
        self._uri = uri
        host, port = uri.rsplit(":", 1)
        self._addr = (host, int(port))
        # ``rank`` override: in-process multi-worker tests (and the
        # hierarchical tier's follower channels) run several stores of
        # DIFFERENT ranks in one process, where the env var can only
        # name one.  ``byte_kinds`` is the (send, recv) counter family
        # pair — mesh channels count under "ici_*" (kvstore_server
        # _send_msg byte_kind), the wire keeps the classic kinds.
        self._rank = int(os.environ.get("DMLC_WORKER_ID", "0")
                         if rank is None else rank)
        self._byte_kinds = tuple(byte_kinds)
        # channel identity: (worker_rank, nonce).  The nonce survives
        # reconnects (so replays dedup) but differs between channel
        # INSTANCES — two clients of the same rank (relaunch, tests)
        # must never collide in the server's dedup window.
        self._client_id = (self._rank, uuid.uuid4().hex[:16])
        # control-plane counter pair for hellos/heartbeats on this
        # channel family: wire channels use "control*", mesh channels
        # stay inside the ici_ family ("ici_control*")
        self._ctrl_kinds = (("control", "control_recv")
                            if self._byte_kinds[0] == "sent"
                            else ("ici_control", "ici_control_recv"))
        self._next_seq = 0
        from .base import env as _env
        self._retry_max = int(_env("MXNET_KVSTORE_RETRY_MAX", 8))
        self._retry_initial = float(
            _env("MXNET_KVSTORE_RETRY_INITIAL_MS", 50)) / 1000.0
        self._retry_cap = float(
            _env("MXNET_KVSTORE_RETRY_MAX_MS", 2000)) / 1000.0
        self._retry_backoff = float(_env("MXNET_KVSTORE_RETRY_BACKOFF", 2.0))
        self._retry_attempts = 0
        self._closing = threading.Event()
        self._last_transport_err = None
        # same-host shm lane (shmlane.py): set up AFTER the
        # channel exists via setup_shm_lane() — None means plain TCP.
        # Written on the caller's thread before any request that could
        # ride it is enqueued (the queue put is the happens-before
        # edge); read only by the IO thread afterwards.
        self._shm = None
        self._shm_stall_s = float(_env("MXNET_KVSTORE_SHM_STALL_S", 5.0))
        self._shm_sent_at = None
        self._sock = self._dial(connect_timeout)
        self._q = queue.Queue()
        self._err = None
        self._dead = False   # IO thread crashed (set after _err; see _io_loop)
        # sliding window: entries are [envelope, pending, replayed] in
        # seq order; head = oldest unacked.  ``window`` overrides the
        # env (the serving client opens wide pipelines per connection
        # without re-configuring the training job's kvstore channels).
        self._window = max(1, int(window if window is not None
                                  else _env("MXNET_KVSTORE_WINDOW", 8)))
        self._inflight = collections.deque()
        # wakeup pair: lets the IO thread wait on "ack readable" AND
        # "new request enqueued" at once (select) without polling
        self._wake_r, self._wake_w = _socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._thread = threading.Thread(target=self._io_loop, daemon=True)
        self._thread.start()
        self._hb_interval = float(
            _env("MXNET_KVSTORE_HEARTBEAT_INTERVAL", 5.0))
        self._hb_timeout = float(
            _env("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", 15.0))
        self._hb_last_ack = time.monotonic()
        self._hb_thread = None
        if self._hb_interval > 0:
            self._hb_thread = threading.Thread(target=self._hb_loop,
                                               daemon=True)
            self._hb_thread.start()

    def _dial(self, connect_timeout):
        import socket
        import time
        from . import faultinject
        from . import wirecodec as _codec
        from .kvstore_server import _set_nodelay, _send_msg, _recv_msg
        deadline = time.monotonic() + connect_timeout
        while True:
            try:
                faultinject.client_connect(self._uri)
                sock = socket.create_connection(self._addr, timeout=60)
                # the connect timeout must NOT linger as a recv timeout:
                # a barrier reply legitimately blocks until every worker
                # arrives (unbounded); transport death still surfaces as
                # ECONNRESET/EOF when the server process dies
                sock.settimeout(None)
                _set_nodelay(sock)
                # one synchronous codec hello before pipelined traffic:
                # hot frames go binary when the peer speaks v2, old
                # peers answer err/None and the socket stays pickle
                _codec.client_hello(sock, _send_msg, _recv_msg,
                                    byte_kinds=self._ctrl_kinds)
                return sock
            except (ConnectionRefusedError, OSError):
                # the server process is still importing/binding — workers
                # and servers start simultaneously (tools/launch.py)
                if time.monotonic() >= deadline:
                    raise MXNetError(
                        f"could not reach kvstore server at {self._uri} "
                        f"within {connect_timeout}s")
                time.sleep(0.2)

    def _enqueue(self, item):
        """Queue a request and poke the IO thread's select()."""
        self._q.put(item)
        if self._dead:
            # the IO thread crashed between the caller's _err check and
            # the put: nobody will ever dequeue this item — fail it here
            # (_dead is set after _err and before the crash handler's
            # drain, so seeing it guarantees _err is readable and that a
            # put the handler missed is ours to fail)
            self._drain_queue_failing(self._err)
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # buffer full / closed: the thread is awake regardless

    def _io_loop(self):
        """Thread entry: the pump with crash propagation.  Transport
        faults have their own recovery path (_recover_or_fail), but an
        UNEXPECTED crash in the pump logic itself used to kill the IO
        thread silently — every queued request's ``pending.done`` then
        never fires and callers block forever.  Park the failure as the
        channel poison instead (the sticky-error pattern): in-flight
        and queued requests fail with the cause, later enqueues raise
        up front (``_err`` check in request())."""
        try:
            self._io_pump()
        except Exception as exc:  # noqa: BLE001 — crossing a thread
            err = MXNetError(
                f"kvstore channel to {self._uri}: IO thread crashed: "
                f"{type(exc).__name__}: {exc}")
            err.__cause__ = exc
            self._channel_failed(err)   # sets _err, fails the window
            # _dead AFTER _err, BEFORE the drain: an enqueue that slips
            # past request()'s _err precheck either lands before this
            # drain (drained here) or puts after it — and then its own
            # _enqueue post-check observes _dead=True and self-drains.
            # Checking thread.is_alive() instead would leave a window
            # (drain done, thread not yet exited).
            self._dead = True
            self._drain_queue_failing(err)

    def _drain_queue_failing(self, err):
        """Fail every request still sitting in the enqueue queue (the
        window drain in _channel_failed only covers in-flight ones)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._fail_pending(item[1], err)

    def _io_pump(self):
        """The sliding-window pump.  Fill the window from the queue,
        then wait for whichever comes first: an ack (completes the head
        slot) or a wakeup byte (new work while acks are outstanding).
        With MXNET_KVSTORE_WINDOW=1 this is exactly the old
        send-one-await-one loop."""
        import select
        stopping = False
        while True:
            while not stopping and len(self._inflight) < self._window:
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    if self._inflight:
                        break
                    item = self._q.get()   # idle: block until work/close
                if item is None:
                    stopping = True
                    break
                self._send_request(item)
                self._drain_ready_acks(select)
            if not self._inflight:
                if stopping:
                    return
                continue
            if self._shm is not None:
                self._await_ack_shm(select)
                continue
            try:
                ready, _, _ = select.select(
                    [self._sock, self._wake_r], [], [])
            except (OSError, ValueError, TypeError):
                # socket torn down under us (close() path): surface it
                # through the ordinary recv-failure machinery
                ready = [self._sock]
            if self._wake_r in ready:
                try:
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
            if self._sock in ready:
                self._recv_ack()

    def _drain_ready_acks(self, select):
        """Between sends of a burst, consume any acks already on the
        wire (zero-timeout poll).  Frees window slots early and keeps
        the peer's (tiny) ack sends flowing while we stream — blocking
        sendall with a peer that is also mid-sendall is the one mutual-
        stall shape pipelining could otherwise create.  NOTE the public
        ops can't reach that shape anyway (pull/row_sparse_pull await
        their large replies before returning, so big replies never
        overlap big sends on one conn); only a caller hand-pipelining
        ``request()`` of large pulls between large pushes could."""
        while self._inflight and self._sock is not None:
            try:
                ready, _, _ = select.select([self._sock], [], [], 0)
            except (OSError, ValueError, TypeError):
                return
            if not ready:
                return
            self._recv_ack()

    def _send_request(self, item):
        """Assign the next seq, enter the window, send.  The entry joins
        the window BEFORE the send so a mid-send transport fault replays
        it with its original (client_id, seq)."""
        from .kvstore_server import _send_msg
        from . import faultinject
        msg, pending, tctx = item
        if self._err is not None and self._sock is None:
            # hard transport poison: the channel is gone for good — fail
            # queued work instead of sending into nothing.  An
            # APPLICATION-error poison (server said "err" to a fire-and-
            # forget push; the socket is healthy) must NOT drop
            # already-queued requests: they keep flowing, exactly like
            # the pre-window serial loop ("a lost gradient must not
            # pass silently" — only NEW enqueues are refused).
            self._fail_pending(pending, self._err)
            return
        if tctx is not None:
            # trace propagation (mxnet_tpu.tracing): the optional 5th
            # element carries (trace_id, parent span_id, send epoch-us)
            # captured at ENQUEUE time on the caller's thread — the
            # server opens a child span of the worker-side call.  The
            # stamped envelope lives in the window, so a reconnect
            # REPLAYS the same trace field: retries annotate the
            # original trace instead of starting a new one.  With
            # MXNET_TRACE=0 the envelope stays the classic 4-tuple —
            # zero added wire bytes (pinned by tests/test_tracing.py).
            envelope = ("req", self._client_id, self._next_seq, msg,
                        (tctx[0], tctx[1], _tr.now_us()))
        else:
            envelope = ("req", self._client_id, self._next_seq, msg)
        self._next_seq += 1
        self._inflight.append([envelope, pending, False])
        lane = self._shm
        if lane is not None and lane.dead():
            # peer marked it dead (leader teardown) — quiet drop, the
            # socket still works
            self._shm_drop()
            lane = None
        if lane is not None:
            from . import wirecodec as _codec
            try:
                sent = lane.send_request(
                    envelope, binary_ok=_codec.sock_binary(self._sock))
            except MXNetError:
                sent = False   # ring corrupt: fall through to TCP and
                #                let the next wait cycle kill the lane
            if sent:
                # one memcpy into the ring, zero socket syscalls; the
                # stall watchdog clock starts now.  fi kill hooks stay
                # socket-only — the lane has its own fault point
                # (MXNET_FI_SHM_WEDGE_AFTER).
                import time as _time
                self._shm_sent_at = _time.monotonic()
                return
        try:
            if self._sock is None:
                raise ConnectionError("channel has no connection")
            _send_msg(self._sock, envelope, fi_role="client",
                      byte_kind=self._byte_kinds[0])
            faultinject.client_window(self._sock, len(self._inflight))
        except Exception as exc:  # noqa: BLE001 — transport fault
            self._recover_or_fail(exc)

    def _await_ack_shm(self, select):
        """The shm-lane flavor of the ack wait: poll the reply ring
        (payload acks ride back the same lane) TOGETHER with the
        socket (server-side fallback replies — e.g. a frame too big
        for the ring went over TCP and so does its ack) and the wakeup
        pair.  Adaptive poll interval: sub-millisecond while hot (the
        in-host RTT this lane exists for), backing off to 2 ms so an
        idle wait doesn't spin a core.  The stall watchdog rides the
        same loop: a request sitting unconsumed in the ring past
        MXNET_KVSTORE_SHM_STALL_S means the leader stopped draining —
        mark the lane dead and fail over through the ordinary
        reconnect-and-replay path (closing the old socket is what
        makes a racing leader reply harmless: it dies with the
        connection, and the replayed envelope is deduped)."""
        import time
        lane = self._shm
        poll = 0.0002
        while self._inflight:
            try:
                reply = lane.recv_reply()
            except MXNetError as exc:
                self._shm_fault(f"reply ring corrupt: {exc}")
                return
            if reply is not None:
                self._ack_obj(reply)
                return
            if lane.dead():
                self._shm_fault("peer marked the lane dead")
                return
            try:
                ready, _, _ = select.select(
                    [self._sock, self._wake_r], [], [], poll)
            except (OSError, ValueError, TypeError):
                ready = [self._sock]
            if self._wake_r in ready:
                try:
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
                return   # new work enqueued — go fill the window
            if self._sock in ready:
                self._recv_ack()
                return
            if (self._shm_sent_at is not None
                    and lane.request_backlog() > 0
                    and time.monotonic() - self._shm_sent_at
                    > self._shm_stall_s
                    and lane.drain_stalled(self._shm_stall_s)):
                self._shm_fault(
                    f"leader stopped draining the request ring for "
                    f">{self._shm_stall_s}s (MXNET_KVSTORE_SHM_STALL_S)")
                return
            poll = min(poll * 2, 0.002)

    def _shm_drop(self, record=False):
        """Forget the lane (quietly or loudly) — mark dead so the peer
        stops serving it, unlink the segment (our mapping and any
        still-open peer mapping stay valid until their own close)."""
        lane, self._shm = self._shm, None
        self._shm_sent_at = None
        if lane is None:
            return
        try:
            lane.mark_dead()
            lane.destroy()
        except Exception:  # noqa: BLE001 — teardown best-effort
            pass
        if record:
            from . import profiler as _prof
            _prof.record_channel_event("kvstore.shm_fallback")

    def _shm_fault(self, why):
        """Lane failure → the transport-fault path the channel already
        survives: drop the lane, then reconnect-and-replay over TCP
        (the leader's per-client dedup keeps the replayed window
        exactly-once; the dead old socket swallows any reply the
        leader raced out)."""
        self._shm_drop(record=True)
        _health.note("shm.fallback", uri=self._uri, why=str(why))
        self._recover_or_fail(
            ConnectionError(f"shm lane to {self._uri}: {why}"))

    def setup_shm_lane(self):
        """Negotiate the same-host shared-memory lane for this channel
        (hierarchical-tier followers call it right after dialing,
        before any mesh traffic).  Window-1 channels only — strict
        request/reply alternation is what lets oversized frames ride
        TCP per-round with no reordering.  Returns True when the lane
        is live; every failure (knob off, remote host, segment
        creation failure, old/cross-host leader erring the hello)
        quietly keeps the channel on TCP."""
        from . import profiler as _prof
        from . import shmlane
        if self._window != 1 or not shmlane.client_enabled(self._addr[0]):
            return False
        try:
            lane = shmlane.ShmLane.create()
        except Exception:  # noqa: BLE001 — no /dev/shm, quota, ...
            return False
        try:
            ver = _await(self.request(("shm_hello", lane.name)))
        except MXNetError:
            lane.destroy()
            return False
        if not ver:
            lane.destroy()
            return False
        self._shm = lane
        _prof.record_channel_event("kvstore.shm_lane")
        return True

    def _recv_ack(self):
        """Consume ONE ack for the head of the window (acks arrive in
        seq order on the single TCP stream)."""
        from .kvstore_server import _recv_msg
        try:
            reply = _recv_msg(self._sock, fi_role="client",
                              byte_kind=self._byte_kinds[1])
        except Exception as exc:  # noqa: BLE001 — transport fault
            self._recover_or_fail(exc)
            return
        self._ack_obj(reply)

    def _ack_obj(self, reply):
        """Complete the head-of-window slot with ``reply`` — shared by
        the socket and shm-lane receive paths (the ring pops whole
        decoded frames, so both land here with the same shapes)."""
        from . import profiler as _prof
        # a complete round trip proves the transport healthy again
        self._retry_attempts = 0
        self._shm_sent_at = None
        envelope, pending, replayed = self._inflight.popleft()
        if replayed:
            _prof.record_channel_event("kvstore.replay_acked")
        status, payload = reply
        if status != "ok":
            # application error: the reply was fully read, the socket
            # is healthy — fail THIS op only.  A failed fire-and-
            # forget push has no waiter, so it surfaces on the next
            # call instead (a lost gradient must not pass silently).
            err = MXNetError(f"kvstore server error: {payload}")
            if pending is not None:
                pending.error = err
            else:
                self._err = err
        elif pending is not None:
            pending.value = payload
        if pending is not None:
            pending.done.set()

    def _recover_or_fail(self, exc):
        """Transport fault: reconnect and replay the whole unacked
        window, or — once retries are exhausted (or during close) —
        poison the channel and fail every in-flight request."""
        try:
            if self._closing.is_set():
                raise exc
            self._last_transport_err = exc
            self._reconnect(exc)   # raises once retries are exhausted
            self._replay_window()
        except Exception as hard:  # noqa: BLE001 — poison for good
            self._channel_failed(hard)

    def _replay_window(self):
        """Resend every unacked envelope in seq order on the fresh
        connection.  The server's per-client dedup window acks the
        already-applied ones idempotently; a fault mid-replay reconnects
        and restarts the whole window (same idempotence argument)."""
        from .kvstore_server import _send_msg
        from . import profiler as _prof
        while True:
            try:
                for entry in self._inflight:
                    _prof.record_channel_event("kvstore.replay")
                    entry[2] = True
                    _send_msg(self._sock, entry[0], fi_role="client",
                              byte_kind=self._byte_kinds[0])
                return
            except Exception as exc:  # noqa: BLE001 — fault mid-replay
                if self._closing.is_set():
                    raise
                self._last_transport_err = exc
                self._reconnect(exc)   # raises once retries exhausted

    def _channel_failed(self, exc):
        """Permanent failure: record the poison, fail the whole window.
        The flight recorder marks it too (CRITICAL while outstanding)
        and dumps a crash bundle — a hard-failed channel is exactly the
        evidence a postmortem needs from a survivor."""
        self._err = exc
        while self._inflight:
            _envelope, pending, _replayed = self._inflight.popleft()
            self._fail_pending(pending, exc)
        if not self._closing.is_set():
            _health.note_channel_poison(self._uri)

    @staticmethod
    def _fail_pending(pending, exc):
        if pending is not None:
            pending.error = exc
            pending.done.set()

    def _reconnect(self, cause):
        """Re-establish the data socket with capped exponential backoff.
        ``_retry_attempts`` persists across calls and only resets on a
        successful round trip, so a flapping server cannot stretch one
        failure episode past MXNET_KVSTORE_RETRY_MAX total attempts."""
        import socket
        from . import faultinject
        from . import profiler as _prof
        from . import wirecodec as _codec
        from .kvstore_server import _set_nodelay, _send_msg, _recv_msg
        try:
            self._sock.close()
        except (OSError, AttributeError):
            pass
        self._sock = None
        # any reconnect invalidates the shm lane: the leader's per-
        # connection attach dies with the old socket, so a fresh
        # connection runs plain TCP (rare path — lanes only die with
        # their transport or via the stall watchdog)
        if self._shm is not None:
            self._shm_drop(record=True)
        last = cause
        while True:
            if self._retry_attempts >= self._retry_max:
                _prof.record_channel_event("kvstore.hard_fail")
                raise MXNetError(
                    f"kvstore server channel to {self._uri} died "
                    f"({cause!r}) and could not be re-established after "
                    f"{self._retry_max} reconnect attempts (last error: "
                    f"{last!r}); tune MXNET_KVSTORE_RETRY_MAX / "
                    f"MXNET_KVSTORE_RETRY_INITIAL_MS / "
                    f"MXNET_KVSTORE_RETRY_MAX_MS") from cause
            self._retry_attempts += 1
            _prof.record_channel_event("kvstore.retry")
            delay = self._retry_initial * (
                self._retry_backoff ** (self._retry_attempts - 1))
            if self._closing.wait(min(delay, self._retry_cap)):
                raise MXNetError(
                    f"kvstore channel to {self._uri} closed during "
                    f"reconnect") from cause
            try:
                faultinject.client_connect(self._uri)
                sock = socket.create_connection(self._addr, timeout=60)
                sock.settimeout(None)
                _set_nodelay(sock)
                # re-negotiate BEFORE the window replay: the fresh
                # socket starts un-negotiated, and replayed envelopes
                # must ride whatever codec this round of hello agrees
                _codec.client_hello(sock, _send_msg, _recv_msg,
                                    byte_kinds=self._ctrl_kinds)
                self._sock = sock
                _prof.record_channel_event("kvstore.reconnect")
                return
            except (ConnectionRefusedError, OSError) as exc:
                last = exc
                continue

    # -- liveness ------------------------------------------------------------
    def _hb_loop(self):
        import socket
        import time
        from . import wirecodec as _codec
        from .kvstore_server import _send_msg, _recv_msg
        from . import profiler as _prof
        sock = None
        while not self._closing.is_set():
            try:
                if sock is None:
                    sock = socket.create_connection(
                        self._addr, timeout=self._hb_timeout)
                    sock.settimeout(self._hb_timeout)
                    # hello the liveness socket too: ping acks are the
                    # last pickled frames otherwise, and the steady-
                    # state pin is pickle_bytes == 0 across the job
                    _codec.client_hello(sock, _send_msg, _recv_msg,
                                        byte_kinds=self._ctrl_kinds)
                _send_msg(sock, ("ping", self._rank),
                          byte_kind=self._ctrl_kinds[0])
                status, _payload = _recv_msg(
                    sock, byte_kind=self._ctrl_kinds[1])
                if status == "ok":
                    self._hb_last_ack = time.monotonic()
                    _prof.record_channel_event("kvstore.heartbeat")
            except Exception:  # noqa: BLE001 — the miss IS the signal
                _prof.record_channel_event("kvstore.heartbeat_miss")
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                    sock = None
            self._closing.wait(self._hb_interval)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def is_dead(self) -> bool:
        """True when the server has not acked a heartbeat within
        MXNET_KVSTORE_HEARTBEAT_TIMEOUT.  Barrier waits on the data
        channel stay unbounded by design; SILENCE is what this
        detects."""
        import time
        if self._hb_thread is None or self._closing.is_set():
            return False
        return (time.monotonic() - self._hb_last_ack) > self._hb_timeout

    def request(self, msg):
        """Enqueue and return the :class:`_Pending` reply handle — lets a
        caller pipeline many requests before waiting on any."""
        if self._err is not None:
            raise MXNetError(f"kvstore server channel failed: {self._err}")
        pending = _Pending()
        self._enqueue((msg, pending,
                       _tr.current_ctx() if _tr.enabled() else None))
        return pending

    def submit(self, msg, wait=False):
        """Enqueue; with wait=True block for (and return) the reply."""
        if not wait:
            if self._err is not None:
                raise MXNetError(
                    f"kvstore server channel failed: {self._err}")
            self._enqueue((msg, None,
                           _tr.current_ctx() if _tr.enabled() else None))
            return None
        return _await(self.request(msg))

    def flush(self):
        """Return once every previously-enqueued op has been acked by the
        server (FIFO: a synchronous no-op command drains the queue).
        kSyncMode is the no-op of the async server (kvstore_server.py)."""
        from .kvstore_server import K_SYNC_MODE
        self.submit(("command", K_SYNC_MODE, None), wait=True)

    def close(self, join_timeout=10.0, retry=True):
        """Drain, stop the IO + heartbeat threads, close the socket.

        ``retry=False`` skips reconnect attempts during the final drain —
        the caller KNOWS the server is gone (it just sent kStopServer),
        so backing off against a deliberately stopped server only delays
        teardown."""
        if not retry:
            self._closing.set()   # recovery raises instead of reconnecting
        # drain before closing: a still-queued fire-and-forget push must
        # reach the server, not die with the socket ("a lost gradient
        # must not pass silently")
        try:
            self.flush()
        except MXNetError:
            pass  # channel already dead — nothing left to save
        self._closing.set()       # aborts any in-flight backoff sleep
        self._enqueue(None)
        self._thread.join(timeout=join_timeout)
        if self._thread.is_alive():
            # a silent leak here hid every wedged-channel teardown; name
            # the channel and its last known failure instead
            import warnings
            last = self._err or self._last_transport_err
            warnings.warn(
                f"kvstore channel to {self._uri}: IO thread did not stop "
                f"within {join_timeout:.0f}s — likely blocked awaiting a "
                f"server reply (last channel error: {last!r}); leaking "
                f"the daemon thread", RuntimeWarning, stacklevel=2)
        try:
            self._sock.close()
        except (OSError, AttributeError):
            pass
        # the IO thread is down (or leaked) — tear the lane off last so
        # the final flush above could still ride it
        self._shm_drop()
        for s in (self._wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass
        # poison the channel for any LATER caller: with the IO thread
        # gone, an enqueue after close would sit in the queue forever —
        # request()'s _err precheck must fail fast instead.  This bit
        # an observability sweep for real: cluster_stats() reaching a
        # closed-but-not-yet-collected store hung the whole sweep.
        if self._err is None:
            self._err = MXNetError(
                f"kvstore channel to {self._uri} is closed")
        self._dead = True
        self._drain_queue_failing(self._err)
        # a deliberately-closed channel is not an outstanding failure:
        # its poison (if any) stops contributing CRITICAL
        _health.clear_channel_poison(self._uri)

    def abort(self, join_timeout=5.0):
        """Abortive close for a channel the caller KNOWS is gray-failed
        (the peer accepts and heartbeats but stopped replying).  A
        flushing ``close()`` would wait on acks that will never come —
        and because acks are consumed strictly FIFO against the window,
        one swallowed reply misaligns every later ack on this stream,
        so the connection is unusable even if the peer recovers.  Fail
        everything in flight NOW and tear the socket down; the caller
        re-dials a fresh channel if it still wants this peer."""
        self._closing.set()
        if self._err is None:
            self._err = MXNetError(
                f"kvstore channel to {self._uri} aborted: peer stopped "
                f"replying (gray failure) — in-flight window failed")
        try:
            self._sock.close()      # wakes the IO thread mid-select
        except (OSError, AttributeError):
            pass
        self.close(join_timeout=join_timeout, retry=False)


class _Pending:
    """Reply rendezvous for one in-flight request."""

    __slots__ = ("done", "value", "error")

    def __init__(self):
        self.done = threading.Event()
        self.value = None
        self.error = None


def _await(pending):
    pending.done.wait()
    if pending.error is not None:
        raise MXNetError(f"kvstore server request failed: {pending.error}")
    return pending.value


class _WireHandle:
    """The shared timed-wait shell of the pull handles: idempotent,
    thread-safe ``wait()`` (any thread — the hierarchy tier's
    mesh-collect server waits the leader's handles concurrently with
    the fused driver) feeding the two wire-overlap clocks
    (profiler.record_wire_wait / record_wire_round): the time spent
    BLOCKED inside ``wait()`` is the exposed wire, the
    enqueue->resolved span is the full round — their ratio is the
    overlap fraction the fused-dist driver is regression-gated on.
    Subclasses implement ``_resolve() -> {key: np.ndarray}`` and
    ``_nkeys()``; ``_span_args`` tags the spans."""

    _span_args = None

    def __init__(self):
        import time
        self._t0 = time.monotonic()
        # the enqueue site's span context anchors the ROUND span: the
        # full enqueue->resolved interval crosses threads/chunks, so it
        # cannot ride the thread-local stack
        self._t0_ns = time.monotonic_ns() if _tr.enabled() else 0
        self._ctx = _tr.current_ctx() if _tr.enabled() else None
        self._result = None
        self._lock = threading.Lock()

    def wait(self):
        with self._lock:
            if self._result is not None:
                return self._result
            import time
            from . import profiler as _prof
            t_wait = time.monotonic()
            sp = _tr.span_begin("kv.wire_wait", cat="wire",
                                args=self._span_args)
            # registered with the health watchdog: a wire wait parked
            # past MXNET_HEALTH_WIRE_STALL_S with its round never
            # resolving trips a typed wire_stall event
            # (docs/OBSERVABILITY.md health section)
            wtok = _health.wait_begin("kv.wire_wait")
            try:
                # analysis: allow(blocking-under-lock): the handle lock's CONTRACT is serializing waiters — every wait() caller expects to park until the wire round resolves, and no other lock ever nests inside it
                vals = self._resolve()
            finally:
                # end even when a channel failure raises out of the
                # resolve: a leaked open span would stay on the
                # thread-local stack and mis-parent every later span
                # on this thread
                _tr.span_end(sp, args={"keys": self._nkeys()})
                _health.wait_end(wtok)
            t1 = time.monotonic()
            _prof.record_wire_wait(t1 - t_wait)
            _prof.record_wire_round(t1 - self._t0)
            if self._t0_ns:
                # the overlap the fused driver buys becomes VISIBLE:
                # the round span (enqueue->resolved) sits over the
                # wire_wait span (the exposed residue) on the timeline
                args = {"keys": self._nkeys()}
                if self._span_args:
                    args.update(self._span_args)
                _tr.add_span("kv.wire_round", self._t0_ns,
                             time.monotonic_ns(), cat="wire",
                             ctx=self._ctx, args=args)
            self._result = vals
            return vals


class _PullHandle(_WireHandle):
    """One in-flight batched pull (:meth:`KVStoreDistAsync.pull_async`):
    ``wait()`` blocks for every reply, reassembles stripes, syncs the
    elastic pull cache exactly like a blocking :meth:`pull`, and
    returns ``{key: np.ndarray}``.

    **Elastic replan** (the fused×elastic composition): entries carry
    each key's full shape and per-stripe row spans, so when a pending
    stripe dies with its server mid-flight, ``wait()`` repairs the
    roster (``KVStoreDistAsync._elastic_repair_impl``) and re-issues
    ONLY the unserved tail under the new stripe layout — stripes whose
    row span survived the bump keep their already-received values, the
    rest re-request from the new owners — then re-awaits.  Cache and
    clock bookkeeping stay exact: one ``_cache_value`` per key with the
    final assembled value (its absorb mark advanced when the replan
    re-issued against a log that had grown), one wire_wait/wire_round
    sample per handle.  Entries are ``{key, shape, mark, parts: [[lo,
    hi, wire_key, pending, value]]}`` with exactly one of
    pending/value set per part."""

    def __init__(self, kv, entries):
        super().__init__()
        self._kv = kv
        self._entries = _hb.track(entries, "kvstore._PullHandle.entries")

    def _nkeys(self):
        return len(self._entries)

    def _resolve(self):
        """Await every part; on a channel failure under
        MXNET_KVSTORE_ELASTIC, repair the roster and replan the
        unserved tail against the new stripe layout (bounded retries —
        the same budget as ``_elastic_attempt``)."""
        kv = self._kv
        attempts = 0
        while True:
            last_err = None
            for e in self._entries:
                for part in e["parts"]:
                    if part[4] is not None:
                        continue
                    if part[3] is None:
                        # re-issue itself failed last replan: the part
                        # is still unserved — keep repairing
                        last_err = last_err or MXNetError(
                            f"pull of {part[2]!r} could not be "
                            "re-issued after the roster repair")
                        continue
                    try:
                        part[4] = np.asarray(_await(part[3]))
                        part[3] = None
                    except MXNetError as exc:
                        part[3] = None
                        last_err = exc
            if last_err is None:
                break
            attempts += 1
            if not getattr(kv, "_elastic", False) or attempts > 2:
                raise last_err
            # one kv.repair span covers the roster repair AND the
            # replan instants it triggers, so the merged timeline shows
            # "this in-flight pull rode a roster bump" in one place
            with _tr.span("kv.repair", cat="elastic",
                          args={"replan": True}):
                try:
                    kv._elastic_repair_impl()
                except MXNetError:
                    pass   # re-issue below may still reach survivors
                self._replan()
        out = {}
        for e in self._entries:
            parts = sorted(e["parts"], key=lambda p: p[0])
            if len(parts) == 1:
                val = parts[0][4]
            else:
                val = np.concatenate([p[4] for p in parts], axis=0)
            # absorb only the pushes this pull OBSERVED (its enqueue
            # mark): the fused driver resolves handles chunks later,
            # with newer pushes in flight that must stay in the
            # elastic re-push log
            kv._cache_value(e["key"], val, mark=e.get("mark"))
            out[e["key"]] = val
        return out

    def _replan(self):
        """Re-derive the stripe layout of every key with unserved parts
        and re-issue exactly those — a part whose (lo, hi) row span is
        unchanged under the new plan keeps its received value (the
        'unserved tail' contract).

        Mark discipline: a re-issued request is enqueued NOW — after
        the repair's handoff re-pushes and any pushes logged since the
        original enqueue (per-conn FIFO: its reply observes them all) —
        so when the log has grown past the entry's mark, the WHOLE key
        re-issues (mixing newly-observed rows with pre-push received
        spans would make the cache absorb inconsistently) and the mark
        advances to the current position.  With no interleaved pushes
        the received spans are exact and reuse is safe."""
        from . import profiler as _prof
        kv = self._kv
        for e in self._entries:
            if all(p[4] is not None for p in e["parts"]):
                continue
            k, shape = e["key"], e["shape"]
            plan = kv._stripe_plan(k, shape)
            if plan is None:
                spans = [(0, int(shape[0]) if shape else 0, k)]
            else:
                spans = [(plan[i], plan[i + 1], f"{k}@s{i}")
                         for i in range(len(plan) - 1)]
            cur_mark = kv._push_mark(k)
            if cur_mark != e.get("mark"):
                resolved = {}
                e["mark"] = cur_mark
            else:
                resolved = {(p[0], p[1]): p[4] for p in e["parts"]
                            if p[4] is not None}
            new_parts, reissued = [], 0
            for lo, hi, wk in spans:
                if (lo, hi) in resolved:
                    new_parts.append([lo, hi, wk, None, resolved[(lo, hi)]])
                    continue
                try:
                    pending = kv._owner_conn(wk).request(("pull", wk))
                except MXNetError:
                    pending = None   # still down: next attempt retries
                new_parts.append([lo, hi, wk, pending, None])
                reissued += 1
            e["parts"] = new_parts
            _prof.record_channel_event("kvstore.pull_replan")
            _tr.instant("kv.replan", cat="elastic",
                        args={"key": k, "reissued": reissued,
                              "kept": len(spans) - reissued,
                              "generation": kv._roster_gen})


class _MeshPullHandle(_WireHandle):
    """The follower half of a hierarchical pull round: one
    ``mesh_collect`` request against the host-group leader, resolved
    when the leader's own wire round for the same sequence resolves.
    Interface-compatible with :class:`_PullHandle` (``wait() -> {key:
    np.ndarray}``) and shares its timed-wait shell, so the fused
    driver's overlap accounting holds on followers too — their
    "wire" is the in-host mesh channel (spans tagged ``mesh``)."""

    _span_args = {"mesh": True}

    def __init__(self, kv, keys, pending):
        super().__init__()
        self._kv = kv
        self._keys = list(keys)
        self._pending = pending

    def _nkeys(self):
        return len(self._keys)

    def _resolve(self):
        reply = _await(self._pending)
        return {k: np.asarray(reply[k]) for k in self._keys}


class _MeshLeader:
    """The host-group leader's in-host aggregation endpoint
    (``MXNET_KVSTORE_HIERARCHY`` — the hierarchical kvstore tier; the
    port's copy of the JAX package's, frame for frame).

    Followers on the same host connect through ordinary
    :class:`_ServerConn` channels (window 1: the replay window is then
    a single envelope, so the one-slot dedup below makes reconnect
    replays exactly-once) and speak three ops over the standard frame
    protocol, all bytes counted under the "ici_*" families:

    * ``("mesh_push", seq, [(key, grad), ...])`` — deposit one push
      round's gradients; the leader's ``_push_aggregated`` blocks on
      :meth:`collect_push` until every follower's round ``seq``
      arrived, reduces in-mesh and ships ONE summed push per key over
      the TCP wire.
    * ``("mesh_collect", seq, keys)`` — block until the leader's wire
      pull for sequence ``seq`` resolves (:meth:`publish_handle`
      registers it at ``pull_async`` time) and return its values: the
      weight fan-out leg.  Served directly off the leader's
      :class:`_PullHandle` (thread-safe ``wait``), so followers and
      the leader's own fused driver resolve the SAME wire round.
    * ``("command", ...)`` / ``("ping", ...)`` — flush/liveness no-ops.

    Sequences pair by SPMD lockstep: every group member executes the
    identical sequence of push/pull calls (the data-parallel contract
    the whole repo leans on), so counter ``seq`` on the follower names
    the same logical round as ``seq`` on the leader.  A member that
    falls silent trips the fan-in timeout (``MXNET_KVSTORE_MESH_FANIN_S``)
    — a loud error naming the missing round, never a silent hang (the
    wait is also health-registered, so the watchdog sees it age)."""

    def __init__(self, uri, n_followers, follower_ranks=None):
        import socket
        from .base import env as _env
        from .kvstore_server import _set_nodelay
        host, port = uri.rsplit(":", 1)
        self._uri = uri
        self._n_followers = int(n_followers)
        self._follower_ranks = (sorted(int(r) for r in follower_ranks)
                                if follower_ranks is not None else None)
        self._fanin_s = float(_env("MXNET_KVSTORE_MESH_FANIN_S", 120.0))
        self._acceptors = max(1, int(_env(
            "MXNET_KVSTORE_MESH_ACCEPTORS", 8)))
        self._listener = socket.create_server((host, int(port)))
        self._listener.settimeout(0.5)
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._pushes: Dict[int, list] = {}    # seq -> [pairs, ...]
        self._handles: Dict[int, list] = {}   # seq -> [handle, served]
        # fan-in forensics (guarded by _cv): which ranks deposited each
        # round, and when each rank was last heard from at all — the
        # timeout error names the missing ranks with last-heard ages,
        # mirroring the static barrier failure (kvstore_server).
        self._push_ranks: Dict[int, set] = {}
        self._last_heard: Dict[int, float] = {}
        # per-CLIENT envelope dedup (survives reconnects — a replay
        # arrives on a FRESH connection): cid -> (seq, reply), plus the
        # in-flight rendezvous for a replay racing the original
        self._dedup: Dict[tuple, tuple] = {}
        self._dedup_inflight: Dict[tuple, int] = {}
        self._conns: list = []
        self._pool: list = []     # _MeshAcceptor workers (accept thread
        #                           creates/assigns; each worker's conn
        #                           set is its own thread's after that)
        self._assigned = 0
        self._set_nodelay = _set_nodelay
        # analysis: allow(bare-thread): a crash closes the listener in run()'s finally — followers observe refused connects / EOF and fail their channels loudly, exactly like a dead parameter server
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    # -- leader-side API (called from the worker's main thread) ----------
    def collect_push(self, seq):
        """Block until every follower's round ``seq`` gradients arrived;
        pop and return them (a list of ``[(key, grad), ...]``)."""
        import time as _time
        from . import profiler as _prof
        wtok = _health.wait_begin("kv.mesh_fanin")
        t0 = _time.monotonic()
        try:
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: len(self._pushes.get(seq, ()))
                    >= self._n_followers or self._stop.is_set(),
                    timeout=self._fanin_s)
                if not ok or self._stop.is_set():
                    got = len(self._pushes.get(seq, ()))
                    missing, detail = self._missing_followers(seq)
                    _health.note("mesh.fanin_timeout", seq=int(seq),
                                 got=got, want=self._n_followers,
                                 missing=missing)
                    raise MXNetError(
                        f"mesh leader {self._uri}: round {seq} fan-in "
                        f"incomplete ({got} of {self._n_followers} "
                        f"followers) within "
                        f"MXNET_KVSTORE_MESH_FANIN_S={self._fanin_s}s"
                        f"{detail}")
                self._push_ranks.pop(seq, None)
                out = self._pushes.pop(seq)
            _prof.record_mesh_fanin_wait(_time.monotonic() - t0)
            return out
        finally:
            _health.wait_end(wtok)

    def _missing_followers(self, seq):
        """(missing rank list, human detail) for a fan-in timeout —
        caller holds _cv.  Degrades gracefully when the roster wasn't
        passed (direct _MeshLeader construction)."""
        import time as _time
        if self._follower_ranks is None:
            return [], ""
        present = self._push_ranks.get(seq, set())
        missing = [r for r in self._follower_ranks if r not in present]
        if not missing:
            return [], ""
        now = _time.monotonic()
        ages = "; ".join(
            "rank %s: %s" % (
                r, "never heard from" if self._last_heard.get(r) is None
                else "last heard %.1fs ago" % (now - self._last_heard[r]))
            for r in missing)
        return missing, f" — missing {ages}"

    def publish_handle(self, seq, handle):
        """Register the leader's wire pull for round ``seq`` so
        mesh_collect waiters can resolve against it."""
        with self._cv:
            self._handles[seq] = [handle, 0]
            self._cv.notify_all()

    def close(self):
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        for w in list(self._pool):
            w.poke()
        for c in list(self._conns):
            try:
                c.close()
            except OSError:
                pass
        for w in list(self._pool):
            w.thread.join(timeout=5.0)
            w.close_wake()

    # -- serve side -------------------------------------------------------
    def _run(self):
        import socket
        try:
            while not self._stop.is_set():
                try:
                    conn, _ = self._listener.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                self._set_nodelay(conn)
                self._conns.append(conn)
                self._assign(conn)
        finally:
            try:
                self._listener.close()
            except OSError:
                pass
            for w in list(self._pool):
                w.poke()

    def _assign(self, conn):
        """Hand a fresh connection to a pool worker (round-robin),
        growing the pool up to MXNET_KVSTORE_MESH_ACCEPTORS threads.
        Only the accept thread touches pool membership; each worker's
        connection set is thereafter its own thread's alone (adoption
        rides the worker's inbox Queue, a happens-before edge)."""
        if len(self._pool) < self._acceptors:
            w = _MeshAcceptor(self)
            self._pool.append(w)
        else:
            w = self._pool[self._assigned % len(self._pool)]
        self._assigned += 1
        w.adopt(conn)

    def _serve_pool(self, w):
        """One acceptor-pool thread: multiplex its adopted connections
        (sockets + shm lanes) with select, serving one frame per ready
        source per sweep.  mesh_collect frames that arrive before the
        leader registered the round are PARKED in ``pending`` rather
        than blocking this thread — a blocked wait here would also
        stall every other follower this thread serves, including the
        very mesh_push frames the round is waiting on."""
        import queue
        import select as _select
        conns: list = []     # _MeshConnState — this thread's alone
        # deferred mesh_collects: appended here, but drained by
        # _scan_pending against rounds the LEADER thread registers —
        # the cross-thread handoff the hb shim should see
        pending: list = _hb.track([], "kvstore._MeshAcceptor.pending")
        poll = 0.0002
        try:
            while not self._stop.is_set():
                while True:
                    try:
                        conns.append(_MeshConnState(w.inbox.get_nowait()))
                    except queue.Empty:
                        break
                lanes = any(st.lane is not None for st in conns)
                timeout = poll if (lanes or pending) else None
                try:
                    ready, _, _ = _select.select(
                        [st.sock for st in conns] + [w.wake_r],
                        [], [], timeout)
                except (OSError, ValueError):
                    for st in [s for s in list(conns)
                               if s.sock.fileno() < 0]:
                        self._drop_conn(st, conns)
                    continue
                if w.wake_r in ready:
                    try:
                        w.wake_r.recv(4096)
                    except (OSError, BlockingIOError):
                        pass
                busy = False
                rset = set(ready)
                for st in list(conns):
                    if st.sock in rset:
                        busy |= self._serve_sock(st, conns, pending)
                    if st.lane is not None:
                        busy |= self._serve_lane(st, conns, pending)
                busy |= self._scan_pending(conns, pending)
                poll = 0.0002 if busy else min(poll * 2, 0.002)
        finally:
            for st in list(conns):
                self._drop_conn(st, conns)

    def _serve_sock(self, st, conns, pending):
        from . import wirecodec as _codec
        from .kvstore_server import _recv_msg
        try:
            msg = _recv_msg(st.sock, byte_kind=st.recv_kind)
        except (ConnectionError, OSError):
            self._drop_conn(st, conns)
            return True
        reply_kind = "ici_sent"
        if msg and msg[0] == "req":
            _, cid, seq, inner = msg[:4]
            self._note_heard(cid)
            if self._defer_collect(st, pending, cid, seq, inner, False):
                return True
            reply = self._exactly_once(cid, seq, inner, st=st)
        else:
            # codec hellos + raw heartbeat pings from the follower
            # channel (the hello check must come FIRST: the blanket
            # ("ok", None) ack is what an OLD leader answers, which
            # clients read as version 0)
            hello = _codec.handle_hello(st.sock, msg)
            reply = hello if hello is not None else ("ok", None)
            if msg and msg[0] == "ping":
                # pings ride the follower's dedicated liveness socket;
                # hellos arrive on data sockets too and must not latch
                st.recv_kind = "ici_control_recv"
                reply_kind = "ici_control"
        self._reply(st, conns, reply, False, reply_kind)
        return True

    def _serve_lane(self, st, conns, pending):
        lane = st.lane
        if lane.dead():
            self._drop_lane(st)
            return False
        try:
            msg = lane.recv_request()
        except MXNetError:
            # a corrupt ring record poisons the whole lane (framing is
            # lost) — kill the lane; the follower's stall watchdog
            # fails over to TCP and replays its window
            self._drop_lane(st)
            return False
        if msg is None:
            return False
        if msg and msg[0] == "req":
            _, cid, seq, inner = msg[:4]
            self._note_heard(cid)
            if self._defer_collect(st, pending, cid, seq, inner, True):
                return True
            reply = self._exactly_once(cid, seq, inner, st=st)
        else:
            reply = ("ok", None)
        self._reply(st, conns, reply, True)
        return True

    def _defer_collect(self, st, pending, cid, seq, inner, via_shm):
        """Park a mesh_collect whose wire round is not registered yet.
        Blocking this pool thread on ``_handles`` instead would be a
        deadlock: another follower's mesh_push — the frame the round
        needs to complete — may be sitting unread on a connection this
        same thread owns.  Returns True when parked."""
        import time as _time
        if not inner or inner[0] != "mesh_collect":
            return False
        with self._cv:
            have = self._dedup.get(cid)
            if have is not None and have[0] == seq:
                return False   # replay with a cached reply — serve now
            if int(inner[1]) in self._handles or self._stop.is_set():
                return False   # resolvable (or failing fast) already
        pending.append((st, cid, seq, inner, via_shm,
                        _time.monotonic() + self._fanin_s))
        return True

    def _scan_pending(self, conns, pending):
        import time as _time
        if not pending:
            return False
        busy = False
        for item in list(pending):
            st, cid, seq, inner, via_shm, deadline = item
            with self._cv:
                have = self._dedup.get(cid)
                served = (int(inner[1]) in self._handles
                          or self._stop.is_set()
                          or (have is not None and have[0] == seq))
            if served:
                pending.remove(item)
                reply = self._exactly_once(cid, seq, inner, st=st)
                self._reply(st, conns, reply, via_shm)
                busy = True
            elif _time.monotonic() > deadline:
                pending.remove(item)
                self._reply(st, conns, (
                    "err", f"MXNetError: mesh leader {self._uri}: no "
                           f"wire round registered for collect seq "
                           f"{int(inner[1])} within {self._fanin_s}s"),
                    via_shm)
                busy = True
        return busy

    def _reply(self, st, conns, reply, via_shm, reply_kind="ici_sent"):
        """Send a reply back the way the request came: shm-borne
        requests get shm replies (falling back to the socket when the
        reply outgrows the ring — the follower polls both)."""
        from . import wirecodec as _codec
        from .kvstore_server import _send_msg
        if via_shm and st.lane is not None and not st.lane.dead():
            try:
                if st.lane.send_reply(
                        reply, binary_ok=_codec.sock_binary(st.sock)):
                    return
            except MXNetError:
                self._drop_lane(st)
        try:
            _send_msg(st.sock, reply, byte_kind=reply_kind)
        except (ConnectionError, OSError):
            self._drop_conn(st, conns)

    def _note_heard(self, cid):
        import time as _time
        if not isinstance(cid, (tuple, list)) or not cid:
            return
        try:
            rank = int(cid[0])
        except (TypeError, ValueError):
            return
        with self._cv:
            self._last_heard[rank] = _time.monotonic()

    def _drop_lane(self, st):
        lane, st.lane = st.lane, None
        if lane is None:
            return
        try:
            lane.mark_dead()
        except Exception:  # noqa: BLE001 — segment may be gone
            pass
        lane.close()

    def _drop_conn(self, st, conns):
        self._drop_lane(st)
        try:
            st.sock.close()
        except OSError:
            pass
        try:
            conns.remove(st)
        except ValueError:
            pass
        try:
            self._conns.remove(st.sock)
        except ValueError:
            pass

    def _exactly_once(self, cid, seq, inner, st=None):
        """Per-CLIENT single-slot dedup, keyed (client_id, seq) like
        the real server's window so a reconnect REPLAY — which arrives
        on a FRESH connection whose thread has no local state — still
        hits the cache instead of re-executing (a re-executed
        mesh_push would double a follower's gradient in the round).
        One slot per client suffices: mesh channels run window 1, so
        at most one envelope per follower is ever unacked.  A replay
        racing the original's in-flight execution parks until its
        reply is stored (the zombie-duplicate shape the real server's
        window also covers)."""
        with self._cv:
            while True:
                have = self._dedup.get(cid)
                if have is not None and have[0] == seq:
                    return have[1]
                if self._dedup_inflight.get(cid) != seq:
                    self._dedup_inflight[cid] = seq
                    break
                if not self._cv.wait(timeout=self._fanin_s):
                    return ("err", "mesh leader: duplicate envelope "
                                   "parked past the fan-in budget")
        rank = None
        if isinstance(cid, (tuple, list)) and cid:
            try:
                rank = int(cid[0])
            except (TypeError, ValueError):
                rank = None
        try:
            reply = ("ok", self._handle(inner, st=st, rank=rank))
        except Exception as exc:  # noqa: BLE001
            reply = ("err", f"{type(exc).__name__}: {exc}")
        with self._cv:
            self._dedup[cid] = (seq, reply)
            if self._dedup_inflight.get(cid) == seq:
                del self._dedup_inflight[cid]
            self._cv.notify_all()
        return reply

    def _handle(self, inner, st=None, rank=None):
        from . import profiler as _prof
        op = inner[0]
        if op == "mesh_push":  # protocol: replay(dedup-window) reply(none) codec(binary)
            _, seq, pairs = inner
            with self._cv:
                self._pushes.setdefault(int(seq), []).append(pairs)
                if rank is not None:
                    self._push_ranks.setdefault(int(seq), set()).add(rank)
                self._cv.notify_all()
            _prof.record_channel_event("kvstore.mesh_push")
            return None
        if op == "mesh_collect":  # protocol: replay(dedup-window) reply(key -> ndarray) codec(binary)
            _, seq, keys = inner
            seq = int(seq)
            with self._cv:
                ok = self._cv.wait_for(
                    lambda: seq in self._handles or self._stop.is_set(),
                    timeout=self._fanin_s)
                if not ok or self._stop.is_set():
                    raise MXNetError(
                        f"mesh leader {self._uri}: no wire round "
                        f"registered for collect seq {seq} within "
                        f"{self._fanin_s}s")
                entry = self._handles[seq]
            vals = entry[0].wait()   # thread-safe, idempotent
            with self._cv:
                entry[1] += 1
                if entry[1] >= self._n_followers:
                    self._handles.pop(seq, None)
            _prof.record_channel_event("kvstore.mesh_collect")
            return {k: vals[k] for k in keys}
        if op == "shm_hello":  # protocol: replay(idempotent) reply(lane version | err)
            # follower created a shared-memory lane and names its
            # segment; attach and serve this connection's traffic off
            # the ring from here on.  Idempotent: re-attaching the same
            # segment (reconnect replay) just replaces the attachment.
            from . import shmlane
            _, name = inner[:2]
            if st is None:
                raise MXNetError(
                    "mesh leader: shm_hello outside a connection")
            lane = shmlane.ShmLane.attach(str(name))
            self._drop_lane(st)
            st.lane = lane
            _prof.record_channel_event("kvstore.shm_attach")
            return shmlane.VERSION
        if op == "command":  # protocol: replay(pure) reply(none)
            return None   # follower channel flush token
        raise MXNetError(f"mesh leader: unknown op {op!r}")


class _MeshConnState:
    """Per-connection state owned by exactly one acceptor-pool thread:
    the socket, the (optional) attached shm lane serving it, and the
    latched byte-kind for liveness pings."""

    __slots__ = ("sock", "lane", "recv_kind")

    def __init__(self, sock):
        self.sock = sock
        self.lane = None
        self.recv_kind = "ici_recv"


class _MeshAcceptor:
    """One worker of the mesh leader's bounded serve pool.  The accept
    thread hands connections over via ``inbox`` (a queue.Queue — the
    put/get pair is the happens-before edge for the socket object);
    ``poke()`` wakes the worker out of its select so adoption and
    shutdown are prompt."""

    def __init__(self, leader):
        import queue
        import socket
        self.inbox = queue.Queue()
        self.wake_r, self._wake_w = socket.socketpair()
        self.wake_r.setblocking(False)
        # analysis: allow(bare-thread): pool threads serve sockets the leader owns — close() closes those sockets and pokes the wake pipe, so a crashed worker surfaces as dropped connections and loud channel failures on every follower it served
        self.thread = threading.Thread(target=leader._serve_pool,
                                       args=(self,), daemon=True)
        self.thread.start()

    def adopt(self, conn):
        self.inbox.put(conn)
        self.poke()

    def poke(self):
        try:
            self._wake_w.send(b"\x00")
        except OSError:
            pass

    def close_wake(self):
        for s in (self.wake_r, self._wake_w):
            try:
                s.close()
            except OSError:
                pass


class KVStoreDistAsync(KVStore):
    """Worker-side kvstore ``dist_async`` (reference: kvstore_dist.h worker
    + the server's immediate-apply branch, kvstore_dist_server.h:405-430).

    Keys route to servers by ``crc32(key) % num_servers``
    (:func:`membership.server_index`).  Arrays above
    ``MXNET_KVSTORE_BIGARRAY_BOUND`` elements (default 1e6, the
    reference's) stripe row-wise across all servers, each stripe its own
    server key ``<key>@s<i>``, so big pushes and pulls serialize and
    apply in parallel (server-side optimizer state is then per stripe:
    the same math for elementwise optimizers).

    A push keeps the reduced gradient on its device until the wire: it
    is striped there, compressed there (Q1, one launch per wire key,
    the residual staying on the card), and only the bytes that travel
    are copied to pinned host memory.  A pull lands in its ``out``
    array's device.
    """

    def __init__(self, uris=None, roster_member=None, rank=None):
        super().__init__("dist_async")
        # explicit rank override (tests running several worker stores —
        # different ranks — in ONE process, where the DMLC env can only
        # name one; the launcher path leaves it None)
        self._rank_override = None if rank is None else int(rank)
        if uris is None:
            uris = os.environ.get("MXT_SERVER_URIS", "")
        elif not isinstance(uris, str):
            uris = ",".join(uris)
        if not uris:
            raise MXNetError(
                "kvstore 'dist_async' needs running parameter servers: "
                "launch with `python tools/launch.py -n W -s S cmd...` "
                "(MXT_SERVER_URIS is set by the launcher; a serving "
                "replica passes param_servers= explicitly)")
        from .base import env as _env
        uri_list = uris.split(",")
        # -- elastic membership (mxnet_tpu.membership) --------------------
        # The env uris are only the BOOTSTRAP set: under
        # MXNET_KVSTORE_ELASTIC the authoritative server list is the
        # coordinator's roster (generation-numbered; server 0).  A
        # ``roster_member`` client registers as a live worker rank
        # (barriers count it, silence evicts it); an observer — the
        # serving replica's refresh client — follows the roster without
        # ever joining it.
        self._elastic = bool(_env("MXNET_KVSTORE_ELASTIC", False))
        self._roster_member = (self._elastic if roster_member is None
                               else bool(roster_member)) and self._elastic
        self._roster_gen = 0
        self._roster_servers = list(uri_list)
        self._bootstrap_servers = list(uri_list)
        self._live_workers = None
        self._failovers = 0           # coordinator successions ridden
        self._coordinator_slot = 0    # bootstrap slot of the coordinator
        self._barrier_seq = 0         # per-worker barrier sequence
        # _elastic_lock guards the pull cache / push log quartet (and
        # the order deque): _cache_value runs on whatever thread
        # resolves a _PullHandle, concurrently with _log_push /
        # _push_mark on the pushing thread; unsynchronized, the absorb
        # accounting could lose or double re-push log entries across a
        # roster bump.  All four structures are hb-tracked.  The log
        # holds the pushed gradients as pushed (a card tensor stays on
        # the card, copied: the caller's gradient buffer is reused).
        self._elastic_lock = threading.Lock()
        self._pull_cache: Dict[str, np.ndarray] = _hb.track(
            {}, "KVStoreDistAsync._pull_cache")
        self._push_log: Dict[str, list] = _hb.track(
            {}, "KVStoreDistAsync._push_log")
        # absolute per-key push positions: _push_log_seq counts every
        # push ever logged, _push_log_absorbed how many of those the
        # cache has absorbed.  A pull's cache sync may only absorb
        # pushes issued BEFORE the pull was ENQUEUED (its "mark"): the
        # chunked driver resolves pulls chunks later, with newer pushes
        # already in flight, and absorbing those would drop them from
        # the elastic re-push log
        self._push_log_seq: Dict[str, int] = _hb.track(
            {}, "KVStoreDistAsync._push_log_seq")
        self._push_log_absorbed: Dict[str, int] = _hb.track(
            {}, "KVStoreDistAsync._push_log_absorbed")
        self._push_log_order = None
        self._push_log_cap = int(_env("MXNET_KVSTORE_ELASTIC_PUSH_LOG",
                                      256))
        if self._elastic:
            import collections
            self._push_log_order = _hb.track(
                collections.deque(), "KVStoreDistAsync._push_log_order")
            # dial the bootstrap uris in order until one answers the
            # roster op: slot 0 is the coordinator in the common case,
            # but a late joiner may arrive AFTER churn — any surviving
            # server forwards the op one hop to the live coordinator
            # (kvstore_server "roster_fwd"), so reaching ANY of them is
            # enough to converge onto the current roster
            join_msg = (("roster_join", "worker", self.rank)
                        if self._roster_member else ("roster_get",))
            coord = reply = last_exc = None
            for i, u in enumerate(uri_list):
                try:
                    c = _ServerConn(u, connect_timeout=(
                        60.0 if i == 0 else 15.0), rank=self.rank)
                except MXNetError as exc:
                    last_exc = exc
                    continue
                try:
                    reply = c.submit(join_msg, wait=True)
                    coord = c
                    break
                except MXNetError as exc:
                    last_exc = exc
                    c.close(retry=False)
            if reply is None:
                raise MXNetError(
                    "kvstore dist_async: no bootstrap server answered "
                    f"the roster (tried {uri_list}): {last_exc}")
            self._conns = [coord]
            gen, servers, workers = reply[0], reply[1], reply[2]
            if len(reply) > 3:
                # worker-join replies carry the cohort's barrier floor:
                # seeding our sequence there keeps raw barrier seqs
                # globally aligned, so arrivals pair exactly even
                # against a failover successor with empty barrier state
                self._barrier_seq = int(reply[3])
            conns = []
            for u in servers:
                conns.append(coord if u == coord._uri
                             else _ServerConn(u, rank=self.rank))
            if coord._uri not in servers:
                coord.close(retry=False)
            self._conns = conns
            self._roster_gen = int(gen)
            self._roster_servers = list(servers)
            self._live_workers = list(workers)
            from . import profiler as _prof
            _prof.record_channel_gauge("kvstore.roster_generation",
                                       self._roster_gen)
        else:
            self._conns = [_ServerConn(u, rank=self.rank)
                           for u in uri_list]
        self._bigarray_bound = int(float(os.environ.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND", "1000000")))
        self._stripes: Dict[str, list] = {}  # key -> row boundaries
        self._stripes_nservers = len(self._conns)
        self._last_moved_keys = set()
        self._closed = False
        # 2-bit residuals live worker-side, one per WIRE key (stripes
        # quantize independently), on the pushed gradient's device
        self._gc_residual: Dict[str, torch.Tensor] = _hb.track(
            {}, "kvstore._gc_residual")
        # row-sparse pushes keep their residuals per GLOBAL row id, on
        # the host ({base_key: {row_id: fp32 row}}); _sparse_shapes
        # remembers each sparse key's full table shape
        self._sparse_residual: Dict[str, Dict[int, np.ndarray]] = \
            _hb.track({}, "kvstore._sparse_residual")
        self._sparse_shapes: Dict[str, tuple] = _hb.track(
            {}, "kvstore._sparse_shapes")
        self._sparse_wire = bool(_env("MXNET_KVSTORE_SPARSE", True))
        self._sparse_cutover = float(_env(
            "MXNET_KVSTORE_SPARSE_DENSITY_CUTOVER", 0.5))
        ctype = os.environ.get("MXNET_KVSTORE_COMPRESSION", "")
        if ctype and ctype != "none":
            self.set_gradient_compression({
                "type": ctype,
                "threshold": float(os.environ.get(
                    "MXNET_KVSTORE_COMPRESSION_THRESHOLD", "0.5"))})
        # pushes at or below this many payload bytes coalesce into one
        # multi-key envelope per server when pushed as a key list
        self._coalesce_bytes = int(float(os.environ.get(
            "MXNET_KVSTORE_COALESCE_BYTES", "16384")))
        # silence on any worker-server channel becomes visible job-wide
        from . import distributed as _dist
        _dist._register_dead_node_source(self)
        # -- hierarchical tier (MXNET_KVSTORE_HIERARCHY) ------------------
        # Workers sharing a host form a group: the followers hand their
        # gradients to the group's leader over an in-host channel (the
        # shm lane where it can), the leader sums them on its device and
        # ONLY the leader ships the reduced gradient over the TCP wire,
        # fanning the pulled weights back in-host
        self._hier = False
        self._mesh_leader = None    # leader-side endpoint
        self._mesh_conn = None      # follower-side channel to the leader
        self._mesh_group = None
        self._mesh_push_seq = 0
        self._mesh_pull_seq = 0
        if _env("MXNET_KVSTORE_HIERARCHY", False):
            self._init_hierarchy()

    @property
    def rank(self) -> int:
        if getattr(self, "_rank_override", None) is not None:
            return self._rank_override
        return int(os.environ.get("DMLC_WORKER_ID", "0"))

    @property
    def num_workers(self) -> int:
        # elastic: the LIVE roster's worker count, not the launch-time
        # env (joins and evictions move it mid-job)
        if self._elastic and self._live_workers is not None:
            return max(1, len(self._live_workers))
        return int(os.environ.get("DMLC_NUM_WORKER", "1"))

    def _conn_of(self, k: str) -> _ServerConn:
        # routing math lives in membership.server_index, shared with the
        # JAX package's handoff planner
        from .membership import server_index
        return self._conns[server_index(k, len(self._conns))]

    # -- big-array striping --------------------------------------------------
    # -- hierarchical tier (MXNET_KVSTORE_HIERARCHY) --------------------------
    def _init_hierarchy(self):
        """Resolve this worker's host group (membership.mesh_group over
        the launch topology) and bring up its side of the tier: the
        leader binds the group's loopback endpoint (_MeshLeader), the
        followers dial it and negotiate the shm lane.  A one-member
        group (or a 1-worker job) is flat: the tier stays off."""
        from .base import env as _env
        from . import membership as _mem
        if self._elastic:
            raise MXNetError(
                "MXNET_KVSTORE_HIERARCHY does not compose with "
                "MXNET_KVSTORE_ELASTIC yet: the mesh group is derived "
                "from the static launch topology, and a roster bump "
                "would strand the in-host tier.  Run elastic jobs flat")
        per_host = int(_env("MXNET_KVSTORE_WORKERS_PER_HOST", 0))
        if per_host <= 0:
            raise MXNetError(
                "MXNET_KVSTORE_HIERARCHY=1 needs the host topology: "
                "launch with `tools/launch.py --workers-per-host N` "
                "(which also allocates MXT_MESH_URIS), or set "
                "MXNET_KVSTORE_WORKERS_PER_HOST and MXT_MESH_URIS "
                "explicitly")
        nworkers = int(os.environ.get("DMLC_NUM_WORKER", "1"))
        leader, members, gi = _mem.mesh_group(
            self.rank, range(nworkers), per_host)
        if len(members) <= 1:
            return   # a single-member group has nothing to reduce
        mesh_uris = os.environ.get("MXT_MESH_URIS", "")
        uris = [u for u in mesh_uris.split(",") if u]
        if gi >= len(uris):
            raise MXNetError(
                f"MXNET_KVSTORE_HIERARCHY: no mesh endpoint for host "
                f"group {gi} in MXT_MESH_URIS={mesh_uris!r} - launch "
                "with tools/launch.py --workers-per-host, or export "
                "one host:port per group")
        self._hier = True
        self._mesh_group = members
        if self.rank == leader:
            self._mesh_leader = _MeshLeader(
                uris[gi], n_followers=len(members) - 1,
                follower_ranks=[r for r in members if r != leader])
        else:
            # window 1: the replay window is one envelope, which the
            # leader's one-slot dedup makes exactly-once
            self._mesh_conn = _ServerConn(
                uris[gi], window=1, rank=self.rank,
                byte_kinds=("ici_sent", "ici_recv"))
            # same-host fast path: one memcpy into a shared-memory ring
            # instead of a socket round trip (MXNET_KVSTORE_SHM; the
            # channel stays on TCP if the lane cannot be set up)
            self._mesh_conn.setup_shm_lane()

    def _mesh_reduce(self, pairs, contribs):
        """The leader's sum of its own gradients with every follower's
        round contribution (:func:`_local_allreduce_sum`, on the device
        of the leader's gradient).  Key sets must match: the group runs
        the same program."""
        by_key = [dict(c) for c in contribs]
        reduced = []
        for k, agg in pairs:
            parts = [agg]
            for c in by_key:
                if k not in c:
                    raise MXNetError(
                        f"hierarchical push: follower contribution is "
                        f"missing key {k!r} - the group's push rounds "
                        "have diverged (mesh members must run the same "
                        "program)")
                parts.append(c[k])
            if any(isinstance(p, RowSparsePayload) for p in parts):
                reduced.append((k, self._merge_sparse(
                    [p if isinstance(p, RowSparsePayload) else _host_np(p)
                     for p in parts])))
                continue
            reduced.append((k, _local_allreduce_sum(parts)))
        return reduced

    @staticmethod
    def _merge_sparse(parts):
        """Merge one round's contributions for a row-sparse key into ONE
        deduplicated sparse sum: indices unioned, rows landing on the
        same id accumulated, so the leader ships a single
        RowSparsePayload.  A mixed round (a member crossed the density
        cutover and densified its copy) becomes the dense sum."""
        if not all(isinstance(p, RowSparsePayload) for p in parts):
            dense = None
            for p in parts:
                if isinstance(p, RowSparsePayload):
                    rows = np.asarray(p.data)
                    d = np.zeros((p.nrows,) + rows.shape[1:], rows.dtype)
                    np.add.at(d, np.asarray(p.indices, np.int64), rows)
                else:
                    d = np.asarray(p)
                dense = d if dense is None else dense + d
            return dense
        allidx = np.concatenate(
            [np.asarray(p.indices, np.int64) for p in parts])
        allrows = np.concatenate(
            [np.asarray(p.data) for p in parts], axis=0)
        uniq, inv = np.unique(allidx, return_inverse=True)
        summed = np.zeros((uniq.size,) + allrows.shape[1:],
                          allrows.dtype)
        np.add.at(summed, inv, allrows)
        return RowSparsePayload(uniq, parts[0].nrows, summed)

    def _stripe_plan(self, k: str, shape):
        """Row boundaries for a striped key, or None: deterministic from
        (key, shape, num_servers) (:func:`membership.stripe_plan`), so
        every worker derives the identical plan with no coordination.

        Plans are cached per key, valid ONLY for the server count they
        were derived against: a server-count change without
        :meth:`_reset_stripe_plans` is a hard error (a stale plan routes
        rows to the wrong servers; the elastic roster path clears the
        cache on every roster bump)."""
        if self._stripes and self._stripes_nservers != len(self._conns):
            raise MXNetError(
                "kvstore dist_async: the server count changed "
                f"({self._stripes_nservers} -> {len(self._conns)}) with "
                "stripe plans still cached — a stale plan silently "
                "routes rows to the wrong servers.  Membership changes "
                "must go through the elastic roster path "
                "(MXNET_KVSTORE_ELASTIC=1), which calls "
                "_reset_stripe_plans() on every roster bump")
        if k in self._stripes:
            return self._stripes[k]
        if _STRIPE_SEP in k:
            # '@s' is the reserved stripe-suffix separator: a user key
            # 'w@s0' would collide with stripe 0 of key 'w' on the server
            # (ADVICE r5).  Every op derives its plan here.
            raise MXNetError(
                f"kvstore dist_async: key {k!r} contains the reserved "
                "stripe separator '@s' — rename the parameter")
        from . import membership as _mem
        plan = _mem.stripe_plan(k, shape, len(self._conns),
                                self._bigarray_bound)
        self._stripes[k] = plan
        self._stripes_nservers = len(self._conns)
        return plan

    def _reset_stripe_plans(self):
        """Invalidate every cached stripe plan (the roster changed: row
        boundaries and owners re-derive against the live server set).
        The elastic path calls this inside ``_apply_roster``."""
        self._stripes.clear()
        self._stripes_nservers = len(self._conns)

    def _stripe_conn(self, k: str, i: int) -> _ServerConn:
        # consecutive stripes on consecutive servers, offset by the key
        # hash (membership.stripe_server_index)
        from .membership import stripe_server_index
        return self._conns[stripe_server_index(k, i, len(self._conns))]

    # -- elastic membership (worker half; .membership) ----------------------
    def _coordinator_conn(self) -> _ServerConn:
        """The channel to the CURRENT roster coordinator — derived via
        membership.coordinator_uri (the worker-side twin of the
        server's _coordinator_addr, one source of truth for both).
        Connections are kept in roster order, so this is conns[0]
        except transiently mid-repair."""
        from .membership import coordinator_uri
        curi = coordinator_uri(self._roster_servers)
        for c in self._conns:
            if c._uri == curi:
                return c
        return self._conns[0]

    def _elastic_attempt(self, fn):
        """Run one kv op; under MXNET_KVSTORE_ELASTIC a channel failure
        triggers a roster repair (report the dead server, re-derive
        striping against the surviving set, hand off state, re-push the
        logged updates a dead server took with it) and ONE retry of the
        op against the new generation.  Non-elastic behavior is
        bit-identical to before: the failure propagates."""
        if not self._elastic:
            return fn()
        attempts = 0
        while True:
            try:
                return fn()
            except MXNetError:
                attempts += 1
                if attempts > 2 or not self._elastic_repair():
                    raise

    def _elastic_repair(self) -> bool:
        """Span-wrapped entry: a repair episode (and the handoff inside
        it) shows up on the merged cluster timeline as one
        ``kv.repair`` span — the observable form of "this worker rode a
        roster bump"."""
        with _tr.span("kv.repair", cat="elastic"):
            return self._elastic_repair_impl()

    def _elastic_repair_impl(self) -> bool:
        """Converge this worker onto the live roster after a failure.
        Returns True when anything changed (retry is worth it): a
        generation bump was applied, or a poisoned-but-alive connection
        was re-dialed.

        The COORDINATOR going down is just another membership event:
        this worker independently elects
        ``membership.elect_successor(roster, dead)`` — the same pure
        arithmetic every other observer computes, no votes — and
        reports the death THERE.  The successor verifies the death with
        its own probe, rebuilds the ledger at max(reported
        generation)+1 and answers with the post-succession roster; the
        ordinary three-phase handoff then reconstructs the dead
        coordinator's stripes.  Only every-server-dead is
        unrecoverable (elect_successor returns None)."""
        from . import membership as _mem
        from . import profiler as _prof
        dead, poisoned = [], []
        for c in self._conns:
            if (c._err is not None and c._sock is None) or c.is_dead():
                dead.append(c)
            elif c._err is not None:
                poisoned.append(c)
        dead_uris = {c._uri for c in dead}
        coord_uri = _mem.coordinator_uri(self._roster_servers)
        succession = coord_uri in dead_uris
        # flight-recorder evidence BEFORE any wire work: even if this
        # worker dies mid-repair, its bundle names who it saw dead and
        # that a repair was in flight (tools/postmortem.py correlates
        # these across survivors)
        for u in sorted(dead_uris):
            _health.note("peer_dead", uri=u,
                         coordinator=bool(u == coord_uri))
        _health.note("repair.begin", dead=sorted(dead_uris),
                     poisoned=[c._uri for c in poisoned])
        reply = None
        while True:
            if coord_uri in dead_uris:
                succ_uri = _mem.elect_successor(self._roster_servers,
                                                dead_uris)
                if succ_uri is None:
                    return False   # every server dead: nothing to elect
                target = next((c for c in self._conns
                               if c._uri == succ_uri), None)
                if target is None:
                    return False   # conns/roster diverged: no dial
            else:
                target = self._coordinator_conn()
            try:
                # report the dead coordinator FIRST: the hint lets the
                # successor verify + promote inside this very request
                for uri in sorted(dead_uris, key=lambda u: u != coord_uri):
                    reply = target.submit(
                        ("roster_dead", "server", uri), wait=True)
                    _prof.record_channel_event("kvstore.eviction_reported")
                if reply is None:
                    reply = target.submit(("roster_get",), wait=True)
                break
            except MXNetError:
                if target._err is not None and target._sock is None \
                        and target._uri not in dead_uris:
                    # the elected target ITSELF died before answering
                    # (simultaneous multi-server preemption): its
                    # channel is now hard evidence — add it to the dead
                    # set and walk the election to the next slot, the
                    # same probe-walk the server side runs
                    dead_uris.add(target._uri)
                    succession = True
                    continue
                return False   # an app refusal / unreachable roster
        gen, servers, workers = reply
        if int(gen) == self._roster_gen and not dead and not poisoned:
            return False
        try:
            self._apply_roster(int(gen), servers, workers)
        except MXNetError as exc:
            # a roster-listed server died between the coordinator's view
            # and our dial: report it so the NEXT repair converges on the
            # shrunken roster, and let the original failure propagate —
            # aborting the retry here must not strand the conn list
            # half-applied (it hasn't been: _apply_roster swaps conns
            # only after every dial succeeded)
            uri = next((u for u in servers if u in str(exc)), None)
            if uri is not None:
                try:
                    target.submit(("roster_dead", "server", uri),
                                  wait=True)
                except MXNetError:
                    pass
            return False
        if succession:
            self._failovers += 1
            _prof.record_channel_event(
                "kvstore.coordinator_failover_observed")
            _health.note("failover_observed",
                         coordinator_slot=self._coordinator_slot)
        _health.note("repair.end", generation=self._roster_gen)
        return True

    def _elastic_refresh(self):
        """Pull the roster and converge if it moved (the cheap path a
        barrier-reply generation bump triggers)."""
        with _tr.span("kv.refresh", cat="elastic"):
            reply = self._coordinator_conn().submit(("roster_get",),
                                                    wait=True)
            gen, servers, workers = reply
            if int(gen) != self._roster_gen:
                self._apply_roster(int(gen), servers, workers)

    def _apply_roster(self, gen, servers, workers):
        """Converge onto roster generation ``gen``: rebuild the
        connection list in roster order (reusing healthy channels,
        re-dialing poisoned ones, closing departed ones), invalidate
        every stripe plan, ship the optimizer to newly-joined servers,
        then hand off state for every key whose wire layout moved."""
        from . import membership as _mem
        from . import profiler as _prof
        old_servers = list(self._roster_servers)
        by_uri = {c._uri: c for c in self._conns}
        conns, fresh = [], []
        try:
            for u in servers:
                c = by_uri.pop(u, None)
                if c is not None and (c._err is not None or c.is_dead()):
                    c.close(retry=False)
                    c = None
                if c is None:
                    # short dial budget: a roster-listed server that
                    # cannot be reached within 10s most likely died
                    # between the coordinator's view and ours — the
                    # caller reports it dead and retries on the smaller
                    # roster instead of blocking a full connect window
                    c = _ServerConn(u, connect_timeout=10.0,
                                    rank=self.rank)
                    fresh.append((u, c))
                conns.append(c)
        except MXNetError:
            for _u, c in fresh:
                c.close(retry=False)
            raise
        for c in by_uri.values():
            c.close(retry=False)
        self._conns = conns
        self._roster_gen = int(gen)
        self._roster_servers = list(servers)
        self._live_workers = list(workers)
        self._reset_stripe_plans()
        self._last_moved_keys = set()
        _prof.record_channel_event("kvstore.roster_bump")
        _prof.record_channel_gauge("kvstore.roster_generation",
                                   self._roster_gen)
        # every connection was just rebuilt against the live roster:
        # outstanding channel poison is repaired, not outstanding
        _health.clear_channel_poison()
        _health.note("roster_bump", generation=self._roster_gen)
        # which bootstrap slot leads now (-1 = a joined-later server):
        # a failover is observable as this gauge moving off slot 0
        curi = _mem.coordinator_uri(servers)
        self._coordinator_slot = (
            self._bootstrap_servers.index(curi)
            if curi in self._bootstrap_servers else -1)
        _prof.record_channel_gauge("kvstore.coordinator_slot",
                                   self._coordinator_slot)
        # a joined-mid-job server has no updater yet: every worker ships
        # the optimizer (idempotent — same object) before any state or
        # gradient can reach the new shard
        if self._optimizer is not None:
            blob = pickle.dumps(self._optimizer)
            from .kvstore_server import K_CONTROLLER
            for _u, c in fresh:
                if _u not in old_servers:
                    c.submit(("command", K_CONTROLLER, blob), wait=True)
        with self._elastic_lock:
            cache_shapes = {k: v.shape
                            for k, v in self._pull_cache.items()}
        moved = _mem.plan_handoff(
            cache_shapes, old_servers, servers, self._bigarray_bound)
        self._last_moved_keys = set(moved)
        if moved and self._gc_residual:
            # compression error-feedback residuals are keyed by WIRE key
            # and shaped like the OLD stripe spans: under the new layout
            # a moved key's residual would broadcast-add into the wrong
            # rows (or crash on shape mismatch).  Dropping it loses at
            # most one pending quantum per element — the bounded error
            # class compression already accepts — and the buffer re-grows
            # from zero on the next push.  Unmoved keys keep identical
            # wire spans, so their residuals stay valid.
            moved_set = set(moved)
            for wk in [w for w in self._gc_residual
                       if _mem.base_key(w) in moved_set]:
                del self._gc_residual[wk]
        if moved and self._sparse_residual:
            # row-sparse residuals are keyed by GLOBAL row id, so the
            # restripe arithmetic can be exact: drop only the rows whose
            # owning server changed (membership.moved_row_spans) — a row
            # that stayed with its server keeps its un-drained error,
            # the whole point of keying residuals per row (the moved-key
            # rule applied at row granularity)
            moved_set = set(moved)
            for bk in [b for b in self._sparse_residual
                       if b in moved_set]:
                shape = self._sparse_shapes.get(bk) \
                    or cache_shapes.get(bk)
                if shape is None:
                    # no recorded geometry to compute spans against:
                    # dropping the whole bank is the safe degradation
                    del self._sparse_residual[bk]
                    continue
                spans = _mem.moved_row_spans(
                    bk, shape, old_servers, servers,
                    self._bigarray_bound)
                bank = self._sparse_residual[bk]
                for rid in [r for r in bank
                            if any(lo <= r < hi for lo, hi in spans)]:
                    del bank[rid]
                if not bank:
                    del self._sparse_residual[bk]
        if moved:
            self._handoff(moved, old_servers)

    def _handoff(self, moved, old_servers):
        """Striped-state handoff after a roster bump, in three ordered
        phases:

        1. **quorum re-push of values** — every worker re-pushes its
           last-synced full value of each moved key under the NEW
           layout; the server applies the FIRST arrival per (wire key,
           generation) and acks the rest idempotently, so the racing
           duplicates (and replays through connection kills) are
           harmless.  The applied handoff purges the key's stale wire
           forms, so in-flight old-layout pushes are absorbed into the
           reset.
        2. **optimizer-state restripe** — per-stripe states gathered
           from the coordinator's snapshot of the departed servers plus
           ``get_states`` of the survivors, merged and re-sliced along
           the new plan (exact for elementwise state; a killed server
           with no banked snapshot degrades to fresh state for its
           stripes).
        3. **re-push of logged updates** — each worker re-applies every
           gradient it pushed since its last pull of a moved key (the
           updates a SIGKILLed server took to its grave, or that the
           handoff reset absorbed).  Phases 1+2 are awaited before 3 so
           re-pushed gradients can never be wiped by a later handoff."""
        from . import membership as _mem
        from . import profiler as _prof
        gen = self._roster_gen
        servers = self._roster_servers
        # The whole handoff — and each of its three protocol phases —
        # is a span, so a roster bump's repair window reads off the
        # merged cluster timeline instead of only off the
        # failover_rebuild_s gauge.  The wire
        # behavior is UNCHANGED: values and states all enqueue before
        # any await (max pipelining); the shared await of phases 1+2
        # completes inside the states span, and phase 3 still starts
        # only after it.
        hsp = _tr.span_begin("kv.handoff", cat="elastic",
                             args={"moved": len(moved),
                                   "generation": int(gen)})
        try:
            # gather old-layout optimizer state BEFORE any value handoff
            # is issued: the first value handoff of a key PURGES its
            # stale wire forms (and their states) on the survivors —
            # collecting after would read back nothing
            with _tr.span("handoff.collect", cat="elastic"):
                per_wire = self._collect_handoff_states(moved, old_servers)
            # one consistent snapshot of the moved keys' cached values
            # and logged gradients: the wire work below must not hold
            # the elastic lock (it blocks on replies), and reading the
            # live structures per-key would race a concurrent
            # _cache_value from an in-flight handle resolve
            with self._elastic_lock:
                cache_snap = {k: self._pull_cache.get(k) for k in moved}
                log_snap = {k: list(self._push_log.get(k, ()))
                            for k in moved}
            pendings = []
            # per-phase flight-recorder breadcrumbs: with MXNET_TRACE=0
            # the spans vanish but the postmortem can still name the
            # repair phase in flight from the bundles alone
            _health.note("handoff.values", moved=len(moved),
                         generation=int(gen))
            with _tr.span("handoff.values", cat="elastic"):
                for k in moved:
                    val = cache_snap.get(k)
                    if val is None:
                        continue
                    for wk, uri, part in _mem.restripe_value(
                            k, val, servers, self._bigarray_bound):
                        part = np.ascontiguousarray(part)
                        _prof.record_channel_bytes("handoff",
                                                   int(part.nbytes))
                        pendings.append(
                            self._conns[servers.index(uri)].request(
                                ("handoff", gen, wk, part, k)))
            _health.note("handoff.states", generation=int(gen))
            with _tr.span("handoff.states", cat="elastic"):
                if per_wire:
                    for k in moved:
                        shape = cache_snap[k].shape
                        old_plan = _mem.stripe_plan(
                            k, shape, len(old_servers),
                            self._bigarray_bound)
                        new_plan = _mem.stripe_plan(
                            k, shape, len(servers), self._bigarray_bound)
                        restriped = _mem.restripe_states(
                            k, per_wire, old_plan, new_plan)
                        layout = _mem.wire_layout(k, shape, servers,
                                                  self._bigarray_bound)
                        for wk, st in restriped.items():
                            uri = layout[wk][0]
                            pendings.append(
                                self._conns[servers.index(uri)].request(
                                    ("handoff_state", gen, wk, st, k)))
                for p in pendings:
                    _await(p)
            _prof.record_channel_event("kvstore.handoff_round")
            _health.note("handoff.repush", generation=int(gen))
            with _tr.span("handoff.repush", cat="elastic"):
                for k in moved:
                    for grad in log_snap.get(k, ()):
                        _prof.record_channel_event("kvstore.orphan_repush")
                        self._route_push(k, grad)
        finally:
            _tr.span_end(hsp)

    def _collect_handoff_states(self, moved, old_servers):
        """{old wire key: np state} for the moved keys: the departed
        servers' stripes from the coordinator's banked snapshots, the
        survivors' from a live ``get_states``.  Returns {} when no
        optimizer is installed (nothing to restripe)."""
        from .kvstore_server import _restricted_loads, _state_to_np
        departed = [u for u in old_servers
                    if u not in self._roster_servers]
        per_wire = {}
        for u in departed:
            try:
                snap = self._coordinator_conn().submit(
                    ("roster_snapshot", u), wait=True)
            except MXNetError:
                snap = None
            if snap:
                for wk, st in snap.get("states", {}).items():
                    per_wire[str(wk)] = st
        have_updater = False
        for c in self._conns:
            try:
                blob = c.submit(("get_states", False), wait=True)
            except MXNetError:
                continue
            if blob is None:
                continue
            have_updater = True
            for wk, st in _restricted_loads(blob).items():
                per_wire[str(wk)] = _state_to_np(st)
        return per_wire if have_updater else {}

    def _route_push(self, k: str, agg):
        """Send one (possibly compressed) push of a full gradient under
        the CURRENT stripe plan: the orphan re-push, through the same
        planner as :meth:`push` (a logged row-sparse gradient re-routes
        through the per-stripe sparse planner), without logging it
        again."""
        self._push_planned([(k, agg)], log=False)

    def _push_mark(self, k: str) -> int:
        """The key's current absolute push position — captured at pull
        ENQUEUE time so the later cache sync absorbs exactly the pushes
        that pull observed (per-conn FIFO: everything sent before the
        pull request, nothing after)."""
        with self._elastic_lock:
            return self._push_log_seq.get(k, 0)

    def _cache_value(self, k: str, arr, mark=None):
        """Remember the last synced full value of ``k`` (the quorum
        re-push source) and absorb the log entries the value reflects:
        everything up to ``mark`` (the pull's enqueue position), or the
        whole log when ``mark`` is None (init/assign — the value IS the
        authoritative state)."""
        if not self._elastic:
            return
        arr = np.asarray(arr)
        with self._elastic_lock:
            self._pull_cache[k] = arr
            seq = self._push_log_seq.get(k, 0)
            if mark is None or mark > seq:
                mark = seq
            absorbed = self._push_log_absorbed.get(k, 0)
            n = mark - absorbed
            if n > 0:
                entries = self._push_log.get(k)
                if entries:
                    del entries[:min(n, len(entries))]
                    if not entries:
                        self._push_log.pop(k, None)
            self._push_log_absorbed[k] = max(absorbed, mark)

    def _log_push(self, k: str, agg: np.ndarray):
        """Remember one pushed gradient until a pull of ``k`` that
        observed it syncs it into the cache (bounded by
        MXNET_KVSTORE_ELASTIC_PUSH_LOG entries; the oldest fall off —
        best-effort for jobs that never pull)."""
        if not self._elastic:
            return
        if isinstance(agg, torch.Tensor):
            agg = agg.detach().clone()   # the caller's buffer is reused
        elif not isinstance(agg, RowSparsePayload):
            agg = np.array(agg, copy=True)
        with self._elastic_lock:
            self._push_log.setdefault(k, []).append(agg)
            self._push_log_seq[k] = self._push_log_seq.get(k, 0) + 1
            self._push_log_order.append(k)
            while len(self._push_log_order) > self._push_log_cap:
                old = self._push_log_order.popleft()
                entries = self._push_log.get(old)
                if entries:
                    entries.pop(0)
                    # a cap-dropped entry counts as absorbed so later
                    # marks keep addressing the list front correctly
                    self._push_log_absorbed[old] = \
                        self._push_log_absorbed.get(old, 0) + 1
                    if not entries:
                        self._push_log.pop(old, None)

    # -- kv ops --------------------------------------------------------------
    def init(self, key, value):
        """First-arriving init wins at the server (all workers call init;
        the server keeps one authoritative value)."""
        with _tr.span("kv.init"):
            self._elastic_attempt(lambda: self._init_impl(key, value))

    def _init_impl(self, key, value):
        keys, values = self._canon(key, value)
        for k, vs in zip(keys, values):
            arr = vs[0].asnumpy()
            plan = self._stripe_plan(k, arr.shape)
            if plan is None:
                self._conn_of(k).submit(("init", k, arr), wait=True)
            else:
                pendings = [
                    self._stripe_conn(k, i).request(
                        ("init", f"{k}@s{i}", arr[plan[i]:plan[i + 1]]))
                    for i in range(len(plan) - 1)]
                for p in pendings:
                    _await(p)
            self._cache_value(k, arr)

    def _wire_push_payload(self, wire_key, arr):
        """One push payload for the wire: compressed when compression is
        on (2-bit keeps its error-feedback residual here, keyed by WIRE
        key, on ``arr``'s device; Q1 runs on a card tensor), otherwise
        the raw value.  A card tensor's bytes go to pinned host memory
        by a copy queued on the current stream (:meth:`_push_planned`
        synchronizes once before the round is submitted); bf16, which
        numpy lacks, travels as float32."""
        from .compression import _to_host
        gc = self._gcompress
        if isinstance(arr, torch.Tensor):
            if gc is not None and gc.active:
                payload = gc.compress(wire_key, arr, self._gc_residual)
                if not isinstance(payload, torch.Tensor):
                    return payload
                arr = payload
            if arr.dtype == torch.bfloat16:
                arr = arr.float()
            return _to_host(arr.contiguous())
        if gc is None or not gc.active:
            return arr
        return gc.compress(wire_key, arr, self._gc_residual)

    @staticmethod
    def _payload_nbytes(payload) -> int:
        from .compression import WirePayload
        if isinstance(payload, RowSparsePayload):
            data = payload.data
            if isinstance(data, WirePayload):
                data = data.data
            return int(data.nbytes) + int(payload.indices.nbytes)
        data = payload.data if isinstance(payload, WirePayload) \
            else payload
        return int(data.nbytes)

    def _sparse_agg(self, k, vs):
        """Merge one key's row-sparse copies into a raw RowSparsePayload
        (sorted unique GLOBAL row ids, duplicate rows summed) without
        densifying, or None when the sparse wire does not apply (values
        not row-sparse, the knob off, or the touch density past
        MXNET_KVSTORE_SPARSE_DENSITY_CUTOVER)."""
        from .ndarray.sparse import RowSparseNDArray
        if not self._sparse_wire \
                or not all(isinstance(v, RowSparseNDArray) for v in vs):
            return None
        nrows = int(vs[0].shape[0])
        idx_parts = [np.asarray(v.indices.asnumpy(), np.int64)
                     for v in vs]
        row_parts = [np.asarray(v.data.asnumpy()) for v in vs]
        allidx = np.concatenate(idx_parts)
        allrows = np.concatenate(row_parts, axis=0)
        uniq, inv = np.unique(allidx, return_inverse=True)
        if uniq.size and (int(uniq[0]) < 0 or int(uniq[-1]) >= nrows):
            raise MXNetError(
                f"row-sparse push of key {k!r}: row ids span "
                f"[{int(uniq[0])}, {int(uniq[-1])}], key has "
                f"{nrows} rows")
        if uniq.size > self._sparse_cutover * nrows:
            return None
        summed = np.zeros((uniq.size,) + allrows.shape[1:],
                          allrows.dtype)
        np.add.at(summed, inv, allrows)
        self._sparse_shapes[k] = tuple(vs[0].shape)
        return RowSparsePayload(uniq, nrows, summed)

    def _wire_sparse_payload(self, base_key, global_ids, wire_ids,
                             rows, nrows):
        """The on-wire RowSparsePayload for one destination: ``wire_ids``
        local to the receiving stripe, compression residuals keyed by
        ``base_key`` + GLOBAL row id."""
        ids = np.ascontiguousarray(np.asarray(wire_ids, np.int64))
        gc = self._gcompress
        if gc is None or not gc.active:
            return RowSparsePayload(ids, nrows,
                                    np.ascontiguousarray(rows))
        bank = self._sparse_residual.setdefault(
            base_key, _hb.track({}, "kvstore._sparse_residual[%s]"
                                % base_key))
        return RowSparsePayload(
            ids, nrows, gc.compress_rows(global_ids, rows, bank))

    def _sparse_wire_entries(self, k, p):
        """Plan one row-sparse push: ``[(wire_key, conn, msg)]``, one entry
        per stripe the index set touches (an untouched stripe sends
        nothing)."""
        from . import membership as _mem
        from . import profiler as _prof
        idx = np.asarray(p.indices, np.int64)
        if idx.size == 0:
            return []
        rows = np.asarray(p.data)
        shape = self._sparse_shapes.get(k, (p.nrows,) + rows.shape[1:])
        plan = self._stripe_plan(k, shape)
        _prof.record_channel_count("kvstore.sparse_rows", int(idx.size))
        if plan is None:
            payload = self._wire_sparse_payload(k, idx, idx, rows,
                                                p.nrows)
            return [(k, self._conn_of(k), ("push", k, payload))]
        out = []
        for i, local_ids, pos in _mem.sparse_route(plan, idx):
            wk = f"{k}@s{i}"
            payload = self._wire_sparse_payload(
                k, idx[pos], local_ids,
                np.ascontiguousarray(rows[pos]),
                plan[i + 1] - plan[i])
            out.append((wk, self._stripe_conn(k, i),
                        ("push", wk, payload)))
        return out

    def push(self, key, value, priority=0):
        """Reduce the local copies and hand the result to the channels;
        returns at once and the server applies the update when the push
        arrives (async SGD).  Striped keys push one row slice per server;
        a LIST push coalesces small keys bound for one server into one
        ``push_multi`` envelope (``MXNET_KVSTORE_COALESCE_BYTES``).

        Elastic note: push is fire-and-forget, so it is never retried
        whole (earlier keys of the call may already sit in healthy
        server queues).  The call is planned first and submitted second:
        a submit that meets a failed channel repairs the roster, then
        re-routes only the REMAINING entries, skipping keys whose layout
        moved (the repair re-pushed those from the push log)."""
        keys, values = self._canon(key, value)
        with _tr.span("kv.push", args={"keys": len(keys)}):
            pairs = []
            for k, vs in zip(keys, values):
                sp = self._sparse_agg(k, vs)
                pairs.append((k, sp) if sp is not None
                             else (k, self._reduce(vs).detach()))
            self._push_aggregated(pairs)

    def _push_aggregated(self, pairs):
        """One push round of reduced gradients ``[(key, tensor or numpy
        or RowSparsePayload)]``, the shared tail of :meth:`push` and
        :meth:`ship_chunk_steps`.

        Under MXNET_KVSTORE_HIERARCHY this call IS one mesh round: a
        follower reads its gradients back and deposits them with the
        host-group leader (in-host ``ici_*`` / ``shm_*`` bytes, no
        compression: the error-feedback residual lives where the wire
        is) and returns; the leader blocks for the group's round, sums
        on its device (``kv.mesh_reduce``) and ships ONE summed push a
        key through :meth:`_push_planned` (``kv.leader_ship``:
        compression, striping and coalescing all act on the sum)."""
        if not self._hier:
            self._push_planned(pairs)
            return
        seq = self._mesh_push_seq
        self._mesh_push_seq += 1
        if self._mesh_conn is not None:   # follower
            self._mesh_conn.submit(
                ("mesh_push", seq,
                 [(k, a if isinstance(a, RowSparsePayload)
                   else _host_np(a)) for k, a in pairs]),
                wait=False)
            return
        with _tr.span("kv.mesh_reduce", cat="hier",
                      args={"seq": seq, "keys": len(pairs)}):
            contribs = self._mesh_leader.collect_push(seq)
            pairs = self._mesh_reduce(pairs, contribs)
        with _tr.span("kv.leader_ship", cat="hier",
                      args={"keys": len(pairs)}):
            self._push_planned(pairs)

    def _push_planned(self, pairs, log=True):
        """The wire half of a push round ``[(key, tensor or numpy or
        RowSparsePayload)]``: compression, striping, same-server
        coalescing and the elastic push log (the shared tail of
        :meth:`push`, :meth:`ship_chunk_steps` and the orphan re-push,
        which passes ``log=False``)."""
        small: Dict[int, list] = {}   # conn index -> [(wire_key, payload)]
        planned = []                  # (base_key, conn, msg)
        cuda_devs = set()
        for k, agg in pairs:
            if isinstance(agg, RowSparsePayload):
                if np.asarray(agg.indices).size == 0:
                    continue   # nothing touched: nothing rides or is logged
                if log:
                    self._log_push(k, agg)
                for wk, conn, msg in self._sparse_wire_entries(k, agg):
                    if (wk == k and len(pairs) > 1
                            and self._payload_nbytes(msg[2])
                            <= self._coalesce_bytes):
                        small.setdefault(
                            self._conns.index(conn), []).append(
                                (k, msg[2]))
                    else:
                        planned.append((k, conn, msg))
                continue
            if log:
                self._log_push(k, agg)
            if isinstance(agg, torch.Tensor) and agg.is_cuda:
                cuda_devs.add(agg.device)
            plan = self._stripe_plan(k, tuple(agg.shape))
            if plan is None:
                payload = self._wire_push_payload(k, agg)
                conn = self._conn_of(k)
                if (len(pairs) > 1
                        and self._payload_nbytes(payload)
                        <= self._coalesce_bytes):
                    small.setdefault(self._conns.index(conn), []).append(
                        (k, payload))
                else:
                    planned.append((k, conn, ("push", k, payload)))
            else:
                for i in range(len(plan) - 1):
                    wk = f"{k}@s{i}"
                    planned.append((k, self._stripe_conn(k, i), (
                        "push", wk, self._wire_push_payload(
                            wk, agg[plan[i]:plan[i + 1]]))))
        for ci, entries in small.items():
            if len(entries) == 1:
                planned.append((entries[0][0], self._conns[ci],
                                ("push", entries[0][0], entries[0][1])))
            else:
                planned.append((None, self._conns[ci],
                                ("push_multi", entries)))
        # the copies to pinned host memory were queued on each device's
        # current stream: the bytes are host-visible once it drains
        for dev in cuda_devs:
            torch.cuda.current_stream(dev).synchronize()
        self._submit_planned(planned)

    def _submit_planned(self, planned):
        """Submit planned push envelopes; on a channel failure in
        elastic mode, repair once and re-route the remainder under the
        new layout (moved keys skipped: the repair's log re-push owns
        them)."""
        for idx, (_k, conn, msg) in enumerate(planned):
            try:
                conn.submit(msg, wait=False)
            except MXNetError:
                if not self._elastic or not self._elastic_repair():
                    raise
                self._reroute_planned(planned[idx:])
                return

    def _reroute_planned(self, rest):
        """Re-route the unsent tail of a push call after a repair.  Keys
        the repair moved are dropped here (their full logged gradients
        were already re-pushed under the new layout); unmoved keys keep
        their wire keys and go to the same URI's fresh channel."""
        moved = self._last_moved_keys
        for k, _old_conn, msg in rest:
            if msg[0] == "push_multi":
                for ek, payload in msg[1]:
                    if ek not in moved:
                        self._conn_of(ek).submit(("push", ek, payload),
                                                 wait=False)
            elif k not in moved:
                wk = msg[1]
                if _STRIPE_SEP in wk:
                    base, i = wk.rsplit(_STRIPE_SEP, 1)
                    self._stripe_conn(base, int(i)).submit(msg, wait=False)
                else:
                    self._conn_of(wk).submit(msg, wait=False)

    def assign(self, key, value):
        """Store value(s) verbatim on the owning server(s), bypassing the
        installed updater.  Awaited: every later ``pull`` observes the
        value (the serving version-bump publication contract).
        Idempotent, so the elastic path may retry it whole after a
        roster repair."""
        with _tr.span("kv.assign"):
            self._elastic_attempt(lambda: self._assign_impl(key, value))

    def _assign_impl(self, key, value):
        keys, values = self._canon(key, value)
        pendings = []
        for k, vs in zip(keys, values):
            arr = vs[0].asnumpy()
            plan = self._stripe_plan(k, arr.shape)
            if plan is None:
                pendings.append(
                    self._conn_of(k).request(("assign", k, arr)))
            else:
                pendings.extend(
                    self._stripe_conn(k, i).request(
                        ("assign", f"{k}@s{i}",
                         arr[plan[i]:plan[i + 1]]))
                    for i in range(len(plan) - 1))
            self._cache_value(k, arr)
        for p in pendings:
            _await(p)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Fetch the servers' CURRENT weights (possibly mid-stream of other
        workers' pushes: staleness is the async contract) into each out
        array, on its device and in its dtype.  Every request is enqueued
        before any reply is awaited, so an N-key pull over S servers
        costs about one round trip.  Idempotent: the elastic path
        retries it whole after a roster repair."""
        with _tr.span("kv.pull"):
            self._elastic_attempt(lambda: self._pull_impl(key, out))

    def _pull_impl(self, key, out):
        assert out is not None
        keys, outs = self._canon(key, out)
        if self._hier:
            # one mesh round for the whole call: the leader runs (and
            # registers) the wire pull, followers collect in-host - the
            # same rendezvous sequence the chunked driver uses
            vals = self.pull_async(
                list(keys), [tuple(os_[0].shape) for os_ in outs]).wait()
            for k, os_ in zip(keys, outs):
                for o in os_:
                    o._set_data(_from_host(vals[k], o._data.device,
                                           o._data.dtype))
            return
        entries = [self._enqueue_pull(k, tuple(os_[0].shape))
                   for k, os_ in zip(keys, outs)]
        for e, os_ in zip(entries, outs):
            parts = [np.asarray(_await(p[3])) for p in e["parts"]]
            val = parts[0] if len(parts) == 1 else \
                np.concatenate(parts, axis=0)
            # the completed pull is this worker's sync point for the
            # key: the cache becomes the quorum re-push value, and every
            # logged push the pull OBSERVED (up to its enqueue mark) is
            # absorbed into it
            self._cache_value(e["key"], val, mark=e["mark"])
            for o in os_:
                o._set_data(_from_host(val, o._data.device,
                                       o._data.dtype))

    def ship_chunk_steps(self, names, grads, shapes):
        """The ship leg of the chunked drivers (Module.run_steps and
        Trainer.step_k on this store): push one chunk's per-step
        gradients in STEP order (the servers' optimizer state advances
        once a step, as the eager loop ships), then enqueue the next
        pull and return its handle.  ``grads`` holds one list a step, one
        gradient (tensor or numpy) a name."""
        with _tr.span("kv.ship_chunk", args={"steps": len(grads)}):
            for step in grads:
                self._push_aggregated(list(zip(names, step)))
            return self.pull_async(list(names), list(shapes))

    def pull_async(self, keys, shapes):
        """Enqueue a batched pull of ``keys`` and return a
        :class:`_PullHandle` at once: the requests ride the pipelined
        window now (per-server FIFO, so the replies observe every earlier
        push of this worker) and ``handle.wait()`` collects the host
        values later, after the next chunk's compute has been launched.
        ``shapes`` gives each key's full shape, from which the stripe
        plan derives."""
        if isinstance(keys, str):
            keys, shapes = [keys], [shapes]
        keys = [_key(k) for k in keys]
        if self._hier:
            seq = self._mesh_pull_seq
            self._mesh_pull_seq += 1
            if self._mesh_conn is not None:   # follower
                pending = self._mesh_conn.request(
                    ("mesh_collect", seq, list(keys)))
                return _MeshPullHandle(self, keys, pending)
        entries = [self._elastic_attempt(
            lambda k=k, shape=shape: self._enqueue_pull(k, shape))
            for k, shape in zip(keys, shapes)]
        handle = _PullHandle(self, entries)
        if self._hier:
            self._mesh_leader.publish_handle(seq, handle)
        return handle

    def _enqueue_pull(self, k, shape):
        """Issue the per-stripe pull requests of one key under the
        CURRENT layout; returns the handle entry (the replan unit)."""
        plan = self._stripe_plan(k, tuple(shape))
        parts = []
        if plan is None:
            rows = int(shape[0]) if shape else 0
            parts.append([0, rows, k,
                          self._conn_of(k).request(("pull", k)), None])
        else:
            for i in range(len(plan) - 1):
                wk = f"{k}@s{i}"
                parts.append([plan[i], plan[i + 1], wk,
                              self._stripe_conn(k, i).request(
                                  ("pull", wk)), None])
        return {"key": k, "shape": tuple(shape), "parts": parts,
                "mark": self._push_mark(k)}

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows from the owning server(s): O(rows)
        on the wire (reference: DataHandleRowSparse,
        kvstore_dist_server.h:211).  Same out-array semantics as the
        local store.  Requests pipeline like pull."""
        with _tr.span("kv.row_sparse_pull"):
            self._elastic_attempt(
                lambda: self._row_sparse_pull_impl(key, out, row_ids))

    def _row_sparse_pull_impl(self, key, out, row_ids):
        from . import membership as _mem
        assert out is not None and row_ids is not None
        keys, outs = self._canon(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        reqs = []
        for k, os_, rid in zip(keys, outs, row_ids):
            _check_stripe_sep(self.type, k)
            idx = np.unique(np.asarray(rid.asnumpy(), dtype=np.int64))
            # out carries the full logical shape, so a fresh client
            # derives the stripe plan just like pull()
            plan = self._stripe_plan(k, tuple(os_[0].shape))
            if plan is not None and idx.size and (
                    idx[0] < 0 or idx[-1] >= plan[-1]):
                raise MXNetError(
                    f"row id out of range for key {k!r}: ids span "
                    f"[{idx[0]}, {idx[-1]}], key has {plan[-1]} rows")
            if plan is None:
                reqs.append((idx, self._conn_of(k).request(
                    ("pull_rowsparse", k, idx))))
            else:
                # each global row id to its stripe; stripes are
                # contiguous and idx sorted, so the replies joined in
                # stripe order realign with idx
                parts = [
                    self._stripe_conn(k, i).request(
                        ("pull_rowsparse", f"{k}@s{i}", local))
                    for i, local, _pos in _mem.sparse_route(plan, idx)]
                if not parts:
                    # no ids: one reply still tells the row shape
                    parts = [self._stripe_conn(k, 0).request(
                        ("pull_rowsparse", f"{k}@s0",
                         np.zeros(0, np.int64)))]
                reqs.append((idx, (plan, parts)))
        for (idx, pending), (k, os_) in zip(reqs, zip(keys, outs)):
            if isinstance(pending, tuple):
                plan, parts = pending
                replies = [self._await_rows(p, k) for p in parts]
                rows = np.concatenate([r for r, _shape in replies],
                                      axis=0)
                full_shape = (plan[-1],) + tuple(replies[0][1][1:])
            else:
                rows, full_shape = self._await_rows(pending, k)
            _write_row_sparse_out(os_, _from_host(rows, "cpu"),
                                  torch.from_numpy(idx), full_shape)

    @staticmethod
    def _await_rows(pending, k):
        """Await one pull_rowsparse reply, mapping the server's
        uninitialized-key error back to the KeyError the local store
        raises."""
        try:
            return _await(pending)
        except MXNetError as exc:
            msg = str(exc)
            if "KeyError" in msg and "uninitialized key" in msg:
                raise KeyError(
                    f"pull of uninitialized key {k!r}") from exc
            raise

    def set_optimizer(self, optimizer):
        """Ship the optimizer to the servers (reference kvstore.py:353:
        rank 0 pickles it; _send_command_to_servers head=0), then barrier
        so every worker sees the installed updater before pushing.
        Idempotent (same blob), so the elastic path retries it whole;
        every worker KEEPS the optimizer, so a server joining later is
        armed during the roster repair."""
        self._optimizer = optimizer
        self._elastic_attempt(lambda: self._ship_optimizer(optimizer))
        self.barrier()

    def _ship_optimizer(self, optimizer):
        # rank 0 owns the install (reference semantics); the other ranks
        # only re-arm JOINED servers during a repair
        if self.rank != 0:
            return
        from .kvstore_server import K_CONTROLLER
        blob = pickle.dumps(optimizer)
        for c in self._conns:
            c.submit(("command", K_CONTROLLER, blob), wait=True)

    def _send_command_to_servers(self, head, body):
        for c in self._conns:
            c.submit(("command", head, body), wait=True)

    def _owner_conn(self, wire_key: str) -> _ServerConn:
        """The connection of the server that OWNS a wire key (stripe
        suffix respected): the shard whose copy of that key's optimizer
        state is authoritative."""
        if _STRIPE_SEP in wire_key:
            base, i = wire_key.rsplit(_STRIPE_SEP, 1)
            try:
                return self._stripe_conn(base, int(i))
            except ValueError:
                pass  # '@s' from a pre-guard key: fall through
        return self._conn_of(wire_key)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        """Gather each server shard's {key: state} and write the merge, in
        the format both packages' ``Updater.set_states`` read (the states
        live on the servers; reference: kvstore_dist_server.h:131).  Each
        key's OWNER shard wins the merge: after a load, other shards may
        still hold stale loaded copies (ADVICE r5)."""
        from .kvstore_server import _restricted_loads, _wire_dumps
        merged, opt_obj = {}, None
        per_server = []
        for c in self._conns:
            blob = c.submit(("get_states", dump_optimizer), wait=True)
            if blob is None:
                raise MXNetError("there is no optimizer installed on the "
                                 "servers (set_optimizer first)")
            loaded = _restricted_loads(blob)
            if dump_optimizer:
                states, opt_obj = loaded  # identical snapshot per server
            else:
                states = loaded
            per_server.append((c, states))
        for _c, states in per_server:      # any-server fallback first
            merged.update(states)
        for c, states in per_server:       # then the owner's copy wins
            for k, v in states.items():
                if self._owner_conn(k if isinstance(k, str)
                                    else str(k)) is c:
                    merged[k] = v
        with open(fname, "wb") as fout:
            fout.write(_wire_dumps((merged, opt_obj) if dump_optimizer
                                   else merged, pickle.DEFAULT_PROTOCOL))

    def load_optimizer_states(self, fname):
        """Broadcast the saved union to every server; each shard applies
        all keys and a later get_states returns only the keys it owns."""
        with open(fname, "rb") as fin:
            blob = fin.read()
        self.load_optimizer_states_blob(blob)

    def load_optimizer_states_blob(self, blob):
        """Broadcast an already-read optimizer-state blob (the Gluon
        Trainer buffers a file read before the optimizer was shipped)."""
        for c in self._conns:
            c.submit(("set_states", blob), wait=True)

    def barrier(self):
        """Flush this worker's outstanding pushes, then rendezvous on
        the roster coordinator, server 0 of a static roster (reference:
        Postoffice::Barrier after engine drain).  An arrival carries this
        worker's barrier sequence number, so a retry is idempotent; a
        participant that dies mid-wait is NAMED, with its last-heartbeat
        age, in the static roster's failure.  Under
        MXNET_KVSTORE_ELASTIC the barrier RENEGOTIATES instead: the
        coordinator evicts the silent rank and wakes the survivors, and
        the reply carries the roster generation, so a bump is converged
        onto at every sync point; a coordinator that dies mid-wait gets
        the SAME (rank, seq) arrival re-sent to its elected successor."""
        with _tr.span("kv.barrier"):
            self._elastic_attempt(self._flush_all)
            self._barrier_seq += 1
            bseq = self._barrier_seq
            wtok = _health.wait_begin("kv.barrier")
            try:
                payload = self._elastic_attempt(
                    lambda: self._coordinator_conn().submit(
                        ("barrier", bseq), wait=True))
            finally:
                _health.wait_end(wtok)
            if isinstance(payload, (tuple, list)) and len(payload) == 2:
                # the coordinator realigned this (re-)joined rank to the
                # cohort's pending rendezvous: adopt the effective
                # sequence
                payload, realign = payload
                self._barrier_seq = bseq + int(realign)
            if self._elastic and isinstance(payload, int) \
                    and payload != self._roster_gen:
                # the refresh rides the repair wrapper too: the
                # coordinator can die in the reply-to-refresh window
                self._elastic_attempt(self._elastic_refresh)

    def _flush_all(self):
        if self._mesh_conn is not None:
            # a follower's queued mesh pushes must reach the leader
            # before its barrier arrival: the leader (also a barrier
            # participant) arrives only after shipping them, so "every
            # prior push visible after the barrier" holds through the
            # tier
            self._mesh_conn.flush()
        for c in self._conns:
            c.flush()

    def num_dead_nodes(self) -> int:
        """Server channels whose heartbeat has gone silent (reference:
        kvstore.h:328 get_num_dead_node)."""
        if self._closed:
            return 0
        return sum(1 for c in self._conns if c.is_dead())

    def server_stats(self, rank: int = 0) -> dict:
        """The full profiler snapshot of server ``rank`` over the wire
        (the ``("stats",)`` envelope every server answers);
        ``distributed.cluster_stats()`` sweeps it across the servers."""
        if not 0 <= rank < len(self._conns):
            raise MXNetError(
                f"server rank {rank} out of range "
                f"(live servers: {len(self._conns)})")
        return self._conns[rank].submit(("stats",), wait=True)

    def close(self, stop_servers=False):
        from .kvstore_server import K_STOP_SERVER
        self._closed = True
        if self._mesh_conn is not None:
            self._mesh_conn.close(retry=False)
            self._mesh_conn = None
        if self._mesh_leader is not None:
            self._mesh_leader.close()
            self._mesh_leader = None
        self._hier = False
        if self._roster_member:
            # graceful departure: deregister so the surviving workers'
            # barriers re-target without waiting out a heartbeat timeout
            try:
                self._coordinator_conn().submit(
                    ("roster_leave", "worker", self.rank), wait=True)
            except MXNetError:
                pass  # the coordinator will evict us on silence instead
        # deliver queued pushes while the servers are still guaranteed up
        for c in self._conns:
            try:
                c.flush()
            except MXNetError:
                pass  # channel already dead — nothing left to deliver
        if stop_servers:
            # best-effort: with several workers closing concurrently,
            # another worker's kStopServer may tear the connection down
            # before our own command is acked
            for c in self._conns:
                try:
                    c.submit(("command", K_STOP_SERVER, None), wait=True)
                except MXNetError:
                    pass
        for c in self._conns:
            # after kStopServer the server is DELIBERATELY gone: no
            # reconnect backoff during the final drain
            c.close(retry=not stop_servers)


def create(name="local") -> KVStore:
    """A store of type ``name`` (reference: kvstore.py:534 create ->
    KVStore::Create, kvstore.cc:34)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    name = name.lower()
    if name == "dist_async":
        return KVStoreDistAsync()
    if name in LOCAL_TYPES or name in DIST_TYPES:
        return KVStore(name)
    if name == "tpu":
        raise MXNetError("kvstore 'tpu': the port's devices are gpu(i); "
                         "use 'device' (multi-GPU is ROADMAP D1)")
    raise MXNetError(f"unknown kvstore type {name!r}")
