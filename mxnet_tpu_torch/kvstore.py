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
updater rebinds the store's own array.  Elastic membership and the
hierarchical tier of the distributed store are ROADMAP E2: their
switches raise.
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
        try:
            if self._sock is None:
                raise ConnectionError("channel has no connection")
            _send_msg(self._sock, envelope, fi_role="client",
                      byte_kind=self._byte_kinds[0])
            faultinject.client_window(self._sock, len(self._inflight))
        except Exception as exc:  # noqa: BLE001 — transport fault
            self._recover_or_fail(exc)

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
        from . import profiler as _prof
        # a complete round trip proves the transport healthy again
        self._retry_attempts = 0
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
    ``wait()`` blocks for every reply, joins the stripes and returns
    ``{key: np.ndarray}``.  Entries are ``{key, shape, parts: [[lo, hi,
    wire_key, pending, value]]}``.  (The JAX package's handle also
    replans a dead server's stripes under elastic membership, ROADMAP
    E2.)"""

    def __init__(self, kv, entries):
        super().__init__()
        self._kv = kv
        self._entries = _hb.track(entries, "kvstore._PullHandle.entries")

    def _nkeys(self):
        return len(self._entries)

    def _resolve(self):
        out = {}
        for e in self._entries:
            for part in e["parts"]:
                if part[4] is None:
                    part[4] = np.asarray(_await(part[3]))
                    part[3] = None
            parts = sorted(e["parts"], key=lambda p: p[0])
            out[e["key"]] = parts[0][4] if len(parts) == 1 else \
                np.concatenate([p[4] for p in parts], axis=0)
        return out


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
        from .base import env as _env
        for knob in ("MXNET_KVSTORE_ELASTIC", "MXNET_KVSTORE_HIERARCHY"):
            if _env(knob, False):
                raise MXNetError(
                    f"kvstore dist_async: {knob} (elastic membership and "
                    "the hierarchical tier) is not ported to "
                    "mxnet_tpu_torch yet (ROADMAP E2)")
        # explicit rank override (tests running several worker stores of
        # different ranks in one process; the launcher path leaves it
        # None).  ``roster_member`` belongs to elastic membership (E2).
        self._rank_override = None if rank is None else int(rank)
        if uris is None:
            uris = os.environ.get("MXT_SERVER_URIS", "")
        elif not isinstance(uris, str):
            uris = ",".join(uris)
        if not uris:
            raise MXNetError(
                "kvstore 'dist_async' needs running parameter servers: "
                "launch with `python tools/launch.py -n W -s S cmd...` "
                "(MXT_SERVER_URIS is set by the launcher)")
        self._barrier_seq = 0         # per-worker barrier sequence
        self._conns = [_ServerConn(u, rank=self.rank)
                       for u in uris.split(",")]
        self._bigarray_bound = int(float(os.environ.get(
            "MXNET_KVSTORE_BIGARRAY_BOUND", "1000000")))
        self._stripes: Dict[str, list] = {}  # key -> row boundaries
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

    @property
    def rank(self) -> int:
        if getattr(self, "_rank_override", None) is not None:
            return self._rank_override
        return int(os.environ.get("DMLC_WORKER_ID", "0"))

    @property
    def num_workers(self) -> int:
        return int(os.environ.get("DMLC_NUM_WORKER", "1"))

    def _conn_of(self, k: str) -> _ServerConn:
        # routing math lives in membership.server_index, shared with the
        # JAX package's handoff planner
        from .membership import server_index
        return self._conns[server_index(k, len(self._conns))]

    # -- big-array striping --------------------------------------------------
    def _stripe_plan(self, k: str, shape):
        """Row boundaries for a striped key, or None: deterministic from
        (key, shape, num_servers) (:func:`membership.stripe_plan`), so
        every worker derives the identical plan with no coordination."""
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
        return plan

    def _stripe_conn(self, k: str, i: int) -> _ServerConn:
        # consecutive stripes on consecutive servers, offset by the key
        # hash (membership.stripe_server_index)
        from .membership import stripe_server_index
        return self._conns[stripe_server_index(k, i, len(self._conns))]

    # -- kv ops --------------------------------------------------------------
    def init(self, key, value):
        """First-arriving init wins at the server (all workers call init;
        the server keeps one authoritative value)."""
        with _tr.span("kv.init"):
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
        ``push_multi`` envelope (``MXNET_KVSTORE_COALESCE_BYTES``)."""
        keys, values = self._canon(key, value)
        with _tr.span("kv.push", args={"keys": len(keys)}):
            pairs = []
            for k, vs in zip(keys, values):
                sp = self._sparse_agg(k, vs)
                pairs.append((k, sp) if sp is not None
                             else (k, self._reduce(vs).detach()))
            self._push_planned(pairs)

    def _push_planned(self, pairs):
        """The wire half of a push round ``[(key, tensor or numpy or
        RowSparsePayload)]``: compression, striping, same-server
        coalescing (the shared tail of :meth:`push` and
        :meth:`ship_chunk_steps`)."""
        small: Dict[int, list] = {}   # conn index -> [(wire_key, payload)]
        planned = []                  # (conn, msg)
        cuda_devs = set()
        for k, agg in pairs:
            if isinstance(agg, RowSparsePayload):
                if np.asarray(agg.indices).size == 0:
                    continue   # nothing touched: nothing rides
                for wk, conn, msg in self._sparse_wire_entries(k, agg):
                    if (wk == k and len(pairs) > 1
                            and self._payload_nbytes(msg[2])
                            <= self._coalesce_bytes):
                        small.setdefault(
                            self._conns.index(conn), []).append(
                                (k, msg[2]))
                    else:
                        planned.append((conn, msg))
                continue
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
                    planned.append((conn, ("push", k, payload)))
            else:
                for i in range(len(plan) - 1):
                    wk = f"{k}@s{i}"
                    planned.append((self._stripe_conn(k, i), (
                        "push", wk, self._wire_push_payload(
                            wk, agg[plan[i]:plan[i + 1]]))))
        for ci, entries in small.items():
            if len(entries) == 1:
                planned.append((self._conns[ci],
                                ("push", entries[0][0], entries[0][1])))
            else:
                planned.append((self._conns[ci], ("push_multi", entries)))
        # the copies to pinned host memory were queued on each device's
        # current stream: the bytes are host-visible once it drains
        for dev in cuda_devs:
            torch.cuda.current_stream(dev).synchronize()
        for conn, msg in planned:
            conn.submit(msg, wait=False)

    def assign(self, key, value):
        """Store value(s) verbatim on the owning server(s), bypassing the
        installed updater.  Awaited: every later ``pull`` observes the
        value."""
        with _tr.span("kv.assign"):
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
            for p in pendings:
                _await(p)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        """Fetch the servers' CURRENT weights (possibly mid-stream of other
        workers' pushes: staleness is the async contract) into each out
        array, on its device and in its dtype.  Every request is enqueued
        before any reply is awaited, so an N-key pull over S servers
        costs about one round trip."""
        assert out is not None
        keys, outs = self._canon(key, out)
        with _tr.span("kv.pull"):
            entries = [self._enqueue_pull(k, tuple(os_[0].shape))
                       for k, os_ in zip(keys, outs)]
            for e, os_ in zip(entries, outs):
                parts = [np.asarray(_await(p[3])) for p in e["parts"]]
                val = parts[0] if len(parts) == 1 else \
                    np.concatenate(parts, axis=0)
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
                self._push_planned(list(zip(names, step)))
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
        entries = [self._enqueue_pull(k, shape)
                   for k, shape in zip(keys, shapes)]
        return _PullHandle(self, entries)

    def _enqueue_pull(self, k, shape):
        """Issue the per-stripe pull requests of one key; returns the
        handle entry."""
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
        return {"key": k, "shape": tuple(shape), "parts": parts}

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the requested rows from the owning server(s): O(rows)
        on the wire (reference: DataHandleRowSparse,
        kvstore_dist_server.h:211).  Same out-array semantics as the
        local store.  Requests pipeline like pull."""
        from . import membership as _mem
        assert out is not None and row_ids is not None
        keys, outs = self._canon(key, out)
        if isinstance(row_ids, NDArray):
            row_ids = [row_ids] * len(keys)
        with _tr.span("kv.row_sparse_pull"):
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
        so every worker sees the installed updater before pushing."""
        self._optimizer = optimizer
        if self.rank == 0:
            from .kvstore_server import K_CONTROLLER
            blob = pickle.dumps(optimizer)
            for c in self._conns:
                c.submit(("command", K_CONTROLLER, blob), wait=True)
        self.barrier()

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
        server 0 (reference: Postoffice::Barrier after engine drain).  An
        arrival carries this worker's barrier sequence number, so a retry
        is idempotent; a participant that dies mid-wait is NAMED, with
        its last-heartbeat age, in the failure."""
        with _tr.span("kv.barrier"):
            self._flush_all()
            self._barrier_seq += 1
            bseq = self._barrier_seq
            wtok = _health.wait_begin("kv.barrier")
            try:
                payload = self._conns[0].submit(("barrier", bseq),
                                                wait=True)
            finally:
                _health.wait_end(wtok)
            if isinstance(payload, (tuple, list)) and len(payload) == 2:
                # the server realigned this (re-)joined rank to the
                # cohort's pending rendezvous: adopt the effective
                # sequence
                self._barrier_seq = bseq + int(payload[1])

    def _flush_all(self):
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
