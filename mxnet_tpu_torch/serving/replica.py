"""Serving replica: a model server speaking the hardened kvstore wire.

PyTorch counterpart of ``mxnet_tpu/serving/replica.py``: the same ops
and frames (a client of either package drives it), with the predictor
on the card (``ctx``, default ``gpu(0)``) and the wire on the host.

One process (or thread) = one replica: it loads a checkpoint into a
:class:`~mxnet_tpu_torch.serving.bucketed.BucketedPredictor`, accepts the
same zero-copy frames / allowlisted decode / exactly-once envelopes as
a parameter server (it IS a :class:`~mxnet_tpu_torch.kvstore_server.
KVStoreServer` subclass — the serving envelope types are extension ops
on the existing dispatch), and answers:

* ``("predict", {name: array})`` — through the dynamic batcher; reply
  payload ``("result", version, [outputs])`` or the typed
  ``("busy", {queue_depth, limit})`` shed signal.
* ``("serving_stats",)`` — version, queue depth, batch/shed counters
  and the profiler's p50/p99/QPS latency dict.
* ``("serving_refresh",)`` — force one weight-version check against the
  live parameter servers NOW (the deterministic form of the background
  poll).

**Pipelined connections.**  The base server handles one request per
connection at a time — correct for a parameter shard, fatal for a
batcher (a pipelined client's second request would wait on the first's
reply, so batches could never form across one connection).  The replica
overrides ``_serve_conn`` with a read-ahead loop: envelopes are decoded
as they arrive, predict ops park a reply slot in the batcher, and a
writer thread sends completed replies in STRICT arrival order — the
FIFO ack contract the client window replay machinery assumes is
preserved exactly.  Predict is pure, so a replayed predict after a
reconnect is simply re-run: it needs no dedup window entry.

**Train-and-serve.**  With ``param_servers=`` (or ``MXT_SERVER_URIS``)
the replica holds a worker-side kvstore client to the SAME dist_async
cluster a trainer updates.  A version bump
(:func:`mxnet_tpu_torch.serving.publish_version`) makes the next refresh
check ``pull()`` every served parameter and swap it in hot — one
process tree trains and serves, the ROADMAP's millions-of-users
scenario.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ..base import MXNetError, env
from .. import wirecodec as _codec
from ..kvstore_server import KVStoreServer, _send_msg, _recv_msg
from .. import profiler as _prof
from .. import tracing as _tr
from .. import health as _health
from .. import faultinject as _fi
from .batcher import DynamicBatcher, _ReplySlot
from .bucketed import BucketedPredictor

#: kvstore key carrying the published weight version (a 1-element
#: float64 register written with the updater-bypassing "assign" op)
VERSION_KEY = "__mxt_serving_version__"


class ServingReplica(KVStoreServer):
    """One inference replica on the kvstore wire."""

    def __init__(self, symbol, data_shapes: Dict[str, tuple], arg_params,
                 aux_params=None, buckets=None, compute_dtype=None,
                 host="127.0.0.1", port=0, param_servers=None,
                 refresh_interval=None, max_wait_s=None, queue_depth=None,
                 warmup=True, data_dtypes=None, ctx=None):
        super().__init__(server_id=0, num_workers=1, host=host, port=port)
        self._predictor = BucketedPredictor(
            symbol, data_shapes, arg_params, aux_params=aux_params,
            buckets=buckets, compute_dtype=compute_dtype,
            data_dtypes=data_dtypes, ctx=ctx)
        if warmup:
            self._predictor.warmup()
        self._batcher = DynamicBatcher(self._predictor,
                                       max_wait_s=max_wait_s,
                                       queue_depth=queue_depth)
        # predict bypasses the exactly-once dedup window on purpose: it
        # is PURE, so a post-reconnect replay re-runs harmlessly — and
        # must not hold a conn thread inside _exactly_once while the
        # batch forms (that would serialize the batcher per connection)
        self._deferred_ops = {"predict", "predict_canary"}
        # protocol: replay(pure) reply(predictions) codec(binary)
        self.register_op("predict", self._op_predict_sync)
        # the canary-tagged twin of predict: same batcher, same reply
        # shape, but counted separately (serving.canary_predict) so a
        # fleet's canary fraction is provable server-side; rides pickle
        # (the canary cohort is a fraction — never the hot path)
        # protocol: replay(pure) reply(predictions)
        self.register_op("predict_canary", self._op_predict_sync)
        # protocol: replay(pure) reply(serving stats dict)
        self.register_op("serving_stats", self._op_stats)
        # protocol: replay(idempotent) reply(version + refreshed)
        self.register_op("serving_refresh", self._op_refresh)
        # operator drain: an advisory flag the stats reply carries —
        # routers stop sending new work, in-flight requests finish
        # normally (("drain", False) undoes it; setting the same flag
        # twice is a no-op, hence idempotent)
        # protocol: replay(idempotent) reply(draining flag)
        self.register_op("drain", self._op_drain)
        self._draining = False
        if param_servers is None:
            import os
            param_servers = os.environ.get("MXT_SERVER_URIS") or None
        self._ps_uris = param_servers
        self._ps = None
        self._ps_lock = threading.Lock()
        self._seen_version: Optional[int] = None
        self.refreshes = 0
        self._refresh_interval = float(
            env("MXNET_SERVING_REFRESH_S", 0.0)
            if refresh_interval is None else refresh_interval)
        self._refresh_thread = None
        if self._refresh_interval > 0 and self._ps_uris:
            self._refresh_thread = threading.Thread(
                target=self._refresh_loop, daemon=True)
            self._refresh_thread.start()
        # the health watchdog samples the batcher queue every tick:
        # depth at (or past) MXNET_HEALTH_QUEUE_SAT x limit trips a
        # typed queue_saturated event and degrades this replica's
        # status — the serving half of the SLO plane.  Keyed by port:
        # two in-process replicas (tests, train-and-serve topologies)
        # must not overwrite each other's probe — and one replica's
        # stop() must not unregister the survivor's
        self._health_probe_name = "serving.queue:%d" % self.port
        _health.register_probe(self._health_probe_name,
                               self._health_probe)

    def _health_probe(self) -> dict:
        return {"queue_depth": self._batcher.queue_depth,
                "queue_limit": self._batcher.queue_limit}

    @classmethod
    def from_checkpoint(cls, prefix, epoch, data_shapes, **kwargs):
        """Load ``prefix-%04d.params`` (classic or sharded format — see
        :func:`mxnet_tpu_torch.checkpoint.load_serving_params`) and serve it."""
        from ..checkpoint import load_serving_params
        sym, args, auxs = load_serving_params(prefix, epoch)
        if sym is None:
            raise MXNetError(f"no symbol file at {prefix}-symbol.json — "
                             "a replica needs the graph, not just weights")
        return cls(sym, data_shapes, args, aux_params=auxs, **kwargs)

    # -- properties ----------------------------------------------------------
    @property
    def version(self) -> int:
        return self._predictor.version

    @property
    def buckets(self):
        return list(self._predictor.buckets)

    # -- serving envelope handlers -------------------------------------------
    def _dispatch_deferred(self, inner, span=None) -> _ReplySlot:
        """Pipelined path: park the predict in the batcher, return the
        reply slot the connection writer awaits (``span`` attaches to
        the slot BEFORE it is queued — see DynamicBatcher.submit)."""
        if inner and inner[0] == "predict_canary":
            _prof.record_channel_event("serving.canary_predict")
        payload = inner[1] if len(inner) > 1 else None
        return self._batcher.submit(payload, span=span)

    def _op_predict_sync(self, msg, rank):
        """Raw-message / legacy fallback: same batcher, awaited inline."""
        slot = self._batcher.submit(msg[1] if len(msg) > 1 else None)
        slot.done.wait()
        status, payload = slot.reply
        if status != "ok":
            raise MXNetError(str(payload))
        return payload

    def _op_stats(self, msg, rank):
        return {
            "version": self._predictor.version,
            "buckets": list(self._predictor.buckets),
            "queue_depth": self._batcher.queue_depth,
            "queue_limit": self._batcher.queue_limit,
            "batches": self._batcher.batches,
            "shed": self._batcher.shed,
            "refreshes": self.refreshes,
            # the operator drain flag (("drain",) envelope): advisory —
            # a fleet router treats a draining replica as ineligible
            # for NEW work while everything in flight completes
            "draining": self._draining,
            # which membership epoch the weight-refresh client last
            # converged onto (0 = static roster or no client yet): lets
            # an operator correlate a served-version stall with training
            # -cluster churn from the serving side alone
            "roster_generation": getattr(self._ps, "_roster_gen", 0) or 0,
            # which bootstrap slot leads the training roster (-1 = a
            # joined-later server) and how many coordinator successions
            # the refresh client has ridden: a FAILOVER is observable
            # from the serving side without log-diving
            "coordinator_slot": getattr(self._ps, "_coordinator_slot",
                                        0) or 0,
            "coordinator_failovers": getattr(self._ps, "_failovers",
                                             0) or 0,
            "latency": _prof.latency_stats("serving.request"),
            # the replica's health verdict next to its SLO numbers: a
            # BUSY storm or saturated queue reads as DEGRADED here (and
            # recovers with hysteresis — no flapping), so a router can
            # steer on serving_stats alone
            "health": _health.snapshot_section(compact=True),
        }

    def _op_refresh(self, msg, rank):
        return self._refresh_once()

    def _op_drain(self, msg, rank):
        """Operator drain toggle: ``("drain",)`` / ``("drain", True)``
        marks this replica draining, ``("drain", False)`` restores it.
        Advisory by design — the stats reply carries the flag and a
        router stops ROUTING here, while requests already in flight
        (and any client that ignores the flag) still complete: a drain
        must never fail the work it is trying to move elsewhere."""
        enable = bool(msg[1]) if len(msg) > 1 else True
        changed = enable != self._draining
        self._draining = enable
        if changed:
            _prof.record_channel_event("serving.drain" if enable
                                       else "serving.undrain")
            _health.note("serving_drain", enabled=enable, port=self.port)
        return {"draining": enable}

    def _stats_payload(self):
        """The universal ``("stats",)`` envelope, serving-flavored: the
        base server's full profiler snapshot plus the old
        ``serving_stats`` dict under ``serving`` — one stats op for the
        whole cluster, and ``serving_stats`` stays answering for
        existing clients (it IS the ``serving`` section)."""
        snap = super()._stats_payload()
        snap["serving"] = self._op_stats(None, None)
        return snap

    # -- weight refresh (live dist_async parameter servers) ------------------
    def _ps_client(self):
        if self._ps_uris is None:
            raise MXNetError(
                "this replica has no parameter servers to refresh from "
                "(pass param_servers= or set MXT_SERVER_URIS)")
        with self._ps_lock:
            if self._ps is None:
                from ..kvstore import KVStoreDistAsync
                # roster_member=False: under MXNET_KVSTORE_ELASTIC this
                # client FOLLOWS the training roster (a server evicted
                # between version pulls repairs transparently mid-pull)
                # but must never JOIN it — a replica registering as a
                # worker rank would inflate every training barrier, and
                # its close() would evict the real rank sharing its id
                self._ps = KVStoreDistAsync(uris=self._ps_uris,
                                            roster_member=False)
            return self._ps

    @staticmethod
    def _is_missing_key(exc) -> bool:
        """A pull that failed because the key was never init'ed on the
        servers (frozen param / version not yet published) — the ONE
        failure a refresh may shrug off.  Transport faults must NOT be
        filed here: skipping a param on a connection blip while still
        advancing the seen version would serve stale weights until the
        NEXT bump."""
        return "uninitialized key" in str(exc)

    def _drop_ps(self):
        """Discard the (possibly hard-poisoned) parameter-server client
        so the next refresh attempt re-dials fresh connections instead
        of re-raising the same channel poison forever."""
        with self._ps_lock:
            ps, self._ps = self._ps, None
        if ps is not None:
            try:
                ps.close()
            except Exception:  # noqa: BLE001 — already-dead channels
                pass

    def _published_version(self) -> Optional[int]:
        out = _host_zeros((1,), "float64")
        try:
            self._ps_client().pull(VERSION_KEY, out=out)
        except MXNetError as exc:
            if self._is_missing_key(exc):
                return None   # no version published yet
            # transport failure: surface it (the poll loop counts it,
            # a forced serving_refresh errs to the client) and re-dial
            # next time — a dead channel must not masquerade as
            # "nothing published"
            self._drop_ps()
            raise
        return int(round(float(out.asnumpy()[0])))

    def _refresh_once(self) -> dict:
        """Check the published version; on a bump, ``pull()`` every
        served parameter from the live servers and hot-swap.  Returns
        {version, refreshed, skipped}.  Raises on transport failure
        WITHOUT advancing the seen version, so the next poll retries
        the same bump."""
        published = self._published_version()
        if published is None or published == self._seen_version:
            return {"version": self._predictor.version,
                    "refreshed": False, "skipped": []}
        ps = self._ps_client()
        fresh, skipped = {}, []
        for name, (shape, dtype) in self._predictor.param_specs().items():
            # pulled into host arrays (the refresh client's wire is the
            # host's); set_params moves them to the predictor's device
            out = _host_zeros(shape, dtype)
            try:
                ps.pull(name, out=out)
            except MXNetError as exc:
                if self._is_missing_key(exc):
                    # a param the trainer never pushed (fixed/frozen):
                    # keep the checkpoint value
                    skipped.append(name)
                    continue
                self._drop_ps()
                raise
            fresh[name] = out
        if fresh:
            current = self._predictor.current_params()
            current.update(fresh)
            self._predictor.set_params(current, version=published)
        self._seen_version = published
        self.refreshes += 1
        _prof.record_channel_event("serving.weight_refresh")
        return {"version": self._predictor.version, "refreshed": True,
                "skipped": skipped}

    def _refresh_loop(self):
        while not self._stop.wait(self._refresh_interval):
            try:
                self._refresh_once()
            except Exception:  # noqa: BLE001 — poll must outlive blips
                # a refresh failure (servers restarting, transient net)
                # must not kill the poll: the replica keeps serving the
                # CURRENT weights and the next tick retries; the counter
                # makes the misses observable
                _prof.record_channel_event("serving.refresh_error")

    # -- pipelined connection loop -------------------------------------------
    def _serve_conn(self, conn):
        """Read-ahead request loop with in-order replies (see module
        docstring).  Decode errors (hostile frames) tear the connection
        down exactly like the base server: the exception leaves the
        loop, the connection closes, other clients are untouched."""
        import queue as _queue
        slots: _queue.Queue = _queue.Queue()
        writer = threading.Thread(target=self._reply_writer,
                                  args=(conn, slots), daemon=True)
        writer.start()
        try:
            with conn:
                while not self._stop.is_set():
                    try:
                        msg = _recv_msg(conn)
                    except (ConnectionError, OSError):
                        return
                    slots.put(self._admit(msg, conn))
        except Exception:  # noqa: BLE001 — hostile frame / conn death
            pass
        finally:
            slots.put(None)
            writer.join(timeout=30.0)

    def _admit(self, msg, conn):
        """Turn one decoded message into a reply slot: deferred serving
        ops park in the batcher, codec hellos register the connection,
        everything else completes inline through the base server's
        exactly-once machinery."""
        if msg and msg[0] == "req":
            _, cid, seq, inner = msg[:4]
            wctx = msg[4] if len(msg) > 4 else None
            if inner and inner[0] in self._deferred_ops:
                if isinstance(cid, (tuple, list)) and cid:
                    self._note_ping(cid[0])
                # DETACHED span, begun BEFORE the batcher sees the slot
                # (attaching after submit would race the batcher's
                # queue-wait annotation) and ended by the reply writer
                # once the slot completes — it covers the request's
                # whole replica stay (queue wait + padded forward),
                # child of the client-side call when the envelope
                # carried a trace field
                sp = None
                if _tr.enabled():
                    sp = _tr.span_begin(
                        "srv.predict", cat="server", detach=True,
                        ctx=(wctx[0], wctx[1]) if wctx else None,
                        args=({"client_send_us": float(wctx[2])}
                              if wctx and len(wctx) > 2 else None))
                slot = self._dispatch_deferred(inner, span=sp)
                slot.role = "server"
                return slot
            cidt = tuple(cid) if isinstance(cid, list) else cid
            reply = self._traced_exactly_once(cidt, seq, inner, wctx)
            return _CompletedSlot(reply, "server")
        hello = _codec.handle_hello(conn, msg)
        if hello is not None:
            return _CompletedSlot(hello, None, byte_kind="control")
        try:
            reply = ("ok", self._handle(msg))
        except Exception as exc:  # noqa: BLE001 — to the client
            reply = ("err", f"{type(exc).__name__}: {exc}")
        if msg and msg[0] == "ping":
            return _CompletedSlot(reply, None, byte_kind="control")
        return _CompletedSlot(reply, None)

    def _reply_writer(self, conn, slots):
        """Send completed replies in arrival order (the client's window
        machinery pops acks FIFO — order is part of the wire contract)."""
        try:
            while True:
                slot = slots.get()
                if slot is None:
                    return
                slot.done.wait()
                _tr.span_end(getattr(slot, "span", None))
                try:
                    _send_msg(conn, slot.reply,
                              fi_role=getattr(slot, "role", None),
                              byte_kind=getattr(slot, "byte_kind",
                                                "sent"))
                except (ConnectionError, OSError):
                    # client gone mid-reply: predict is pure, so the
                    # reconnect replay simply re-runs it — drain the
                    # remaining slots without sending
                    return
                if getattr(slot, "role", None) == "server":
                    # the serving tier honors the same deterministic
                    # kill dial as the base serve loop: SIGKILL after
                    # exactly N enveloped replies (the chaos gate's
                    # mid-storm replica death)
                    _fi.server_replied()
        except Exception:  # noqa: BLE001 — conn died; client reconnects
            pass

    def stop(self):
        super().stop()
        _health.unregister_probe(self._health_probe_name)
        self._batcher.stop()
        if self._ps is not None:
            try:
                self._ps.close()
            except MXNetError:
                pass


def _host_zeros(shape, dtype):
    """A zero host NDArray of ``dtype`` (a name, ``bfloat16`` included)
    that the refresh client pulls into."""
    from ..ndarray import NDArray
    from ..ndarray.ndarray import torch_dtype
    return NDArray(torch.zeros(tuple(shape), dtype=torch_dtype(dtype)))


class _CompletedSlot:
    """Adapter giving an already-computed reply the _ReplySlot shape the
    writer consumes."""

    __slots__ = ("done", "reply", "role", "byte_kind")
    _DONE = threading.Event()
    _DONE.set()

    def __init__(self, reply, role, byte_kind="sent"):
        self.done = self._DONE
        self.reply = reply
        self.role = role
        self.byte_kind = byte_kind
