"""Gluon Trainer (reference: python/mxnet/gluon/trainer.py:27).

PyTorch counterpart of ``mxnet_tpu/gluon/trainer.py``: ``step(batch_size)``
sets the optimizer's ``rescale_grad`` to ``scale / batch_size`` and runs
the port's updater on each parameter with a gradient, one parameter at a
time (the updater rebinds each weight NDArray to its new tensor, under
``torch.no_grad``); a row-sparse gradient takes the optimizer's lazy
route.  The kvstore argument takes ``None``, a store type by name or a
:class:`~mxnet_tpu_torch.kvstore.KVStore`; the store is created at the
first ``step``, ``save_states`` or ``load_states`` (JAX package
``trainer.py:95-140``).  One device needs no reduction, so
``allreduce_grads`` does nothing and the update stays here, as in the
JAX package, on every store but ``dist_async``: there the optimizer runs
on the parameter servers (update-on-kvstore), shipped once from the
first ``step`` after ``rescale_grad`` is set, and a step pushes every
gradient in one list push (small keys coalesce) and pulls the weights
back; ``compression_params`` compress those pushes, ``step_k`` runs
chunk by chunk with the wire behind the next chunk's compute, and
``save_states`` / ``load_states`` relay the servers' states.
``mesh=`` and ``zero_stage=1`` are not ported (ROADMAP D1) and raise.
The states files are in the format both packages' ``Module`` and
``Trainer`` load.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from .. import profiler as _prof
from .parameter import ParameterDict, Parameter


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore='device', compression_params=None, mesh=None,
                 zero_stage=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError(
                "First argument must be a list or dict of Parameters, "
                f"got {type(params)}")
        if not (kvstore is None
                or isinstance(kvstore, (str, kvs_mod.KVStore))):
            raise TypeError("kvstore must be KVStore, str or None")
        if mesh is not None or zero_stage:
            raise MXNetError("Trainer(mesh=, zero_stage=): mesh training "
                             "is not ported to mxnet_tpu_torch yet "
                             "(ROADMAP D1)")
        # validated now, so a typo'd config fails at construction; given
        # to the store at its lazy init
        self._compression_params = None
        if compression_params:
            from ..compression import GradientCompression
            GradientCompression(compression_params)
            self._compression_params = dict(compression_params)
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError(f"not a Parameter: {param!r}")
            param._trainer = self
            self._params.append(param)
        self._scale = 1.0
        self._kv_type = kvstore
        self._kvstore = None
        self._kv_initialized = False
        self._update_on_kvstore = False
        self._init_optimizer(optimizer, dict(optimizer_params or {}))

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = {i: param for i, param in enumerate(self._params)}
        if isinstance(optimizer, opt_mod.Optimizer):
            assert not optimizer_params, \
                "optimizer_params must be None if optimizer is an " \
                "Optimizer instance"
            self._optimizer = optimizer
        else:
            self._optimizer = opt_mod.create(optimizer, **optimizer_params)
        self._optimizer.param_dict = param_dict
        self._updaters = [opt_mod.get_updater(self._optimizer)]

    def _init_kvstore(self):
        """The store, made at first use (reference: trainer.py:102).  On
        ``dist_async`` every materialized parameter is registered with
        the servers (first init wins) and pulled back, so every worker
        starts from the same weights; the optimizer is NOT shipped here
        (that would freeze the default rescale_grad into the servers:
        :meth:`_ensure_kv_optimizer` ships it from the first step)."""
        if isinstance(self._kv_type, str):
            self._kvstore = kvs_mod.create(self._kv_type)
        else:
            self._kvstore = self._kv_type
        if self._kvstore is not None and self._compression_params:
            self._kvstore.set_gradient_compression(
                self._compression_params)
        self._update_on_kvstore = (
            self._kvstore is not None
            and getattr(self._kvstore, "type", "") == "dist_async")
        if self._update_on_kvstore:
            self._kv_opt_sent = False
            self._kv_deferred_states = None
            self._kv_replay_states = None
            self._kv_param_inited = set()
            inited = [p for p in self._params if p._data is not None]
            for param in inited:
                self._kvstore.init(param.name, param.data())
                self._kv_param_inited.add(param.name)
            if inited:
                self._kvstore.pull([p.name for p in inited],
                                   out=[p.data() for p in inited])
        self._kv_initialized = True

    def _ensure_kv_optimizer(self):
        """Ship the optimizer to the servers once, from the first step
        (after rescale_grad is set), then replay any buffered
        load_states blob (JAX package trainer.py:142-161)."""
        if self._kv_opt_sent:
            return
        self._kvstore.set_optimizer(self._optimizer)
        self._kv_opt_snapshot = (self._optimizer.lr,
                                 self._optimizer.rescale_grad)
        self._kv_opt_sent = True
        blob = self._kv_deferred_states or self._kv_replay_states
        self._kv_deferred_states = self._kv_replay_states = None
        if blob is not None:
            self._kvstore.load_optimizer_states_blob(blob)

    def _live_params(self, ignore_stale_grad):
        """The parameters a dist_async step pushes, each registered with
        the servers before its first push (a deferred-init parameter
        materializes after the store's init)."""
        live = []
        for param in self._params:
            if param.grad_req == 'null':
                continue
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"Parameter {param.name!r} was not initialized")
                continue
            if param.name not in self._kv_param_inited:
                self._kvstore.init(param.name, param.data())
                self._kv_param_inited.add(param.name)
            live.append(param)
        return live

    def _step_on_kvstore(self, ignore_stale_grad):
        """One list push of every gradient, then one batched pull of the
        servers' weights (reference: trainer.py:148, update-on-kvstore);
        per-server FIFO makes each pull observe this worker's pushes."""
        snap = (self._optimizer.lr, self._optimizer.rescale_grad)
        if snap != self._kv_opt_snapshot \
                and not getattr(self, "_kv_opt_drift_warned", False):
            self._kv_opt_drift_warned = True
            import warnings
            warnings.warn(
                "optimizer hyperparameters changed after the first "
                "dist_async step (lr/rescale_grad %s -> %s) — the SERVER "
                "keeps applying its pickle-time snapshot (re-sending the "
                "optimizer would reset server-side momentum state); "
                "restart training to change hyperparameters, as with the "
                "reference's server-side optimizer" %
                (self._kv_opt_snapshot, snap), stacklevel=3)
        live = self._live_params(ignore_stale_grad)
        if live:
            self._kvstore.push([p.name for p in live],
                               [p.grad() for p in live])
            self._kvstore.pull([p.name for p in live],
                               out=[p.data() for p in live])

    @property
    def learning_rate(self):
        return self._optimizer.lr

    def set_learning_rate(self, lr):
        self._optimizer.lr = lr

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimizer update of every parameter with a gradient, the
        gradient scaled by ``1 / batch_size`` (reference: trainer.py:148)."""
        # rescale BEFORE the lazy store init: dist_async ships the
        # optimizer to the servers from the first step
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        _prof.record_dispatch("trainer.step")
        if self._update_on_kvstore:
            self._ensure_kv_optimizer()
            return self._step_on_kvstore(ignore_stale_grad)
        updater = self._updaters[0]
        for i, param in enumerate(self._params):
            if param.grad_req == 'null':
                continue
            if param._data is None:
                if not ignore_stale_grad:
                    raise MXNetError(
                        f"Parameter {param.name!r} was not initialized")
                continue
            updater(i, param.grad(), param.data())

    def allreduce_grads(self):
        """Nothing to reduce on one device (reference: trainer.py
        allreduce_grads)."""

    def update(self, batch_size, ignore_stale_grad=False):
        self.step(batch_size, ignore_stale_grad)

    def step_k(self, loss_fn, data, label=None, k=None, batch_size=None,
               eval_metric=None):
        """K training steps, each ``record`` -> ``loss_fn(data_j[,
        label_j])`` -> ``backward`` -> :meth:`step`, over inputs stacked on
        a leading step axis; the K losses stacked (reference: the JAX
        package's ``Trainer.step_k``, whose one-program scan is not
        ported: this is its plain loop).  On ``dist_async`` the steps go
        chunk by chunk (:func:`executor.drive_chunked_dist`): each step
        updates a local replica with this trainer's updater, each
        chunk's per-step gradients are pushed and the next pull enqueued
        while the next chunk computes, a chunk adopts the servers'
        weights ``MXNET_KVSTORE_FUSED_STALENESS`` chunk boundaries
        later, and the last pull is adopted at the end
        (``MXNET_KVSTORE_FUSED=0``: a :meth:`step` a batch)."""
        import torch
        from .. import autograd
        from ..ndarray import NDArray

        def _parts(x):
            if x is None:
                return None
            return tuple(x) if isinstance(x, (list, tuple)) else (x,)
        data_t, label_t = _parts(data), _parts(label)
        ks = {int(a.shape[0]) for a in data_t + (label_t or ())}
        if len(ks) != 1:
            raise MXNetError(f"step_k: inconsistent leading (step) dims "
                             f"{sorted(ks)}")
        inferred = ks.pop()
        if inferred == 0:
            raise MXNetError("step_k: inputs stack ZERO steps (empty "
                             "leading axis)")
        k = inferred if k is None else k
        if k != inferred:
            raise MXNetError(f"step_k: k={k} but inputs stack {inferred} "
                             "steps (leading dim)")
        if batch_size is None:
            batch_size = int(data_t[0].shape[1]) \
                if len(data_t[0].shape) > 1 else 1

        def _at(parts, j):
            nds = tuple(p[j] for p in parts)
            return nds[0] if len(nds) == 1 else nds
        losses = []

        def one_step(j, update):
            args = [_at(data_t, j)]
            if label_t is not None:
                args.append(_at(label_t, j))
            with autograd.record():
                loss = loss_fn(*args)
            loss.backward()
            update()
            if eval_metric is not None:
                labs = [p[j] for p in label_t] if label_t is not None \
                    else []
                # on the device where the metric has a device form
                eval_metric.accumulate(labs, [loss])
            losses.append(loss._data.detach())

        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._kv_initialized:
            self._init_kvstore()
        from ..base import env
        if not (self._update_on_kvstore and k > 1
                and env("MXNET_KVSTORE_FUSED", True)):
            for j in range(k):
                one_step(j, lambda: self.step(batch_size))
            return NDArray(torch.stack(losses))
        self._ensure_kv_optimizer()
        self._step_k_dist(one_step, k)
        return NDArray(torch.stack(losses))

    def _step_k_dist(self, one_step, k):
        """The chunked dist_async driver of :meth:`step_k` (JAX package
        ``trainer.py:743-836`` over a plain step loop)."""
        from ..executor import drive_chunked_dist, fused_dist_knobs
        from ..kvstore import _from_host
        kv = self._kvstore
        live = self._live_params(False)
        names = [p.name for p in live]
        shapes = [tuple(p.data().shape) for p in live]
        updater = self._updaters[0]
        index = {id(p): i for i, p in enumerate(self._params)}
        chunk, staleness = fused_dist_knobs(k)

        def replica_update():
            for p in live:
                updater(index[id(p)], p.grad(), p.data())

        def adopt(vals):
            for p in live:
                w = p.data()
                w._set_data(_from_host(vals[p.name], w._data.device,
                                       w._data.dtype))

        def dispatch_chunk(j, lo, hi, adopted):
            if adopted is not None:
                adopt(adopted)
            _prof.record_dispatch("step_k.dist_chunk")
            grads = []
            for s in range(lo, hi):
                one_step(s, replica_update)
                grads.append([p.grad()._data.detach().clone()
                              for p in live])
            return grads

        def ship_chunk(j, grads):
            return kv.ship_chunk_steps(names, grads, shapes)

        adopt(drive_chunked_dist(k, chunk, staleness, dispatch_chunk,
                                 ship_chunk))

    def save_states(self, fname):
        """The updater's states, in the format both packages load; on
        ``dist_async`` the servers' (JAX package trainer.py:845-873): a
        worker that never stepped relays a buffered blob, or asks the
        servers, or writes empty states on a fresh cluster, and never
        ships the optimizer."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            if not self._kv_opt_sent:
                if self._kv_deferred_states is not None:
                    with open(fname, 'wb') as fout:
                        fout.write(self._kv_deferred_states)
                    return
                try:
                    self._kvstore.save_optimizer_states(fname)
                except MXNetError:
                    with open(fname, 'wb') as fout:
                        fout.write(self._updaters[0].get_states())
                return
            self._kvstore.save_optimizer_states(fname)
            return
        with open(fname, 'wb') as fout:
            fout.write(self._updaters[0].get_states())

    def load_states(self, fname):
        """Set the updater's states from a file of either package; on
        ``dist_async`` the servers' (JAX package trainer.py:875-900):
        before this worker's first step, applied now when the servers
        hold an optimizer (and replayed after the ship), else buffered
        until the first step ships it."""
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            if not self._kv_opt_sent:
                try:
                    self._kvstore.load_optimizer_states(fname)
                    with open(fname, 'rb') as fin:
                        self._kv_replay_states = fin.read()
                except MXNetError:
                    with open(fname, 'rb') as fin:
                        self._kv_deferred_states = fin.read()
                return
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, 'rb') as fin:
            self._updaters[0].set_states(fin.read())
