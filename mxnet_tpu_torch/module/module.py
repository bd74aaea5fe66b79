"""Module: symbol + executor + optimizer on one device.

PyTorch counterpart of ``mxnet_tpu/module/module.py`` (reference:
python/mxnet/module/module.py).  ``bind`` allocates one Executor on the
module's context (``gpu(0)`` unless given): fp32 master parameters, and
gradients only for parameters (data, labels and fixed parameters get
none).  ``compute_dtype`` (e.g. ``"bfloat16"``) runs the graph in that
type under the executor's cast policy while the masters stay fp32.

``forward(is_train=True)`` records autograd's graph, ``backward`` turns
it into gradients and ``update`` applies the optimizer to every
parameter.  ``update`` after a training ``forward`` without ``backward``
computes the gradients itself, once, as the JAX package's fused step
does; ``forward(is_train=False)`` records no graph.  ``run_steps`` is
the plain loop of K steps.  Checkpoints (``save_checkpoint``, ``load``,
optimizer states) use the JAX package's files, so either package resumes
from the other's.  ``state_names`` are inputs carried from one forward to
the next (a KV cache, an RNN's hidden state): they get no gradient and no
optimizer update, and ``get_states`` / ``set_states`` read and set them.
``bind(shared_module=...)`` makes this module hold the other's
parameter NDArrays, and ``borrow_optimizer`` its optimizer (the
``BucketingModule``'s buckets).  ``fixed_param_names`` are parameters
that get no gradient tensor and no update (``grad_req`` null): they are
no leaves of autograd's graph, so the backward stops where the trainable
graph starts; BatchNorm's moving statistics still follow a training
forward, as in the JAX package.  ``reshape`` rebinds to new input shapes
(a batch-size switch for evaluation) and keeps the parameter NDArrays,
auxiliary states, ``grad_req`` and optimizer states; ``forward`` does it
by itself when a batch's data and label shapes differ from the bound
ones.  ``install_monitor`` hands a ``Monitor`` every node's outputs of
each forward (``Executor.set_monitor_callback``).  The JAX package's
fused jit step and its scan over K steps (plain PyTorch runs eagerly),
and meshes and ZeRO (ROADMAP D1), are not ported.
"""
from __future__ import annotations

import json
import logging
import pickle

import numpy as np
import torch

from ..base import MXNetError
from ..context import current_context
from ..executor import Executor, _as_tensor
from ..initializer import InitDesc, Uniform
from .. import initializer as init_mod
from ..kvstore import _from_host as kvs_from_host
from ..model import _create_kvstore, _initialize_kvstore, \
    _update_params, _update_params_on_kvstore, load_checkpoint
from ..ndarray import NDArray
from .. import optimizer as opt_mod
from .. import profiler as _prof
from .base_module import BaseModule, _check_input_names, _parse_data_desc


class Module(BaseModule):
    """reference: module.py Module."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, mesh=None, sharding_rules=None,
                 compute_dtype=None, zero_stage=None):
        super().__init__(logger=logger)
        if mesh is not None or sharding_rules is not None or zero_stage:
            raise MXNetError("mesh / sharding_rules / zero_stage: device "
                             "meshes and ZeRO are not ported yet "
                             "(ROADMAP D1)")
        if context is None:
            context = current_context()
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError("Module over several devices is not "
                                 "ported yet (ROADMAP D1)")
            context = context[0]
        self._context = context
        self._compute_dtype = compute_dtype
        self._symbol = symbol
        data_names = list(data_names) if data_names is not None else []
        label_names = list(label_names) if label_names is not None else []
        state_names = list(state_names) if state_names is not None else []
        fixed_param_names = list(fixed_param_names) \
            if fixed_param_names is not None else []
        _check_input_names(symbol, data_names, "data", True)
        _check_input_names(symbol, label_names, "label", False)
        _check_input_names(symbol, state_names, "state", True)
        _check_input_names(symbol, fixed_param_names, "fixed_param", True)
        input_names = data_names + label_names + state_names
        self._param_names = [x for x in symbol.list_arguments()
                             if x not in input_names]
        self._fixed_param_names = fixed_param_names
        self._aux_names = symbol.list_auxiliary_states()
        self._data_names = data_names
        self._label_names = label_names
        self._state_names = state_names
        self._output_names = symbol.list_outputs()
        self._arg_params = None
        self._aux_params = None
        self._optimizer = None
        self._updater = None
        self._preload_opt_states = None
        self._kvstore = None
        self._update_on_kvstore = False
        self._grad_req = None
        self._exec = None
        self._data_shapes = self._label_shapes = None
        # gradients of the last forward are in grad_dict
        self._grads_fresh = False

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over the checkpoint ``prefix``/``epoch`` (symbol and
        parameters; ``kwargs`` go to the constructor).  Its parameters are
        set at ``bind``; with ``load_optimizer_states`` the optimizer
        states of ``prefix-%04d.states`` are set at ``init_optimizer``
        (reference: module.py load)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params = args
        mod._aux_params = auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Write ``prefix-symbol.json``, ``prefix-%04d.params`` and, with
        ``save_optimizer_states``, ``prefix-%04d.states`` (reference:
        module.py save_checkpoint)."""
        self._symbol.save("%s-symbol.json" % prefix)
        param_name = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_name)
        logging.info('Saved checkpoint to "%s"', param_name)
        if save_optimizer_states:
            state_name = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_name)
            logging.info('Saved optimizer state to "%s"', state_name)

    # -- properties ------------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return [(n, o.shape) for n, o in
                zip(self._output_names, self._exec.outputs)]

    # -- params ----------------------------------------------------------------
    def get_params(self):
        """(arg_params, aux_params): the bound NDArrays by name (they
        follow later updates)."""
        assert self.binded and self.params_initialized
        return ({n: self._exec.arg_dict[n] for n in self._param_names},
                dict(self._exec.aux_dict))

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Fill the parameters from ``arg_params``/``aux_params`` (numpy
        arrays, tensors or NDArrays, e.g. the output of
        ``params_from_numpy``; copied in the master dtype) and
        ``initializer`` for the rest (reference: module.py
        init_params)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        attrs = self._symbol.attr_dict()

        def _impl(name, arr, cache):
            if cache is not None and name in cache:
                arr._set_data(_as_tensor(cache[name], arr._data.device,
                                         arr._data.dtype))
                return
            if not allow_missing and cache is not None:
                raise RuntimeError(f"{name} is not presented")
            if initializer is not None:
                init = initializer
                if name in attrs and "__init__" in attrs[name]:
                    klass, kw = json.loads(attrs[name]["__init__"])
                    init = init_mod.create(klass, **kw)
                init(InitDesc(name, global_init=initializer), arr)

        cache_arg = arg_params if arg_params is not None else \
            (self._arg_params or None)
        cache_aux = aux_params if aux_params is not None else \
            (self._aux_params or None)
        if not allow_extra:
            known = set(self._symbol.list_arguments()) | set(self._aux_names)
            for cache in (cache_arg, cache_aux):
                unknown = [n for n in (cache or {}) if n not in known]
                if unknown:
                    raise ValueError("extra parameters not in the symbol "
                                     "(pass allow_extra=True to ignore): "
                                     f"{sorted(unknown)!r}")
        for name in self._param_names:
            _impl(name, self._exec.arg_dict[name], cache_arg)
        for name in self._aux_names:
            _impl(name, self._exec.aux_dict[name], cache_aux)
        self.params_initialized = True

    # -- bind ------------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Allocate the executor from the input descriptions (reference:
        module.py bind).  Inputs keep the dtype their ``DataDesc``
        gives (int32 token ids stay int32); parameters are float32."""
        if force_rebind:
            self.binded = False
            self._exec = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        descs = list(self._data_shapes) + list(self._label_shapes or [])
        shapes = {d.name: d.shape for d in descs}
        type_dict = {d.name: getattr(d, "dtype", np.float32) for d in descs}
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = "write" if inputs_need_grad else "null"
            elif name in self._label_names or name in self._state_names \
                    or name in self._fixed_param_names:
                req[name] = "null"
            else:
                req[name] = grad_req if for_training else "null"
        self._grad_req = req
        self._exec = Executor.simple_bind(
            self._symbol, self._context, grad_req=req, type_dict=type_dict,
            shapes=shapes, compute_dtype=self._compute_dtype)
        self.binded = True
        if self.params_initialized and self._arg_params:
            self._exec.copy_params_from(self._arg_params, self._aux_params,
                                        allow_extra_params=True)
        if shared_module is not None:
            self._share_arrays(shared_module)

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, keeping the parameter NDArrays
        (the same objects), auxiliary states, ``grad_req`` and optimizer
        states (reference: module.py reshape).  A module bound with
        labels must be given labels of the new shape."""
        assert self.binded and self.params_initialized
        new_data, new_labels = _parse_data_desc(
            self._data_names, self._label_names, data_shapes, label_shapes)
        if self._label_shapes and not new_labels:
            raise MXNetError("reshape: this module was bound with "
                             "label_shapes; pass label_shapes of the new "
                             "batch too")
        self._exec = self._exec.reshape(
            **{d.name: d.shape for d in new_data + list(new_labels or [])})
        self._data_shapes, self._label_shapes = new_data, new_labels
        self._grads_fresh = False

    def install_monitor(self, mon):
        """Hand ``mon`` every node's outputs of each forward (reference:
        module.py install_monitor)."""
        assert self.binded
        mon.install(self._exec)

    def _share_arrays(self, shared_module):
        """Hold ``shared_module``'s parameter and auxiliary NDArrays
        themselves (those of the same name and shape), so an update
        through either module is seen by both; this module's gradients
        stay its own (reference: module.py bind(shared_module), whose
        executors share one memory pool)."""
        assert shared_module.binded
        ex, other = self._exec, shared_module._exec
        params = set(self._param_names) | set(self._aux_names)
        for names, arrays, theirs in (
                (ex._arg_names, ex.arg_arrays, other.arg_dict),
                (ex._aux_names, ex.aux_arrays, other.aux_dict)):
            for i, n in enumerate(names):
                src = theirs.get(n)
                if n in params and src is not None \
                        and src.shape == arrays[i].shape:
                    arrays[i] = src
        self.params_initialized = shared_module.params_initialized

    def borrow_optimizer(self, shared_module):
        """Apply updates through ``shared_module``'s optimizer, updater
        and states (reference: module.py borrow_optimizer; every bucket
        of a BucketingModule updates through one optimizer)."""
        assert shared_module.optimizer_initialized
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True

    # -- optimizer -------------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """reference: module.py init_optimizer.  A named optimizer gets
        ``rescale_grad = 1 / batch_size`` unless given: the loss head's
        gradient is a sum over the batch.  A KVStore object holds the
        parameters and runs the optimizer on each push
        (update-on-kvstore, JAX package ``module.py:374-417``); a store
        type by name means none, on one device."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        arg_params = {n: self._exec.arg_dict[n] for n in self._param_names}
        kv, self._update_on_kvstore = _create_kvstore(kvstore, 1,
                                                      arg_params)
        self._kvstore = kv
        batch_size = self._data_shapes[0].shape[0]
        if kv and "dist" in kv.type:
            # the gradient the update sees sums every worker's batch
            batch_size *= kv.num_workers
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            if "rescale_grad" not in optimizer_params:
                optimizer_params["rescale_grad"] = 1.0 / batch_size
            optimizer = opt_mod.create(
                optimizer, sym=self._symbol,
                param_idx2name={n: n for n in self._param_names},
                **optimizer_params)
        elif not isinstance(optimizer, opt_mod.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        self._optimizer = optimizer
        if kv:
            _initialize_kvstore(kv, [[arg_params[n]]
                                     for n in self._param_names],
                                arg_params, self._param_names,
                                self._update_on_kvstore)
        if self._update_on_kvstore:
            kv.set_optimizer(optimizer)
            # None for dist_async: the optimizer runs on the servers
            self._updater = kv._updater
        else:
            self._updater = opt_mod.get_updater(optimizer)
        # every state now, so that a checkpoint before the first update
        # holds them all (multi-precision prepends an fp32 master copy);
        # a store keys its updater by _key_int(name)
        key = kv._key_int if self._update_on_kvstore else str
        if self._updater is not None:
            self._updater.states = {
                key(n): optimizer.create_state_multi_precision(
                    n, self._exec.arg_dict[n])
                for n in self._update_names()}
        self._dist_replica = None
        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def save_optimizer_states(self, fname):
        """Pickle ``{name: tuple of numpy arrays}`` of the optimizer
        states, as the JAX package writes them (bf16 states, which numpy
        lacks, are written as float32); a module that updates in its
        store writes the store's updater blob, as the JAX package does
        (``module.py:1270-1289``)."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        states = {n: tuple(None if s is None else s.asnumpy() for s in st)
                  for n, st in self._updater.states.items()}
        _prof.record_host_sync("module.save_optimizer_states")
        with open(fname, "wb") as fout:
            pickle.dump(states, fout)

    def load_optimizer_states(self, fname):
        """Set the optimizer states from a file of
        :meth:`save_optimizer_states` of either package, each in its
        state's dtype and on its device (through the store when the
        module updates there).  The file is unpickled: load only files
        this program or the JAX package wrote."""
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
        with open(fname, "rb") as fin:
            states = pickle.load(fin)
        for n, st in states.items():
            for s, v in zip(self._updater.states.get(n, ()), st):
                if s is None or v is None:
                    continue
                v = np.asarray(v)
                t = (torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                     if v.dtype.name == "bfloat16" else torch.from_numpy(v))
                s._set_data(t.to(device=s._data.device, dtype=s._data.dtype))

    def _update_names(self):
        return [n for n in self._param_names
                if self._grad_req.get(n, "null") != "null"]

    def run_steps(self, data, label=None, k=None, eval_metric=None):
        """K training steps over K stacked batches (see
        :meth:`BaseModule.run_steps`).  Over a ``dist_async`` store that
        runs the optimizer on its servers, the steps go chunk by chunk
        (:func:`executor.drive_chunked_dist`, JAX package
        ``module.py:964-1171``): each step updates a local replica of
        the weights with the same optimizer, each chunk's per-step
        gradients are pushed in step order and the next pull is enqueued
        while the next chunk computes, and a chunk adopts the servers'
        weights ``MXNET_KVSTORE_FUSED_STALENESS`` chunk boundaries later;
        the last pull is adopted at the end.  The optimizer states of the
        replica stay on this worker.  ``MXNET_KVSTORE_FUSED=0`` or K=1
        keeps the per-step loop."""
        from ..base import env
        kv = self._kvstore
        if not (self._update_on_kvstore and kv is not None
                and kv.type == "dist_async"
                and env("MXNET_KVSTORE_FUSED", True)):
            return super().run_steps(data, label, k, eval_metric)
        from .base_module import _canon_step_inputs
        data_arrays, k = _canon_step_inputs(self._data_names, data, "data",
                                            k)
        label_arrays, k = _canon_step_inputs(self._label_names, label,
                                             "label", k)
        if k <= 1:
            return super().run_steps(data, label, k, eval_metric)
        return self._run_steps_dist(data_arrays, label_arrays, k,
                                    eval_metric)

    def _run_steps_dist(self, data_arrays, label_arrays, k, eval_metric):
        from .. import io as io_mod
        from ..executor import drive_chunked_dist, fused_dist_knobs
        ex, kv = self._exec, self._kvstore
        names = self._update_names()
        if self._dist_replica is None:
            self._dist_replica = opt_mod.get_updater(self._optimizer)
        replica = self._dist_replica
        shapes = [tuple(ex.arg_dict[n].shape) for n in names]
        chunk, staleness = fused_dist_knobs(k)
        outs_steps = []

        def dispatch_chunk(j, lo, hi, adopted):
            if adopted is not None:
                for n in names:
                    w = ex.arg_dict[n]
                    w._set_data(kvs_from_host(adopted[n], w._data.device,
                                              w._data.dtype))
            _prof.record_dispatch("run_steps.dist_chunk")
            grads = []
            for s in range(lo, hi):
                batch = io_mod.DataBatch(
                    data=[NDArray(a[s]) for a in data_arrays],
                    label=[NDArray(a[s]) for a in label_arrays]
                    if label_arrays else None)
                self.forward(batch, is_train=True)
                self.backward()
                grads.append([ex.grad_dict[n]._data.detach().clone()
                              for n in names])
                for n in names:
                    replica(n, ex.grad_dict[n], ex.arg_dict[n])
                self._grads_fresh = False
                if eval_metric is not None:
                    self.update_metric(eval_metric, batch.label)
                outs_steps.append([o._data for o in self.get_outputs()])
            return grads

        def ship_chunk(j, grads):
            return kv.ship_chunk_steps(names, grads, shapes)

        final = drive_chunked_dist(k, chunk, staleness, dispatch_chunk,
                                   ship_chunk)
        for n in names:
            w = ex.arg_dict[n]
            w._set_data(kvs_from_host(final[n], w._data.device,
                                      w._data.dtype))
        return [NDArray(torch.stack([st[i] for st in outs_steps]))
                for i in range(len(outs_steps[0]))]

    # -- compute ---------------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Run the graph on ``data_batch`` (its NDArrays are copied to the
        module's device).  A batch whose data or label shapes differ from
        the bound ones rebinds the executor to them first
        (:meth:`Executor.reshape`: parameters and states carry over)."""
        assert self.binded and self.params_initialized
        if is_train is None:
            is_train = self.for_training
        kwargs = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None and self._label_names:
            kwargs.update(zip(self._label_names, data_batch.label))
        arg_dict = self._exec.arg_dict
        new = {n: tuple(v.shape) for n, v in kwargs.items()}
        if any(tuple(arg_dict[n].shape) != s for n, s in new.items()):
            self._exec = self._exec.reshape(**new)
        with _prof.scope("module.forward", "symbolic"):
            self._exec.forward(is_train=is_train, **kwargs)
        self._grads_fresh = False

    def backward(self, out_grads=None):
        """Gradients of the last forward into ``grad_dict``."""
        assert self.binded and self.params_initialized
        _prof.record_dispatch("module.backward")
        with _prof.scope("module.backward", "symbolic"):
            self._exec.backward(out_grads=out_grads)
        self._grads_fresh = True

    def update(self):
        """Apply the optimizer to every parameter with a gradient.  After a
        training forward without ``backward``, the gradients are computed
        here first (once)."""
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        if not self._grads_fresh:
            self.backward()
        names = self._update_names()
        _prof.record_dispatch("module.update")
        with _prof.scope("module.update", "symbolic"):
            self._update(names)
        self._grads_fresh = False

    def _update(self, names):
        ex = self._exec
        if self._update_on_kvstore:
            # the store updates its copies, the module pulls them back
            # (JAX package module.py:509-531)
            _update_params_on_kvstore([[ex.arg_dict[n]] for n in names],
                                      [[ex.grad_dict[n]] for n in names],
                                      self._kvstore, names)
        else:
            _update_params([ex.arg_dict[n] for n in names],
                           [ex.grad_dict[n] for n in names],
                           updater=self._updater, num_device=1,
                           kvstore=self._kvstore, param_names=names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return [self._exec.grad_dict[n] for n in self._data_names]

    def get_states(self, merge_multi_context=True):
        """The state inputs' current values, one NDArray each (reference:
        module.py get_states).  They are snapshots: no later ``forward``,
        ``set_states`` or update changes them, because the module only
        ever rebinds its state arrays to new tensors and never writes
        into one in place."""
        assert self.binded and self.params_initialized
        return [NDArray(self._exec.arg_dict[n]._data)
                for n in self._state_names]

    def set_states(self, states=None, value=None):
        """Set the state inputs from ``states`` (NDArrays, one per state
        name, in the module's order, taken as they are, dtype included) or
        fill each with the scalar ``value`` in its own dtype (reference:
        module.py set_states)."""
        assert self.binded and self.params_initialized
        if (states is None) == (value is None):
            raise MXNetError("set_states: give exactly one of states and "
                             "value")
        if value is not None:
            for n in self._state_names:
                arr = self._exec.arg_dict[n]
                arr._set_data(torch.full_like(arr._data, value))
            return
        if len(states) != len(self._state_names):
            raise MXNetError(f"set_states: {len(states)} states for "
                             f"{self._state_names}")
        for n, s in zip(self._state_names, states):
            src = s[0] if isinstance(s, (list, tuple)) else s
            arr = self._exec.arg_dict[n]
            arr._set_data(src._data.to(arr._data.device))

    def update_metric(self, eval_metric, labels):
        eval_metric.update_dict(
            dict(zip(self._label_names, labels or [])),
            dict(zip(self._output_names, self.get_outputs())))
