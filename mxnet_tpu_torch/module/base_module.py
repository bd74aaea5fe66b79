"""BaseModule: the high-level train / score interface.

PyTorch counterpart of ``mxnet_tpu/module/base_module.py`` (reference:
python/mxnet/module/base_module.py): ``fit``, ``score``, ``predict``,
``iter_predict``, ``forward_backward``, ``run_steps`` (the plain loop of
K steps), ``set_params``, parameter files and the input-description
helpers.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from .. import io as io_mod
from .. import metric as metric_mod
from .. import profiler as _prof
from ..base import MXNetError
from ..initializer import Uniform
from ..model import BatchEndParam
from ..ndarray import NDArray
from ..serialization import load_ndarrays, save_ndarrays


def _check_input_names(symbol, names, typename, throw):
    """reference: base_module.py _check_input_names."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        candidates = [arg for arg in args if not arg.endswith(
            ("_weight", "_bias", "_gamma", "_beta"))]
        msg = (f"You created Module with Module(..., {typename}_names="
               f"{names}) but input with name '{name}' is not found in "
               "symbol.list_arguments(). Did you mean one of:\n\t"
               + "\n\t".join(candidates))
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _check_names_match(data_names, data_shapes, name, throw):
    actual = [x[0] for x in data_shapes]
    if sorted(data_names) != sorted(actual):
        msg = (f"Data provided by {name}_shapes don't match names specified "
               f"by {name}_names ({data_shapes} vs. {data_names})")
        if throw:
            raise ValueError(msg)
        logging.warning(msg)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """reference: base_module.py _parse_data_desc."""
    data_shapes = [x if isinstance(x, io_mod.DataDesc)
                   else io_mod.DataDesc(*x) for x in data_shapes]
    _check_names_match(data_names, data_shapes, "data", True)
    if label_shapes is not None:
        label_shapes = [x if isinstance(x, io_mod.DataDesc)
                        else io_mod.DataDesc(*x) for x in label_shapes]
        _check_names_match(label_names, label_shapes, "label", False)
    else:
        _check_names_match(label_names, [], "label", False)
    return data_shapes, label_shapes


def _canon_step_inputs(names, value, what, k=None):
    """``run_steps`` inputs as a list of tensors aligned with ``names``,
    each ``(k,) + per_step_shape``, and k.  Takes a dict name -> array, a
    list aligned with ``names``, one array (one input) or, for one input,
    a list of K per-step batches (stacked here); arrays are NDArrays,
    tensors or array-likes (reference: base_module.py
    _canon_step_inputs)."""
    def _as_val(v):
        if isinstance(v, NDArray):
            return v._data
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))

    if value is None:
        if names:
            raise MXNetError(f"run_steps: {what} is required "
                             f"(names: {names})")
        return [], k
    if isinstance(value, dict):
        missing = [n for n in names if n not in value]
        if missing:
            raise MXNetError(f"run_steps: missing {what}: {missing}")
        arrays = [_as_val(value[n]) for n in names]
    elif isinstance(value, (list, tuple)):
        if len(value) == len(names):
            arrays = [_as_val(v) for v in value]
        elif len(names) == 1:
            arrays = [torch.stack([_as_val(v) for v in value])]
        else:
            raise MXNetError(f"run_steps: expected {len(names)} {what} "
                             f"arrays, got {len(value)}")
    else:
        if len(names) != 1:
            raise MXNetError(f"run_steps: {what} must be a dict/list "
                             f"covering {names}")
        arrays = [_as_val(value)]
    ks = {int(a.shape[0]) for a in arrays if a.dim()}
    if len(ks) != 1:
        raise MXNetError(f"run_steps: inconsistent leading (step) dims "
                         f"for {what}: {sorted(ks)}")
    inferred = ks.pop()
    if inferred == 0:
        raise MXNetError(f"run_steps: {what} stacks zero steps")
    if k is not None and k != inferred:
        raise MXNetError(f"run_steps: k={k} but {what} arrays stack "
                         f"{inferred} steps (leading dim)")
    return arrays, inferred


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    """reference: base_module.py BaseModule."""

    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high level ------------------------------------------------------------
    def run_steps(self, data, label=None, k=None, eval_metric=None):
        """K training steps (forward, backward, optimizer update) over K
        stacked batches: ``data`` / ``label`` carry a leading step axis
        (see :func:`_canon_step_inputs`).  The result equals K single
        steps; with ``eval_metric``, each step's outputs are folded into
        it.  Returns each output of every step stacked on a leading K
        axis, one NDArray per output (reference: base_module.py
        run_steps; the JAX package's scan of K steps in one program has
        no counterpart yet)."""
        data_arrays, k = _canon_step_inputs(self.data_names, data, "data", k)
        label_arrays, k = _canon_step_inputs(
            getattr(self, "label_names", []), label, "label", k)
        outs_steps = []
        for j in range(k):
            batch = io_mod.DataBatch(
                data=[NDArray(a[j]) for a in data_arrays],
                label=[NDArray(a[j]) for a in label_arrays]
                if label_arrays else None)
            self.forward(batch, is_train=True)
            self.update()
            if eval_metric is not None:
                self.update_metric(eval_metric, batch.label)
            outs_steps.append([o._data for o in self.get_outputs()])
        return [NDArray(torch.stack([s[i] for s in outs_steps]))
                for i in range(len(outs_steps[0]))]

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Run inference forwards over ``eval_data`` and fold the outputs
        into ``eval_metric`` (reference: base_module.py score)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield ``(outputs, nbatch, batch)`` per batch of ``eval_data``:
        the inference outputs with the batch's padding rows cut off, as
        NDArrays on the module's device (reference: base_module.py
        iter_predict)."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield outputs, nbatch, eval_batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Inference outputs over ``eval_data`` (reference: base_module.py
        predict).  Padding rows are cut off on the device.  Merged (the
        default), each output's batches are joined on the device and read
        back to the host once, as a CPU NDArray; a single output comes
        alone unless ``always_output_list``.  Unmerged, the list of each
        batch's outputs, on the device."""
        assert self.binded and self.params_initialized
        output_list = [outputs for outputs, _, _ in
                       self.iter_predict(eval_data, num_batch, reset)]
        if not output_list:
            return output_list
        if not merge_batches:
            return [[o.copy() for o in outs] for outs in output_list]
        num_outputs = len(output_list[0])
        if any(len(outs) != num_outputs for outs in output_list):
            raise MXNetError("predict: cannot merge batches with different "
                             "numbers of outputs")
        merged = []
        for i in range(num_outputs):
            joined = torch.cat([outs[i]._data for outs in output_list])
            merged.append(NDArray(joined.cpu()))
            _prof.record_host_sync("predict.readback")
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """The training loop: bind, init params and optimizer, then per
        epoch forward / backward / update over ``train_data`` with the
        metric folded in (reference: base_module.py fit).  A ``monitor``
        is installed after ``bind`` and ticks around every batch."""
        assert num_epoch is not None, "please specify number of epochs"
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            data_iter = iter(train_data)
            next_data_batch = next(data_iter, None)
            nbatch = 0
            while next_data_batch is not None:
                data_batch = next_data_batch
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                # on the device for a device-capable metric: the loop's
                # only readbacks are the callbacks' reads of the metric
                self.update_metric(eval_metric, data_batch.label)
                next_data_batch = next(data_iter, None)
                if next_data_batch is not None:
                    self.prepare(next_data_batch)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            arg_params_, aux_params_ = self.get_params()
            if epoch_end_callback is not None:
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    # -- interface ---------------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_states(self, merge_multi_context=True):
        """A module without state inputs has none (the JAX package's
        default)."""
        assert self.binded and self.params_initialized
        return []

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        assert not states and not value

    def prepare(self, data_batch):
        """Called by ``fit`` on the next batch before its forward (the
        reference's hook for sparse row pulls); nothing by default."""

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        """Write the parameters as ``arg:name`` / ``aux:name`` arrays
        (reference: base_module.py save_params)."""
        arg_params, aux_params = self.get_params()
        save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
        save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
        save_ndarrays(fname, save_dict)

    def load_params(self, fname):
        """Set the parameters from a file of :meth:`save_params` or
        ``model.save_checkpoint`` of either package."""
        arg_params, aux_params = {}, {}
        for k, value in load_ndarrays(fname).items():
            arg_type, name = k.split(":", 1)
            if arg_type == "arg":
                arg_params[name] = value
            elif arg_type == "aux":
                aux_params[name] = value
            else:
                raise ValueError("Invalid param file " + fname)
        self.set_params(arg_params, aux_params)

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()
