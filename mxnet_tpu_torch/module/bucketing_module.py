"""BucketingModule (reference: python/mxnet/module/bucketing_module.py:35).

PyTorch counterpart of ``mxnet_tpu/module/bucketing_module.py``: one
child :class:`Module` per bucket key, bound on first use.  Every bucket
holds the SAME parameter NDArrays as the default bucket
(``Module.bind(shared_module=...)``) and the same optimizer, updater and
states (``Module.borrow_optimizer``): an update through any bucket
rebinds the shared arrays, so no parameter is ever copied on a switch.
The JAX package copies the parameters into a bucket's executor before
its forward and back into the default bucket after its update; the
numbers are the same.  Each bucket keeps its own gradient arrays and its
own state inputs (``state_names``); a switch copies the live states into
the new bucket when their shapes agree (they are batch-sized, not
bucket-sized).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module


class BucketingModule(BaseModule):
    """reference: bucketing_module.py:35.  ``sym_gen(bucket_key)``
    returns ``(symbol, data_names, label_names)``; ``compute_dtype``
    goes to every bucket's Module."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, fixed_param_names=None, state_names=None,
                 compute_dtype=None, mesh=None, sharding_rules=None):
        super().__init__(logger=logger)
        assert default_bucket_key is not None
        if mesh is not None or sharding_rules is not None:
            raise MXNetError("mesh / sharding_rules are not ported yet "
                             "(ROADMAP D1)")
        self._default_bucket_key = default_bucket_key
        self._sym_gen = sym_gen
        self._context = context
        self._state_names = list(state_names or [])
        self._compute_dtype = compute_dtype
        self._fixed_param_names = list(fixed_param_names or [])
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._grad_req = None
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _new_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names, label_names, logger=self.logger,
                      context=self._context, state_names=self._state_names,
                      fixed_param_names=self._fixed_param_names,
                      compute_dtype=self._compute_dtype)

    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        assert self.binded
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        assert self.binded
        return self._curr_module.symbol

    def get_params(self):
        assert self.binded and self.params_initialized
        return self._curr_module.get_params()

    def get_states(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        assert self.binded and self.params_initialized
        self._curr_module.set_states(states=states, value=value)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize the default bucket's parameters, which every bucket
        holds."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._buckets[self._default_bucket_key].init_params(
            initializer=initializer, arg_params=arg_params,
            aux_params=aux_params, allow_missing=allow_missing,
            force_init=force_init, allow_extra=allow_extra)
        for mod in self._buckets.values():
            mod.params_initialized = True
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind the default bucket's module (reference:
        bucketing_module.py:313)."""
        assert shared_module is None, \
            "shared_module for BucketingModule is not supported"
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._new_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, grad_req=grad_req)
        self.binded = True
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key``'s module current, binding it over the
        default bucket's parameters on first use (reference:
        bucketing_module.py:333)."""
        assert self.binded, "call bind before switching bucket"
        if bucket_key not in self._buckets:
            default = self._buckets[self._default_bucket_key]
            module = self._new_module(bucket_key)
            module.bind(data_shapes, label_shapes, self.for_training,
                        self.inputs_need_grad, shared_module=default,
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            if self.optimizer_initialized:
                module.borrow_optimizer(default)
            self._buckets[bucket_key] = module
        prev = self._curr_module
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key
        if self._state_names and prev is not self._curr_module \
                and self.params_initialized:
            states = prev.get_states()
            cur = self._curr_module.get_states()
            if all(tuple(a.shape) == tuple(b.shape)
                   for a, b in zip(states, cur)):
                self._curr_module.set_states(states=states)

    def install_monitor(self, mon):
        """Install ``mon`` on every bucket's module, and on those bound
        later (reference: bucketing_module.py install_monitor)."""
        assert self.binded
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer,
                                         optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    def prepare(self, data_batch):
        """Bind the batch's bucket, if new, and stay on the current one."""
        assert self.binded and self.params_initialized
        original = self._curr_bucket_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(original, None, None)

    def forward(self, data_batch, is_train=None):
        """reference: bucketing_module.py:404."""
        assert self.binded and self.params_initialized
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        assert self.binded and self.params_initialized
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._curr_module.save_checkpoint(prefix, epoch,
                                          save_optimizer_states)
