"""SequentialModule: a chain of modules run back to back.

PyTorch counterpart of ``mxnet_tpu/module/sequential_module.py``
(reference: python/mxnet/module/sequential_module.py): each module's
outputs are the next one's data; ``take_labels`` marks the modules that
consume the labels.  Every module after the first is bound with
``inputs_need_grad``, so the backward runs from the last module to the
first through each one's input gradients.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule


class SequentialModule(BaseModule):
    """reference: sequential_module.py SequentialModule."""

    META_TAKE_LABELS = 'take_labels'
    META_AUTO_WIRING = 'auto_wiring'

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append a module with meta flags (``take_labels``,
        ``auto_wiring``); returns self, so calls chain."""
        self._modules.append(module)
        for k in kwargs:
            if k not in self._meta_keys:
                raise MXNetError(f"unknown meta key {k!r}; "
                                 f"valid: {sorted(self._meta_keys)}")
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for m in self._modules:
            arg, aux = m.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        # each module sees only its own names: the missing and extra
        # names are checked here over all of them
        wanted = set()
        wanted_aux = set()
        for m in self._modules:
            wanted.update(getattr(m, '_param_names', []))
            wanted_aux.update(getattr(m, '_aux_names', []))
        if not allow_missing:
            missing = sorted(wanted - set(arg_params)) \
                if arg_params is not None else []
            missing += sorted(wanted_aux - set(aux_params)) \
                if aux_params is not None else []
            if missing:
                raise MXNetError(
                    f"init_params: provided params missing {missing} "
                    f"(pass allow_missing=True to random-init them)")
        if not allow_extra:
            extra = sorted(set(arg_params or {}) - wanted) + \
                sorted(set(aux_params or {}) - wanted_aux)
            if extra:
                raise MXNetError(
                    f"init_params: provided params contain unknown names "
                    f"{extra} (pass allow_extra=True to ignore them)")
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params,
                          allow_missing=True,
                          force_init=force_init, allow_extra=True)

        # no parameter name twice (reference: _check_name)
        seen = {}
        for i, m in enumerate(self._modules):
            for name in m.get_params()[0]:
                if name in seen:
                    raise MXNetError(
                        f"duplicate parameter {name!r} in sub-modules "
                        f"{seen[name]} and {i}")
                seen[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req='write'):
        if self.binded and not force_rebind:
            self.logger.warning('Already bound, ignoring bind()')
            return
        if not self._modules:
            raise MXNetError("SequentialModule has no sub-modules; "
                             "call add() first")
        if shared_module is not None:
            raise MXNetError("shared_module is not supported for "
                             "SequentialModule")
        self._label_shapes = label_shapes
        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta_take_labels:
                module.bind(my_data_shapes, label_shapes,
                            for_training=for_training,
                            inputs_need_grad=(inputs_need_grad or i > 0),
                            force_rebind=force_rebind, grad_req=grad_req)
                anybody_ever_needs_label = True
            else:
                module.bind(my_data_shapes, None,
                            for_training=for_training,
                            inputs_need_grad=(inputs_need_grad or i > 0),
                            force_rebind=force_rebind, grad_req=grad_req)
            if i + 1 < len(self._modules):
                # the next module's data are this module's outputs
                from ..io import DataDesc
                out_shapes = [tuple(o[1]) if isinstance(o, (tuple, list))
                              else tuple(o.shape)
                              for o in module.output_shapes]
                nxt_names = self._modules[i + 1].data_names
                my_data_shapes = [DataDesc(n, s)
                                  for n, s in zip(nxt_names, out_shapes)]
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def init_optimizer(self, kvstore='local', optimizer='sgd',
                       optimizer_params=(('learning_rate', 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 == len(self._modules):
                break
            out = module.get_outputs()
            batch = DataBatch(data=out, label=data_batch.label,
                              pad=getattr(data_batch, 'pad', 0))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        for module, meta in zip(self._modules, self._metas):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Install ``mon`` on every module of the chain."""
        for m in self._modules:
            m.install_monitor(mon)
