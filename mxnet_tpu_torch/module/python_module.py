"""PythonModule and PythonLossModule: modules whose computation is
Python code rather than a bound symbol.

PyTorch counterpart of ``mxnet_tpu/module/python_module.py`` (reference:
python/mxnet/module/python_module.py): parameter-free by default, with
no-op updates, typically a custom loss at the end of a
``SequentialModule`` chain.
"""
from __future__ import annotations

import logging

import numpy as np

from ..base import MXNetError
from ..io import DataDesc
from ..ndarray import NDArray
from .base_module import BaseModule


class PythonModule(BaseModule):
    """A parameter-free module computing its outputs in Python; a
    subclass defines ``_compute_output_shapes``, ``forward``,
    ``get_outputs`` and, for training, ``backward`` and
    ``get_input_grads``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update_dict(
                dict(zip(self._label_names, labels or [])),
                dict(zip(self._output_names, self.get_outputs())))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._data_shapes = [d if isinstance(d, DataDesc) else DataDesc(*d)
                             for d in data_shapes]
        self._label_shapes = ([l if isinstance(l, DataDesc)
                               else DataDesc(*l) for l in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    def _compute_output_shapes(self):
        """[(output name, shape)] from the bound data and label shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        """A Python module runs no executor to observe (reference:
        python_module.py install_monitor)."""
        raise NotImplementedError()


class PythonLossModule(PythonModule):
    """A loss whose forward passes its input through and whose input
    gradient is ``grad_func(scores, labels)`` (an NDArray or an
    array-like, moved to the scores' device)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if len(self._data_names) != 1:
            raise MXNetError("PythonLossModule takes one data input")
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("a loss module takes no out_grads")
        if not self.for_training:
            raise MXNetError("backward: the module is not bound for "
                             "training")
        if self._grad_func is None:
            raise MXNetError("PythonLossModule: provide grad_func to "
                             "compute the loss gradient")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, NDArray):
            grad = NDArray(np.asarray(grad))
        self._scores_grad = NDArray(grad._data.to(self._scores._data.device))

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
