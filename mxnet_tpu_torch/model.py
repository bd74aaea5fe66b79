"""Model helpers.

PyTorch counterpart of ``mxnet_tpu/model.py``: ``BatchEndParam``,
the kvstore wiring (``_create_kvstore``, ``_initialize_kvstore``,
``_update_params_on_kvstore``, ``_update_params``; JAX package
``model.py:23-110``), the checkpoint pair ``save_checkpoint`` /
``load_checkpoint``, whose files either package reads, and the legacy
``FeedForward`` estimator over ``Module``.  With one device a store type
by name means no store, and a KVStore object updates inside the store
(:mod:`mxnet_tpu_torch.kvstore`); a distributed type by name makes its
store (``dist_sync`` over the gloo group, ``dist_async`` over the
parameter servers), which updates inside.
"""
from __future__ import annotations

import logging
import os
import warnings
from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError
from . import kvstore as kvs
from .serialization import load_ndarrays, save_ndarrays
from .symbol import load as _load_symbol

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(store, update_on_kvstore) (reference: model.py:57): a KVStore
    object updates inside the store; a type name with one device needs
    no store; a 'local' store of a parameter over 16M values updates
    outside it."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(np.prod(param.shape)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return kv, update_on_kvstore


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Put every parameter into the store; when it updates there, pull
    them back (reference: model.py:96)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            if not isinstance(param_on_devs, (list, tuple)):
                param_on_devs = [param_on_devs]
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push every gradient, the store updates, pull every weight back
    (reference: model.py:105), one list push and one list pull."""
    names, grads, args = [], [], []
    for index, (arg_list, grad_list) in enumerate(
            zip(param_arrays, grad_arrays)):
        if grad_list is None or (isinstance(grad_list, list)
                                 and grad_list[0] is None):
            continue
        names.append(param_names[index])
        grads.append(grad_list)
        args.append(arg_list)
    if not names:
        return
    kvstore.push(names, grads)
    kvstore.pull(names, out=args)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater(key, grad, weight)`` to every weight that has a
    gradient, keyed by parameter name when given; with a store, each
    gradient is pushed and the reduced one pulled back first (reference:
    model.py:117)."""
    for index, (arg_list, grad_list) in enumerate(
            zip(param_arrays, grad_arrays)):
        if not isinstance(arg_list, (list, tuple)):
            arg_list, grad_list = [arg_list], [grad_list]
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, (w, g) in enumerate(zip(arg_list, grad_list)):
            key = param_names[index] if param_names else \
                index * num_device + k
            updater(key, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params`` holding ``arg:name`` and ``aux:name`` arrays
    (reference: model.py:340)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    save_ndarrays(param_name, save_dict)
    logging.info('Saved checkpoint to "%s"', param_name)


def load_checkpoint(prefix, epoch):
    """(symbol or None, arg_params, aux_params) of a checkpoint, the
    arrays on the CPU (reference: model.py:370)."""
    symbol = None
    if os.path.exists("%s-symbol.json" % prefix):
        symbol = _load_symbol("%s-symbol.json" % prefix)
    save_dict = load_ndarrays("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return symbol, arg_params, aux_params


class FeedForward:
    """The reference's legacy estimator (reference: model.py
    FeedForward), deprecated there for ``Module`` and a thin layer over
    ``Module`` here: ``fit`` / ``predict`` / ``score`` take numpy arrays
    (wrapped in an ``NDArrayIter`` of ``numpy_batch_size`` rows:
    shuffled and whole batches for training, padded for inference) or a
    DataIter, and ``save`` / ``load`` / ``create`` as in the reference.
    Optimizer hyperparameters come as keyword arguments."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        warnings.warn("FeedForward is deprecated. Please use Module "
                      "instead.", DeprecationWarning, stacklevel=2)
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = dict(arg_params) if arg_params else None
        self.aux_params = dict(aux_params) if aux_params else None
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        if allow_extra_params and self.arg_params is not None:
            names = set(symbol.list_arguments())
            self.arg_params = {k: v for k, v in self.arg_params.items()
                               if k in names}
        if allow_extra_params and self.aux_params is not None:
            names = set(symbol.list_auxiliary_states())
            self.aux_params = {k: v for k, v in self.aux_params.items()
                               if k in names}
        self._module = None
        self._label_names = []

    def _init_iter(self, X, y, is_train):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        X = np.asarray(X)
        if y is not None:
            y = np.asarray(y)
        elif is_train:
            raise ValueError("y must be specified when X is numpy")
        else:
            # inference runs the loss head too: zero labels
            y = np.zeros(X.shape[0], dtype=np.float32)
        batch = min(self.numpy_batch_size, X.shape[0])
        return NDArrayIter(data=X, label=y, batch_size=batch,
                           shuffle=bool(is_train),
                           last_batch_handle="discard" if is_train
                           else "pad")

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs through ``Module.fit``."""
        from .module import Module
        if self.num_epoch is None:
            raise ValueError("num_epoch must be set when constructing "
                             "FeedForward for fit")
        train = self._init_iter(X, y, is_train=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            ex, ey = eval_data
            eval_data = self._init_iter(ex, ey, is_train=False)
        self._label_names = [l[0] for l in (train.provide_label or [])]
        self._module = Module(
            self.symbol, data_names=[d[0] for d in train.provide_data],
            label_names=self._label_names, context=self.ctx)
        self._module.fit(
            train, eval_data=eval_data, eval_metric=eval_metric,
            epoch_end_callback=epoch_end_callback,
            batch_end_callback=batch_end_callback, kvstore=kvstore,
            optimizer=self.optimizer, optimizer_params=dict(self.kwargs),
            eval_end_callback=eval_end_callback,
            eval_batch_end_callback=eval_batch_end_callback,
            initializer=self.initializer, arg_params=self.arg_params,
            aux_params=self.aux_params,
            allow_missing=self.arg_params is not None,
            begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
            monitor=monitor)
        self.arg_params, self.aux_params = self._module.get_params()
        return self

    def _pred_module(self, data_iter):
        """An inference Module over the parameters; the loss head's label
        inputs (named by the iterator, remembered from ``fit``, or ending
        in ``label``) are bound to dummies."""
        from .module import Module
        if self.arg_params is None:
            raise MXNetError("model has no parameters: fit() it or "
                             "construct with arg_params")
        data_names = [d[0] for d in data_iter.provide_data]
        known = set(data_names) | set(self.arg_params) \
            | set(self.aux_params or {})
        hinted = {l[0] for l in (data_iter.provide_label or [])}
        hinted.update(self._label_names)
        labels = [n for n in self.symbol.list_arguments()
                  if n not in known and (n in hinted or n.endswith("label"))]
        provided = {l[0]: tuple(l[1]) for l in (data_iter.provide_label
                                                  or [])}
        batch = data_iter.provide_data[0][1][0]
        label_shapes = [(n, provided.get(n, (batch,))) for n in labels]
        mod = Module(self.symbol, data_names=data_names,
                     label_names=labels or None, context=self.ctx)
        mod.bind(data_shapes=data_iter.provide_data,
                 label_shapes=label_shapes or None, for_training=False)
        mod.set_params(self.arg_params, self.aux_params or {},
                       allow_missing=False, allow_extra=True)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (a list for several outputs);
        with ``return_data`` also the data and labels, pad rows cut."""
        data_iter = self._init_iter(X, None, is_train=False)
        mod = self._pred_module(data_iter)
        outs = mod.predict(data_iter, num_batch=num_batch, reset=reset,
                           always_output_list=False)
        result = [o.asnumpy() for o in outs] if isinstance(outs, list) \
            else outs.asnumpy()
        if not return_data:
            return result
        data_iter.reset()
        xs, ys = [], []
        for i, batch in enumerate(data_iter):
            if num_batch is not None and i >= num_batch:
                break
            real = batch.data[0].shape[0] - (batch.pad or 0)
            xs.append(batch.data[0]._data[:real])
            ys.append(batch.label[0]._data[:real])
        return (result, torch.cat(xs).cpu().numpy(),
                torch.cat(ys).cpu().numpy())

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """The metric's value over ``X``."""
        data_iter = self._init_iter(X, None, is_train=False)
        mod = self._pred_module(data_iter)
        res = mod.score(data_iter, eval_metric, num_batch=num_batch,
                        batch_end_callback=batch_end_callback, reset=reset)
        return res[0][1] if res else None

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None,
               epoch_size=None, optimizer="sgd", initializer=None,
               eval_data=None, eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
