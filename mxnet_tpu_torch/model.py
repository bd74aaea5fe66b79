"""Model helpers (subset).

PyTorch counterpart of the part of ``mxnet_tpu/model.py`` that
``Module`` training on one device runs: ``BatchEndParam``,
``_create_kvstore``, ``_update_params`` and the checkpoint pair
``save_checkpoint`` / ``load_checkpoint``, whose files either package
reads.  With one device and
``'local'`` or ``None`` there is no store; a distributed kvstore raises
until the port's distributed plane exists (ROADMAP E1).
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

from .base import MXNetError
from .serialization import load_ndarrays, save_ndarrays
from .symbol import load as _load_symbol

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(store, update_on_kvstore) — always (None, False) here: one device
    needs no store (reference: model.py _create_kvstore)."""
    if kvstore is None:
        return None, False
    if isinstance(kvstore, str):
        if "dist" in kvstore:
            raise MXNetError(f"kvstore {kvstore!r}: the distributed "
                             "kvstore is not ported yet (ROADMAP E1)")
        if num_device == 1:
            return None, False
        raise MXNetError(f"kvstore {kvstore!r} over {num_device} devices: "
                         "multi-device training is not ported yet "
                         "(ROADMAP D1)")
    raise MXNetError(f"kvstore {kvstore!r}: KVStore objects are not ported "
                     "yet (ROADMAP E1)")


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Apply ``updater(key, grad, weight)`` to every weight that has a
    gradient, keyed by parameter name when given (reference: model.py
    _update_params, without the store's reduce)."""
    if kvstore is not None:
        raise MXNetError("_update_params: no kvstore is ported yet")
    for index, (arg, grad) in enumerate(zip(param_arrays, grad_arrays)):
        if grad is None:
            continue
        key = param_names[index] if param_names else index * num_device
        updater(key, grad, arg)


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
