"""Model helpers (subset).

PyTorch counterpart of the part of ``mxnet_tpu/model.py`` that
``Module`` training on one device runs: ``BatchEndParam``,
``_create_kvstore`` and ``_update_params``.  With one device and
``'local'`` or ``None`` there is no store; a distributed kvstore raises
until the port's distributed plane exists (ROADMAP E1).
"""
from __future__ import annotations

from collections import namedtuple

from .base import MXNetError

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
