"""Legacy contrib autograd API
(reference: python/mxnet/contrib/autograd.py: the pre-Gluon surface kept
for code written against it; everything forwards to the port's
``autograd``).  PyTorch counterpart of ``mxnet_tpu/contrib/autograd.py``.
"""
from __future__ import annotations

import functools

from .. import autograd as _ag
from ..ndarray import NDArray


def set_is_training(is_train):
    """Set the global training state; returns the previous state
    (reference: contrib/autograd.py:31 → MXAutogradSetIsTraining).

    In the legacy contrib API the single "is_training" flag controlled
    BOTH gradient recording and train-mode op behavior (the split into
    record/train_mode came later, in ``autograd``); this preserves
    the combined semantics, so ``set_is_training(True); y = f(x);
    compute_gradient([y])`` works as it did."""
    prev = _ag.is_recording() or _ag.is_training()
    _ag.set_recording(is_train)
    _ag.set_training(is_train)
    return prev


class TrainingStateScope:
    """Scope manager for the combined training state
    (reference: contrib/autograd.py:53).  Saves and restores the modern
    recording/training flags SEPARATELY, so nesting inside
    ``autograd.record(train_mode=False)``-style split states restores
    them exactly."""

    def __init__(self, enter_state):
        self._enter_state = enter_state
        self._prev_rec = None
        self._prev_train = None

    def __enter__(self):
        self._prev_rec = _ag.set_recording(self._enter_state)
        self._prev_train = _ag.set_training(self._enter_state)

    def __exit__(self, ptype, value, trace):
        _ag.set_recording(self._prev_rec)
        _ag.set_training(self._prev_train)


def train_section():
    """Scope marking computations for training: records for autograd AND
    runs ops in train mode (reference: :73)."""
    return TrainingStateScope(True)


def test_section():
    """Inference-mode scope inside a training section: stops recording
    and switches ops to eval behavior (reference: :87)."""
    return TrainingStateScope(False)


def mark_variables(variables, gradients, grad_reqs='write'):
    """reference: contrib/autograd.py:101."""
    _ag.mark_variables(variables, gradients, grad_reqs)


def backward(outputs, out_grads=None, retain_graph=False):
    """reference: contrib/autograd.py:127."""
    _ag.backward(outputs, head_grads=out_grads, retain_graph=retain_graph)


def compute_gradient(outputs):
    """Deprecated alias of backward (reference: :165)."""
    backward(outputs)


def grad_and_loss(func, argnum=None):
    """Return a function computing both gradient of arguments and loss
    (reference: contrib/autograd.py:170)."""
    @functools.wraps(func)
    def wrapped(*args):
        variables = list(args)
        if argnum is not None:
            argnums = [argnum] if isinstance(argnum, int) else list(argnum)
            variables = [args[i] for i in argnums]
        for x in variables:
            assert isinstance(x, NDArray), \
                "type of autograd input should be NDArray"
        from ..ndarray import zeros as nd_zeros
        grads = [nd_zeros(x.shape, ctx=x.context, dtype=x.dtype)
                 for x in variables]
        mark_variables(variables, grads)
        with _ag.record():
            outputs = func(*args)
        backward([outputs] if isinstance(outputs, NDArray) else outputs)
        return grads, outputs
    return wrapped


def grad(func, argnum=None):
    """Gradient-only version of grad_and_loss (reference: :202)."""
    grad_with_loss_func = grad_and_loss(func, argnum)

    @functools.wraps(grad_with_loss_func)
    def wrapped(*args):
        return grad_with_loss_func(*args)[0]
    return wrapped
