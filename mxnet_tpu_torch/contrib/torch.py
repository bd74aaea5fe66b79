"""Torch bridge (reference: plugin/torch + python/mxnet/torch.py).

PyTorch counterpart of ``mxnet_tpu/contrib/torch.py``.  The reference
bridged Torch7 modules through a C glue layer, the JAX package bridges
PyTorch on the host through numpy; in the port an NDArray holds a torch
tensor, so the bridge hands the tensors over without a copy, on their
device.  ``torch_function`` applies any torch callable to NDArrays (and
tensors) and ``TorchLoss`` exposes a torch criterion as an op; under
``autograd.record()`` both are recorded, so gradients flow through them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd as _ag
from ..ndarray import NDArray


def _tensor_in(a):
    """The tensor a recorded call reads from ``a`` (an NDArray), or
    ``a`` itself."""
    if not isinstance(a, NDArray):
        return a
    return _ag.variable_tensor(a) if _ag.is_recording() else a._data


def _wrap(out):
    if isinstance(out, (tuple, list)):
        return [_wrap(o) for o in out]
    if isinstance(out, torch.Tensor):
        return NDArray(out if _ag.is_recording() else out.detach())
    return out


def torch_function(fn, *args, **kwargs):
    """Apply a torch callable to NDArray (or tensor) inputs eagerly;
    returns NDArray(s) over the callable's result tensors (reference:
    mxnet.th function dispatch)."""
    with torch.set_grad_enabled(_ag.is_recording()):
        out = fn(*[_tensor_in(a) for a in args], **kwargs)
    return _wrap(out)


class TorchLoss:
    """A torch criterion as a differentiable op.

    ``loss = TorchLoss(torch.nn.functional.mse_loss)(pred, target)``
    runs the criterion in float32 on the inputs' device (integer targets
    as int64, as torch losses expect) and returns the loss in ``pred``'s
    dtype; under ``autograd.record()`` its backward is torch's.
    """

    def __init__(self, criterion, **kwargs):
        self._criterion = criterion
        self._kwargs = kwargs

    @staticmethod
    def _t_dtype(np_dtype):
        """Torch dtype preserving float-vs-integer class."""
        name = str(np_dtype).replace("torch.", "").replace("bfloat16",
                                                           "float32")
        if np.issubdtype(np.dtype(name), np.floating):
            return torch.float32
        return torch.int64

    def __call__(self, pred, target):
        t_dtype = self._t_dtype(target.dtype)

        def fn(p, t):
            out = self._criterion(p.float(), t.detach().to(t_dtype),
                                  **self._kwargs)
            return out.to(p.dtype)
        return torch_function(fn, pred, target)
