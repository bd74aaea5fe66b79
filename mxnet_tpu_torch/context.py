"""Device context.

PyTorch counterpart of ``mxnet_tpu/context.py``: a ``Context`` names a
logical device and maps onto a :class:`torch.device`.  ``gpu(i)`` is
``cuda:i`` and is the default context; ``cpu()`` must be asked for
explicitly (the tests do).  ``cpu_pinned()`` is page-locked host memory
(an NDArray made there is pinned, which needs CUDA).  Resolving a GPU
context on a machine without CUDA raises — nothing falls back to the
CPU silently.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError


class Context:
    """A logical device (cpu/gpu) backed by a torch.device."""

    _DEVICE_TYPES = ("cpu", "gpu", "cpu_pinned")
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_type = device_type.device_type
            self.device_id = device_type.device_id
        else:
            if device_type not in self._DEVICE_TYPES:
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_type = device_type
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    def torch_device(self) -> torch.device:
        """The torch.device for this context.  A GPU context raises when
        CUDA is absent or the ordinal does not exist."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self}: CUDA is not available; pass ctx=cpu() to run "
                "on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self}: only {n} CUDA device(s) visible")
        return torch.device("cuda", self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = current_context()
        self._default_ctx.value = self
        return self

    def __exit__(self, *args):
        self._default_ctx.value = self._old_ctx


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Page-locked host memory: the staging place of fast copies to the
    card."""
    return Context("cpu_pinned", device_id)


def num_gpus() -> int:
    """The number of CUDA devices visible (0 without CUDA)."""
    return torch.cuda.device_count()


def current_context() -> Context:
    """The ambient context: ``gpu(0)`` unless a ``with ctx:`` block set
    another."""
    if not hasattr(Context._default_ctx, "value"):
        Context._default_ctx.value = Context("gpu", 0)
    return Context._default_ctx.value


def as_device(ctx=None) -> torch.device:
    """Resolve a Context / torch.device / device string (None = the
    current context) to a torch.device."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device()
    dev = torch.device(ctx)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(f"{dev}: CUDA is not available")
    return dev
