"""``nd`` — the imperative NDArray API: the array type, the creation and
free functions, NDArray files, and one function a registered op
(``nd.FullyConnected``, ``nd.relu``, ...; ``nd.contrib.X`` for the
``_contrib_X`` ops)."""
from .. import ops as _ops  # noqa: F401  registers every op
from .ndarray import (NDArray, array, empty, zeros, ones, full, arange,
                      concatenate, stack_arrays, onehot_encode, moveaxis,
                      waitall, take, save, load, _invoke)
from .register import init_ndarray_module
from ..base import ContribNamespace as _ContribNS

init_ndarray_module(globals())
contrib = _ContribNS(globals())

__all__ = ["NDArray", "array", "empty", "zeros", "ones", "full", "arange",
           "concatenate", "stack_arrays", "onehot_encode", "moveaxis",
           "waitall", "take", "save", "load", "contrib"]
