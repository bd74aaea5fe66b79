"""NDArray (subset): the array type ``Module`` and the iterators hand to
users, ``take``, and NDArray files."""
from .ndarray import NDArray, array, zeros, take, save, load

__all__ = ["NDArray", "array", "zeros", "take", "save", "load"]
