"""NDArray (subset): the array type ``Module`` and the iterators hand to
users, and NDArray files."""
from .ndarray import NDArray, array, zeros, save, load

__all__ = ["NDArray", "array", "zeros", "save", "load"]
