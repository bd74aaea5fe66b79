"""NDArray (subset): the array type ``Module`` and the iterators hand to
users."""
from .ndarray import NDArray, array, zeros

__all__ = ["NDArray", "array", "zeros"]
