"""Notebook utilities (reference: python/mxnet/notebook/)."""
from . import callback  # noqa: F401
