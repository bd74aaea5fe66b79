"""Gluon contrib: experimental blocks
(reference: python/mxnet/gluon/contrib/)."""
from . import rnn  # noqa: F401
from . import nn   # noqa: F401
