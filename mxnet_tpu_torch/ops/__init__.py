"""Operator implementations on torch tensors; importing registers them."""
from . import registry
from . import (elemwise, matrix, indexing, nn, init_ops,  # noqa: F401
               attention, reduce, rnn, sequence, detection, contrib_ops,
               spatial, moe, chunked_loss, optimizer_ops, linalg,
               sampling, custom)
