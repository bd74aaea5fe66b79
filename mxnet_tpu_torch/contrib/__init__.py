"""Contrib: experimental and bridge modules (reference:
python/mxnet/contrib).  The JAX package's ``contrib.export`` (an AOT
artifact) comes with the C ABI (ROADMAP C7)."""
from . import autograd
from . import tensorboard
from . import torch
