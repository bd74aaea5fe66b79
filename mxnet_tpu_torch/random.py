"""Global random generator.

PyTorch counterpart of ``mxnet_tpu/random.py``: ``seed(n)`` reseeds the
one generator the package draws from (initializers, iterator shuffles
draw from numpy's global state, as in the JAX package).  It is a
``torch.Generator`` on the CPU, so a seed gives the same numbers whatever
device the drawn values are then copied to; they are not the JAX
package's bits.
"""
from __future__ import annotations

import threading

import torch

_state = threading.local()


def generator() -> torch.Generator:
    """The generator of this thread (seeded with 0 until ``seed``)."""
    gen = getattr(_state, "gen", None)
    if gen is None:
        gen = _state.gen = torch.Generator().manual_seed(0)
    return gen


def seed(seed_state: int) -> None:
    """mx.random.seed — reseed the global generator."""
    generator().manual_seed(int(seed_state))
