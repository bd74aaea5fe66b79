"""Global random generator.

PyTorch counterpart of ``mxnet_tpu/random.py``: ``seed(n)`` reseeds the
one generator the package draws from (initializers, iterator shuffles
draw from numpy's global state, as in the JAX package).  It is a
``torch.Generator`` on the CPU, so a seed gives the same numbers whatever
device the drawn values are then copied to; they are not the JAX
package's bits.  Ops that draw random numbers when run imperatively or
in a hybridized Gluon block (Dropout, LeakyReLU's rrelu) take
:func:`device_generator`, one generator a device, seeded from the same
seed and reset by ``seed``.
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


def device_generator(device) -> torch.Generator:
    """The imperative ops' generator on ``device`` (a torch.device)."""
    gens = getattr(_state, "device_gens", None)
    if gens is None:
        gens = _state.device_gens = {}
    key = str(device)
    gen = gens.get(key)
    if gen is None:
        # a stream apart from generator()'s, which the initializers draw
        # from: the same seed must not repeat their numbers
        seed0 = getattr(_state, "seed", 0)
        gen = gens[key] = torch.Generator(device).manual_seed(
            seed0 * 1_000_003 + 1)
    return gen


def seed(seed_state: int) -> None:
    """mx.random.seed — reseed the global generator (and drop the
    imperative ops' generators, which then restart from this seed)."""
    generator().manual_seed(int(seed_state))
    _state.seed = int(seed_state)
    _state.device_gens = {}
