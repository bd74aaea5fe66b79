"""One ``gluon.Trainer`` SGD-momentum step through Inception v3's five
block kinds in the PyTorch port against the JAX package
(``tests/torch_gluon_zoo.py``): ``_make_A``, ``_make_B``, ``_make_C``,
``_make_D`` and ``_make_E`` of the zoo's ``inception.py`` at their
published widths, chained (192 channels of 17x17 in, then a global
average pool and a Dense of 10), batch 2, hybridized.  The whole
network's JAX backward takes minutes to compile on the CPU; its names,
shapes and logits are in ``test_torch_gluon_zoo_inception.py``.

Tolerances: logits 1e-5 of their largest; training logits and loss
within 1e-4 of float64's; the update within 1e-4 of float64's (5.5e-6
port, 5.6e-6 JAX measured)."""
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu.gluon.model_zoo.vision import inception as jinception
from mxnet_tpu_torch.gluon.model_zoo.vision import inception as tinception

from torch_gluon_zoo import check_against_jax
import torch_threads  # noqa: F401,E402  a worker's share of the cores

BLOCKS = (("_make_A", (32, "A1_")), ("_make_B", ("B_",)),
          ("_make_C", (128, "C1_")), ("_make_D", ("D_",)),
          ("_make_E", ("E1_",)))


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def _trunk(pkg):
    mod = jinception if pkg is mx else tinception
    net = pkg.gluon.nn.HybridSequential()
    with net.name_scope():
        for fn, args in BLOCKS:
            net.add(getattr(mod, fn)(*args))
        net.add(pkg.gluon.nn.GlobalAvgPool2D())
        net.add(pkg.gluon.nn.Dense(10))
    return net


def test_trunk_step_against_jax():
    check_against_jax(_trunk, (2, 192, 17, 17), 10, True, 1e-5, 1e-4, 1e-4)
