"""The Gluon zoo's DenseNet in the PyTorch port against the JAX package
(``tests/torch_gluon_zoo.py``).

* ``densenet121``, the smallest member, at its smallest input (224x224:
  the final ``AvgPool2D(7)``), batch 2, 10 classes: the parameter names
  and shapes and the hybridized inference logits, within 1e-5 of their
  largest value.
* One ``gluon.Trainer`` step of the same ``DenseNet`` code at 224x224
  with narrower and shallower blocks (16 initial features, growth 8,
  two layers a block): the JAX package's backward of densenet121 takes
  three minutes to compile on the CPU.  Logits 1e-5; training logits and
  loss within 1e-4 of float64's; the update within 1e-4 of float64's (3.0e-6
  port, 4.5e-6 JAX measured)."""
import pytest

import mxnet_tpu_torch as mt

from torch_gluon_zoo import check_against_jax, check_logits
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def test_densenet121_names_shapes_and_logits():
    check_logits(lambda pkg: pkg.gluon.model_zoo.vision.densenet121(
        classes=10), (2, 3, 224, 224), 10, 1e-5)


def test_densenet_step_against_jax():
    check_against_jax(lambda pkg: pkg.gluon.model_zoo.vision.DenseNet(
        16, 8, [2, 2, 2, 2], classes=10), (2, 3, 224, 224), 10, True,
        1e-5, 1e-4, 1e-4)
