"""The Gluon zoo's MobileNet in the PyTorch port against the JAX package
(``tests/torch_gluon_zoo.py``): the smallest member, ``mobilenet0_25``
(depthwise convolutions: ``num_group`` = channels), batch 2 of 64x64, 10
classes, hybridized: names and shapes, inference logits, one
``gluon.Trainer`` SGD-momentum step.

64x64, not the 32x32 the network accepts: at 32x32 its last stage
normalises 2 values a channel, and the two packages' f32 training
logits differ by 3.5e-3 of their largest.  At 64x64 (8 values) the
port's training logits lie 1.5e-5 from float64's and the JAX package's
3.7e-5, so both are held to 1e-4.  The update is ill-conditioned
(``DEEP_BN``, ROADMAP §3): the port's lands 4.0e-5 from float64, the JAX
package's 1.4e-2; both are held to 5e-2, the ResNet-50s' budget.
Inference logits: 1e-5 of their largest (1.9e-6 measured)."""
import pytest

import mxnet_tpu_torch as mt

from torch_gluon_zoo import check_against_jax
import torch_threads  # noqa: F401,E402  a worker's share of the cores


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def test_against_jax():
    check_against_jax(lambda pkg: pkg.gluon.model_zoo.vision.mobilenet0_25(
        classes=10), (2, 3, 64, 64), 10, True, 1e-5, 1e-4, 5e-2)
