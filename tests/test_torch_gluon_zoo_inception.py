"""The Gluon zoo's Inception v3 in the PyTorch port against the JAX
package (``tests/torch_gluon_zoo.py``): ``inception_v3`` at its input of
299x299 (the final ``AvgPool2D(8)``), batch 2, 10 classes: the parameter
names and shapes (the ``_Concurrent`` blocks' ``A1_`` ... ``E2_``
prefixes) and the hybridized inference logits, within 1e-5 of their
largest value.  The training step is in
``test_torch_gluon_zoo_inception_trunk.py``."""
import pytest

import mxnet_tpu_torch as mt

from torch_gluon_zoo import check_logits


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def test_inception_v3_names_shapes_and_logits():
    check_logits(lambda pkg: pkg.gluon.model_zoo.vision.inception_v3(
        classes=10), (2, 3, 299, 299), 10, 1e-5)
