"""The Gluon zoo's AlexNet and VGG in the PyTorch port against the JAX
package (``tests/torch_gluon_zoo.py``): the smallest members (``vgg11``,
``vgg11_bn``) at the smallest input each accepts (AlexNet 63x63, VGG
32x32), batch 2, 10 classes: the parameter names and shapes, the
inference logits, and one ``gluon.Trainer`` SGD-momentum step: AlexNet
and ``vgg11`` hybridized, ``vgg11_bn`` imperatively (the two VGGs share
every layer but BatchNorm; the JAX package's imperative first pass is
its slowest, so one network takes it).

Tolerances (float32 rounding; neither network is deep in BatchNorm):
the logits within 1e-5 of their largest value; the update within 1e-4
of the largest update from the port's float64 step, in both packages.

AlexNet: the JAX package names its output layer ``alexnet0_dense0_``,
the name of the first Dense of ``features`` too, so its
``collect_params`` raises (ROADMAP §3); the port names it
``alexnet0_dense2_``, and the JAX network is compared with its output
layer rebuilt under that name."""
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

from torch_gluon_zoo import check_against_jax
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CLASSES = 10
INFER_RTOL = TRAIN_RTOL = 1e-5
UPDATE_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def _alexnet(pkg):
    net = pkg.gluon.model_zoo.vision.alexnet(classes=CLASSES)
    if pkg is mx:
        # the reference fault: rebuild the output layer under the name
        # the port gives it
        net.output = mx.gluon.nn.Dense(CLASSES, prefix=net.prefix + "dense2_")
    return net


def _zoo(name):
    return lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        name, classes=CLASSES)


NETS = {"alexnet": (_alexnet, (2, 3, 63, 63)),
        "vgg11": (_zoo("vgg11"), (2, 3, 32, 32)),
        "vgg11_bn": (_zoo("vgg11_bn"), (2, 3, 32, 32))}


@pytest.mark.parametrize("name,hybridize", [
    ("alexnet", True), ("vgg11", True), ("vgg11_bn", False)],
    ids=["alexnet-hybridized", "vgg11-hybridized", "vgg11_bn-imperative"])
def test_against_jax(name, hybridize):
    make, shape = NETS[name]
    check_against_jax(make, shape, CLASSES, hybridize, INFER_RTOL,
                      TRAIN_RTOL, UPDATE_RTOL)


def test_jax_alexnet_names_two_layers_alike():
    """The reference fault the port repairs: both packages' zoo code
    without the repair gives two ``alexnet0_dense0_`` layers."""
    with mx.name.NameManager():
        jnet = mx.gluon.model_zoo.vision.alexnet(classes=CLASSES)
    assert jnet.output.prefix == jnet.features[9].prefix == "alexnet0_dense0_"
    with pytest.raises(mx.base.MXNetError, match="duplicate parameter"):
        jnet.collect_params()
    with mt.name.NameManager():
        tnet = mt.gluon.model_zoo.vision.alexnet(classes=CLASSES)
    names = list(tnet.collect_params().keys())
    assert names[-2:] == ["alexnet0_dense2_weight", "alexnet0_dense2_bias"]
    assert len(names) == len(set(names)) == 16
