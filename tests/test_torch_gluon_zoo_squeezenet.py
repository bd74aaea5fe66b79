"""The Gluon zoo's SqueezeNet in the PyTorch port against the JAX
package (``tests/torch_gluon_zoo.py``) at 64x64 (the fire modules'
``_Concurrent`` branches, ``ceil_mode`` pooling as
``pooling_convention='full'``), batch 2, 10 classes: the smallest member,
``squeezenet1_1``, imperatively with names and shapes, inference logits
and one ``gluon.Trainer`` step; ``squeezenet1_0`` hybridized with names,
shapes and inference logits.
Then ``squeezenet1_0(pretrained=True)`` from a local file reproduces the
JAX package's golden logits (``tests/golden/squeezenet_logits.npz``,
read, never written) within that test's own ``rtol=1e-4, atol=1e-5``.

Tolerances: logits within 1e-5 of their largest value; the update
within 1e-4 of the largest from the port's float64 step (no BatchNorm;
float32 rounding only)."""
import os

import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon.model_zoo import vision

from torch_gluon_zoo import check_against_jax, check_logits
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CLASSES = 10
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "squeezenet_logits.npz")


@pytest.fixture(autouse=True)
def _cpu_default():
    with mt.cpu():
        yield


def _zoo(name):
    return lambda pkg: pkg.gluon.model_zoo.vision.get_model(
        name, classes=CLASSES)


def test_squeezenet1_1_against_jax():
    check_against_jax(_zoo("squeezenet1.1"), (2, 3, 64, 64), CLASSES, False,
                      1e-5, 1e-5, 1e-4)


def test_squeezenet1_0_names_shapes_and_logits():
    check_logits(_zoo("squeezenet1.0"), (2, 3, 64, 64), CLASSES, 1e-5)


def _deterministic_params(net):
    """``tests/test_model_zoo_pretrained.py``'s seeded stand-in for a
    downloaded checkpoint, through the port."""
    net.initialize(mt.initializer.Zero())
    net(mt.nd.zeros((1, 3, 64, 64)))
    for i, (name, p) in enumerate(sorted(net.collect_params().items())):
        rs = np.random.RandomState(1234 + i)
        p.set_data(mt.nd.array(
            rs.uniform(-0.08, 0.08, p.shape).astype("float32")))


def test_pretrained_path_reproduces_the_golden_logits(tmp_path):
    root = str(tmp_path)
    with mt.name.NameManager():
        src = vision.squeezenet1_0(classes=10)
    _deterministic_params(src)
    src.save_params(os.path.join(root, "squeezenet1.0.params"))
    with mt.name.NameManager():
        net = vision.squeezenet1_0(classes=10, pretrained=True, root=root)
    rs = np.random.RandomState(7)
    x = mt.nd.array(rs.uniform(0, 1, (2, 3, 64, 64)).astype("float32"))
    out = net(x).asnumpy()
    assert out.shape == (2, 10)
    want = np.load(GOLDEN)["logits"]
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)
    with pytest.raises(mt.MXNetError, match="not found"):
        vision.squeezenet1_0(pretrained=True, root=str(tmp_path / "none"))


def test_concurrent_registers_each_branch_twice_in_both_packages():
    """A reference fault the port keeps: ``_Concurrent.add`` registers a
    branch as a child and again through ``Block.__setattr__``, so every
    branch runs twice and the concatenation carries it twice: a fire
    module of 64 + 64 expand channels puts out 256.  The port keeps it,
    since the JAX package's files and the golden logits above hold this
    network (ROADMAP §3)."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.vision.squeezenet import _make_fire as jf
    from mxnet_tpu_torch.gluon.model_zoo.vision.squeezenet import \
        _make_fire as tf
    for pkg, make in ((mx, jf), (mt, tf)):
        fire = make(16, 64, 64)
        paths = fire._children[1]
        assert len(paths._children) == 4
        assert paths._children[0] is paths._children[1]
        fire.initialize()
        out = fire(pkg.nd.ones((1, 32, 8, 8)))
        assert out.shape == (1, 256, 8, 8)
