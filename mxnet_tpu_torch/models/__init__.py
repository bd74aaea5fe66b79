"""Symbolic model zoo (subset): the transformer LM and the ResNet family.

``get_symbol(name, **kwargs)`` dispatches by network name, as the JAX
package's does (reference: example/image-classification/common/fit.py
importing ``symbols/<network>.py``).  Only the networks this package can
build are registered; the rest of the JAX package's zoo (mlp, lenet,
alexnet, vgg, resnext, inception, mobilenet, squeezenet, densenet, vit)
waits for its ops (ROADMAP C1).
"""
from . import transformer  # noqa: F401
from . import resnet as _resnet
from .transformer import transformer_lm
from .resnet import get_symbol as resnet

_REGISTRY = {"resnet": _resnet}


def get_symbol(network, **kwargs):
    """Build the named network, e.g. ``get_symbol('resnet', num_layers=50,
    num_classes=1000, image_shape='3,224,224')``."""
    if network not in _REGISTRY:
        raise ValueError("unknown network %r; choose from %s"
                         % (network, sorted(_REGISTRY)))
    return _REGISTRY[network].get_symbol(**kwargs)
