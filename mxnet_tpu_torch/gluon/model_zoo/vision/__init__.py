"""Gluon vision model zoo (reference:
python/mxnet/gluon/model_zoo/vision/__init__.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision``: the ResNet
family is ported; ``get_model`` knows the zoo's other names and raises
for them (ROADMAP G2).  ``pretrained=True`` needs the weight file present
locally (``model_store``), as in the JAX package.
"""
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2, get_resnet)

from ....base import MXNetError

_models = {
    'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
    'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
    'resnet152_v1': resnet152_v1,
    'resnet18_v2': resnet18_v2, 'resnet34_v2': resnet34_v2,
    'resnet50_v2': resnet50_v2, 'resnet101_v2': resnet101_v2,
    'resnet152_v2': resnet152_v2,
}
# the JAX package's other zoo names, not ported yet
_NOT_PORTED = (
    'vgg11', 'vgg13', 'vgg16', 'vgg19', 'vgg11_bn', 'vgg13_bn', 'vgg16_bn',
    'vgg19_bn', 'alexnet', 'densenet121', 'densenet161', 'densenet169',
    'densenet201', 'squeezenet1.0', 'squeezenet1.1', 'inceptionv3',
    'mobilenet1.0', 'mobilenet0.75', 'mobilenet0.5', 'mobilenet0.25')


def get_model(name, **kwargs):
    """reference: model_zoo/__init__.py get_model."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError(f"Model {name!r} is not ported to mxnet_tpu_torch "
                         "yet (ROADMAP G2: the rest of the Gluon model zoo)")
    if name not in _models:
        raise MXNetError(f"Model {name!r} is not supported. Available: "
                         f"{sorted(_models)}")
    return _models[name](**kwargs)
