"""Gluon vision model zoo (reference:
python/mxnet/gluon/model_zoo/vision/__init__.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision``: every
network of the JAX package's zoo (ResNet v1 and v2, VGG with and without
BatchNorm, AlexNet, DenseNet, SqueezeNet, Inception v3, MobileNet), all
HybridBlocks with the JAX package's parameter names.
``pretrained=True`` needs the weight file present locally
(``model_store``), as in the JAX package.
"""
from .resnet import (ResNetV1, ResNetV2, BasicBlockV1, BasicBlockV2,
                     BottleneckV1, BottleneckV2,
                     resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1,
                     resnet152_v1, resnet18_v2, resnet34_v2, resnet50_v2,
                     resnet101_v2, resnet152_v2, get_resnet)
from .vgg import (VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn, get_vgg)
from .alexnet import AlexNet, alexnet
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .mobilenet import (MobileNet, mobilenet1_0, mobilenet0_75,
                        mobilenet0_5, mobilenet0_25)
from .inception import Inception3, inception_v3

from ....base import MXNetError

_models = {
    'resnet18_v1': resnet18_v1, 'resnet34_v1': resnet34_v1,
    'resnet50_v1': resnet50_v1, 'resnet101_v1': resnet101_v1,
    'resnet152_v1': resnet152_v1,
    'resnet18_v2': resnet18_v2, 'resnet34_v2': resnet34_v2,
    'resnet50_v2': resnet50_v2, 'resnet101_v2': resnet101_v2,
    'resnet152_v2': resnet152_v2,
    'vgg11': vgg11, 'vgg13': vgg13, 'vgg16': vgg16, 'vgg19': vgg19,
    'vgg11_bn': vgg11_bn, 'vgg13_bn': vgg13_bn, 'vgg16_bn': vgg16_bn,
    'vgg19_bn': vgg19_bn,
    'alexnet': alexnet,
    'densenet121': densenet121, 'densenet161': densenet161,
    'densenet169': densenet169, 'densenet201': densenet201,
    'squeezenet1.0': squeezenet1_0, 'squeezenet1.1': squeezenet1_1,
    'inceptionv3': inception_v3,
    'mobilenet1.0': mobilenet1_0, 'mobilenet0.75': mobilenet0_75,
    'mobilenet0.5': mobilenet0_5, 'mobilenet0.25': mobilenet0_25,
}


def get_model(name, **kwargs):
    """reference: model_zoo/__init__.py get_model."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(
            f"Model {name!r} is not supported. Available: "
            f"{sorted(_models)}")
    return _models[name](**kwargs)
