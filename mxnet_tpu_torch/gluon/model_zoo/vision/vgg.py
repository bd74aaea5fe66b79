"""Gluon VGG (reference: python/mxnet/gluon/model_zoo/vision/vgg.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``, the
same code over the port's Gluon layers, so the same construction gives
the same parameter names in both packages."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError


class VGG(HybridBlock):
    """reference: vision/vgg.py:33."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation='relu',
                                       weight_initializer='normal'))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation='relu',
                                       weight_initializer='normal'))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer='normal')

    def _make_features(self, layers, filters, batch_norm):
        featurizer = nn.HybridSequential(prefix='')
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(filters[i], kernel_size=3,
                                         padding=1))
                if batch_norm:
                    featurizer.add(nn.BatchNorm())
                featurizer.add(nn.Activation('relu'))
            featurizer.add(nn.MaxPool2D(strides=2))
        return featurizer

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root='~/.mxnet/models', **kwargs):
    """reference: vision/vgg.py:82."""
    if num_layers not in vgg_spec:
        raise MXNetError(f"Invalid vgg depth {num_layers}")
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        bn = '_bn' if kwargs.get('batch_norm') else ''
        net.load_params(get_model_file(f'vgg{num_layers}{bn}', root=root), ctx=ctx)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs['batch_norm'] = True
    return get_vgg(19, **kwargs)
