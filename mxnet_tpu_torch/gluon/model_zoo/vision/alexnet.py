"""Gluon AlexNet (reference:
python/mxnet/gluon/model_zoo/vision/alexnet.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``, the
same code over the port's Gluon layers, so the same construction gives
the same parameter names in both packages, but for one repair: the
output layer is created in ``features``' name scope.  The JAX package
creates it in the network's own scope, whose counter does not see the
two Dense layers of ``features`` (a scope of the same prefix), so it is
named ``alexnet0_dense0_`` twice and ``collect_params`` raises (a fault
of the reference, ROADMAP §3); here it is ``alexnet0_dense2_``."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn


class AlexNet(HybridBlock):
    """reference: vision/alexnet.py:30."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            padding=2, activation='relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            activation='relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            activation='relu'))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation='relu'))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            activation='relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation='relu'))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation='relu'))
                self.features.add(nn.Dropout(0.5))
                self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def alexnet(pretrained=False, ctx=None, root='~/.mxnet/models', **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file('alexnet', root=root), ctx=ctx)
    return net
