"""Gluon SqueezeNet (reference:
python/mxnet/gluon/model_zoo/vision/squeezenet.py).

PyTorch counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``, the
same code over the port's Gluon layers, so the same construction gives
the same parameter names in both packages."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix='')
    out.add(_make_fire_conv(squeeze_channels, 1))
    paths = _Concurrent()
    paths.add(_make_fire_conv(expand1x1_channels, 1))
    paths.add(_make_fire_conv(expand3x3_channels, 3, 1))
    out.add(paths)
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix='')
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation('relu'))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channel axis (the reference uses
    HybridConcurrent from contrib)."""

    def add(self, block):
        self.register_child(block)
        super(HybridBlock, self).__setattr__(
            f'_branch{len(self._children)-1}', block)

    def hybrid_forward(self, F, x):
        return F.Concat(*[block(x) for block in self._children], dim=1)


class SqueezeNet(HybridBlock):
    """reference: vision/squeezenet.py:55."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in ('1.0', '1.1'):
            raise MXNetError(f"Unsupported SqueezeNet version {version}")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix='')
            if version == '1.0':
                self.features.add(nn.Conv2D(96, kernel_size=7, strides=2))
                self.features.add(nn.Activation('relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(64, 256, 256))
            else:
                self.features.add(nn.Conv2D(64, kernel_size=3, strides=2))
                self.features.add(nn.Activation('relu'))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(_make_fire(16, 64, 64))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(_make_fire(32, 128, 128))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(48, 192, 192))
                self.features.add(_make_fire(64, 256, 256))
                self.features.add(_make_fire(64, 256, 256))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix='')
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation('relu'))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def squeezenet1_0(pretrained=False, ctx=None, root='~/.mxnet/models', **kwargs):
    net = SqueezeNet('1.0', **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file('squeezenet1.0', root=root), ctx=ctx)
    return net


def squeezenet1_1(pretrained=False, ctx=None, root='~/.mxnet/models', **kwargs):
    net = SqueezeNet('1.1', **kwargs)
    if pretrained:
        from ..model_store import get_model_file
        net.load_params(get_model_file('squeezenet1.1', root=root), ctx=ctx)
    return net
