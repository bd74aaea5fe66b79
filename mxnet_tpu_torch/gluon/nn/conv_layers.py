"""Gluon convolution / pooling layers.

PyTorch counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (reference:
python/mxnet/gluon/nn/conv_layers.py): the layers call the registry's
Convolution, Deconvolution, Pooling and Pad (cuDNN on the card through
``torch.nn.functional``); the layout stays NCHW.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock


def _tuple(v, n):
    if isinstance(v, (int, np.integer)):
        return (int(v),) * n
    return tuple(int(x) for x in v)


class _Conv(HybridBlock):
    """Base conv layer (reference: conv_layers.py:33 _Conv)."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', op_name='Convolution',
                 adj=None, **kwargs):
        super().__init__(**kwargs)
        self._channels = channels
        self._in_channels = in_channels
        rank = len(kernel_size)
        self._kwargs = {
            'kernel': kernel_size, 'stride': strides, 'dilate': dilation,
            'pad': padding, 'num_filter': channels, 'num_group': groups,
            'no_bias': not use_bias, 'layout': layout}
        if adj is not None:
            self._kwargs['adj'] = adj
        self._op_name = op_name
        self._act_type = activation

        with self.name_scope():
            if op_name == 'Convolution':
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + tuple(kernel_size)
            else:  # Deconvolution weight is (in, out/groups, *k)
                wshape = (in_channels if in_channels else 0,
                          channels // groups) + tuple(kernel_size)
            self.weight = self.params.get(
                'weight', shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            if use_bias:
                self.bias = self.params.get(
                    'bias', shape=(channels,), init=bias_initializer,
                    allow_deferred_init=True)
            else:
                self.bias = None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        if self._act_type:
            out = F.Activation(out, act_type=self._act_type)
        return out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout='NCW', activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout='NCHW', activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout='NCDHW', activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros',
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer, **kwargs)


class Conv1DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout='NCW',
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 1), _tuple(strides, 1),
                         _tuple(padding, 1), _tuple(dilation, 1), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name='Deconvolution',
                         adj=_tuple(output_padding, 1), **kwargs)


class Conv2DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 output_padding=(0, 0), dilation=(1, 1), groups=1,
                 layout='NCHW', activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer='zeros',
                 in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 2), _tuple(strides, 2),
                         _tuple(padding, 2), _tuple(dilation, 2), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name='Deconvolution',
                         adj=_tuple(output_padding, 2), **kwargs)


class Conv3DTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout='NCDHW',
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer='zeros', in_channels=0, **kwargs):
        super().__init__(channels, _tuple(kernel_size, 3), _tuple(strides, 3),
                         _tuple(padding, 3), _tuple(dilation, 3), groups,
                         layout, in_channels, activation, use_bias,
                         weight_initializer, bias_initializer,
                         op_name='Deconvolution',
                         adj=_tuple(output_padding, 3), **kwargs)


class _Pooling(HybridBlock):
    """Base pooling (reference: conv_layers.py _Pooling)."""

    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            'kernel': pool_size, 'stride': strides, 'pad': padding,
            'global_pool': global_pool, 'pool_type': pool_type,
            'pooling_convention': 'full' if ceil_mode else 'valid'}

    def _alias(self):
        return 'pool'

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


class MaxPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, 'max',
                         **kwargs)


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, 'max',
                         **kwargs)


class MaxPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, 'max',
                         **kwargs)


class AvgPool1D(_Pooling):
    def __init__(self, pool_size=2, strides=None, padding=0, layout='NCW',
                 ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 1),
                         _tuple(strides, 1) if strides is not None else None,
                         _tuple(padding, 1), ceil_mode, False, 'avg',
                         **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout='NCHW', ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 2),
                         _tuple(strides, 2) if strides is not None else None,
                         _tuple(padding, 2), ceil_mode, False, 'avg',
                         **kwargs)


class AvgPool3D(_Pooling):
    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 layout='NCDHW', ceil_mode=False, **kwargs):
        super().__init__(_tuple(pool_size, 3),
                         _tuple(strides, 3) if strides is not None else None,
                         _tuple(padding, 3), ceil_mode, False, 'avg',
                         **kwargs)


class GlobalMaxPool1D(_Pooling):
    def __init__(self, layout='NCW', **kwargs):
        super().__init__((1,), None, (0,), False, True, 'max', **kwargs)


class GlobalMaxPool2D(_Pooling):
    def __init__(self, layout='NCHW', **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, 'max', **kwargs)


class GlobalMaxPool3D(_Pooling):
    def __init__(self, layout='NCDHW', **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, 'max',
                         **kwargs)


class GlobalAvgPool1D(_Pooling):
    def __init__(self, layout='NCW', **kwargs):
        super().__init__((1,), None, (0,), False, True, 'avg', **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout='NCHW', **kwargs):
        super().__init__((1, 1), None, (0, 0), False, True, 'avg', **kwargs)


class GlobalAvgPool3D(_Pooling):
    def __init__(self, layout='NCDHW', **kwargs):
        super().__init__((1, 1, 1), None, (0, 0, 0), False, True, 'avg',
                         **kwargs)


class ReflectionPad2D(HybridBlock):
    """reference: conv_layers.py ReflectionPad2D (Pad op, reflect mode)."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._pad_width = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode='reflect', pad_width=self._pad_width)
