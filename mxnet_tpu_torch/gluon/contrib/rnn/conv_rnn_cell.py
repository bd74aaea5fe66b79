"""Convolutional recurrent cells for Gluon
(reference: python/mxnet/gluon/contrib/rnn/conv_rnn_cell.py:37-977).

PyTorch counterpart of ``mxnet_tpu/gluon/contrib/rnn/conv_rnn_cell.py``.

States are channel-first feature maps ((C,), (C, W), (C, H, W) or
(C, D, H, W) per sample); i2h/h2h projections are convolutions.  The h2h
convolution is stride-1 same-padded (odd kernels only), so the state shape
is constant across steps; the i2h convolution decides the state's spatial
extent from ``input_shape`` at construction, exactly like the reference's
``_decide_shapes``.  Channel-first only.
"""
from __future__ import annotations

import numpy as np

from ....base import MXNetError
from ...rnn.rnn_cell import HybridRecurrentCell


def _tup(spec, dims, name):
    if isinstance(spec, (int, np.integer)):
        return (int(spec),) * dims
    spec = tuple(int(s) for s in spec)
    if len(spec) != dims:
        raise MXNetError(
            f"{name} must be an int or length-{dims} tuple, got {spec}")
    return spec


def _conv_out_size(dimensions, kernel, pad, dilate):
    return tuple((x + 2 * p - d * (k - 1) - 1) + 1
                 for x, k, p, d in zip(dimensions, kernel, pad, dilate))


class _BaseConvRNNCell(HybridRecurrentCell):
    """Shared machinery (reference: conv_rnn_cell.py:37 _BaseConvRNNCell)."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad, i2h_dilate, h2h_dilate, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, dims, conv_layout, activation,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if conv_layout not in ('NCW', 'NCHW', 'NCDHW')[dims - 1:dims]:
            raise MXNetError(
                f"conv_layout must be channel-first for {dims}D "
                f"(got {conv_layout!r})")
        self._hidden_channels = hidden_channels
        self._input_shape = tuple(input_shape)
        self._conv_layout = conv_layout
        self._activation = activation
        self._i2h_kernel = _tup(i2h_kernel, dims, 'i2h_kernel')
        self._i2h_pad = _tup(i2h_pad, dims, 'i2h_pad')
        self._i2h_dilate = _tup(i2h_dilate, dims, 'i2h_dilate')
        self._h2h_kernel = _tup(h2h_kernel, dims, 'h2h_kernel')
        if any(k % 2 == 0 for k in self._h2h_kernel):
            raise MXNetError(
                f"h2h_kernel must be odd, got {self._h2h_kernel}")
        self._h2h_dilate = _tup(h2h_dilate, dims, 'h2h_dilate')
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        self._stride = (1,) * dims

        in_channels = self._input_shape[0]
        spatial = self._input_shape[1:]
        out_spatial = _conv_out_size(spatial, self._i2h_kernel,
                                     self._i2h_pad, self._i2h_dilate)
        total = hidden_channels * self._num_gates
        self._state_shape = (hidden_channels,) + out_spatial
        self.i2h_weight = self.params.get(
            'i2h_weight', shape=(total, in_channels) + self._i2h_kernel,
            init=i2h_weight_initializer)
        self.h2h_weight = self.params.get(
            'h2h_weight', shape=(total, hidden_channels) + self._h2h_kernel,
            init=h2h_weight_initializer)
        self.i2h_bias = self.params.get(
            'i2h_bias', shape=(total,), init=i2h_bias_initializer)
        self.h2h_bias = self.params.get(
            'h2h_bias', shape=(total,), init=h2h_bias_initializer)

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size,) + self._state_shape,
                 '__layout__': self._conv_layout}
                for _ in range(self._num_states)]

    def _conv_forward(self, F, inputs, states,
                      i2h_weight, h2h_weight, i2h_bias, h2h_bias):
        i2h = F.Convolution(inputs, i2h_weight, i2h_bias,
                            kernel=self._i2h_kernel, stride=self._stride,
                            pad=self._i2h_pad, dilate=self._i2h_dilate,
                            num_filter=self._hidden_channels
                            * self._num_gates)
        h2h = F.Convolution(states[0], h2h_weight, h2h_bias,
                            kernel=self._h2h_kernel, stride=self._stride,
                            pad=self._h2h_pad, dilate=self._h2h_dilate,
                            num_filter=self._hidden_channels
                            * self._num_gates)
        return i2h, h2h

    def __repr__(self):
        return (f'{self.__class__.__name__}'
                f'({self._input_shape} -> {self._state_shape})')


class _ConvRNNCell(_BaseConvRNNCell):
    """reference: conv_rnn_cell.py:176."""

    _num_states = 1

    @property
    def _gate_names(self):
        return ('',)

    def _alias(self):
        return 'conv_rnn'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class _ConvLSTMCell(_BaseConvRNNCell):
    """reference: conv_rnn_cell.py:419 (Shi et al. 2015)."""

    _num_states = 2

    @property
    def _gate_names(self):
        return ('_i', '_f', '_c', '_o')

    def _alias(self):
        return 'conv_lstm'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        gates = i2h + h2h
        sl = list(F.SliceChannel(gates, num_outputs=4, axis=1))
        in_gate = F.Activation(sl[0], act_type='sigmoid')
        forget_gate = F.Activation(sl[1], act_type='sigmoid')
        in_transform = self._get_activation(F, sl[2], self._activation)
        out_gate = F.Activation(sl[3], act_type='sigmoid')
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * self._get_activation(F, next_c, self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUCell(_BaseConvRNNCell):
    """reference: conv_rnn_cell.py:703."""

    _num_states = 1

    @property
    def _gate_names(self):
        return ('_r', '_z', '_o')

    def _alias(self):
        return 'conv_gru'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = self._conv_forward(F, inputs, states, i2h_weight,
                                      h2h_weight, i2h_bias, h2h_bias)
        i2h_sl = list(F.SliceChannel(i2h, num_outputs=3, axis=1))
        h2h_sl = list(F.SliceChannel(h2h, num_outputs=3, axis=1))
        reset_gate = F.Activation(i2h_sl[0] + h2h_sl[0], act_type='sigmoid')
        update_gate = F.Activation(i2h_sl[1] + h2h_sl[1], act_type='sigmoid')
        next_h_tmp = self._get_activation(
            F, i2h_sl[2] + reset_gate * h2h_sl[2], self._activation)
        next_h = (1. - update_gate) * next_h_tmp + update_gate * states[0]
        return next_h, [next_h]


def _make_cell(base, dims, layout, doc_dims):
    class Cell(base):
        __doc__ = (f"{doc_dims}D convolutional "
                   f"{base.__name__.strip('_').replace('Conv', '')} cell "
                   f"(reference: gluon/contrib/rnn/conv_rnn_cell.py).")

        def __init__(self, input_shape, hidden_channels, i2h_kernel,
                     h2h_kernel, i2h_pad=0, i2h_dilate=1, h2h_dilate=1,
                     i2h_weight_initializer=None,
                     h2h_weight_initializer=None,
                     i2h_bias_initializer='zeros',
                     h2h_bias_initializer='zeros',
                     conv_layout=layout, activation='tanh',
                     prefix=None, params=None):
            super().__init__(input_shape, hidden_channels, i2h_kernel,
                             h2h_kernel, i2h_pad, i2h_dilate, h2h_dilate,
                             i2h_weight_initializer,
                             h2h_weight_initializer, i2h_bias_initializer,
                             h2h_bias_initializer, dims, conv_layout,
                             activation, prefix=prefix, params=params)
    return Cell


Conv1DRNNCell = _make_cell(_ConvRNNCell, 1, 'NCW', 1)
Conv2DRNNCell = _make_cell(_ConvRNNCell, 2, 'NCHW', 2)
Conv3DRNNCell = _make_cell(_ConvRNNCell, 3, 'NCDHW', 3)
Conv1DLSTMCell = _make_cell(_ConvLSTMCell, 1, 'NCW', 1)
Conv2DLSTMCell = _make_cell(_ConvLSTMCell, 2, 'NCHW', 2)
Conv3DLSTMCell = _make_cell(_ConvLSTMCell, 3, 'NCDHW', 3)
Conv1DGRUCell = _make_cell(_ConvGRUCell, 1, 'NCW', 1)
Conv2DGRUCell = _make_cell(_ConvGRUCell, 2, 'NCHW', 2)
Conv3DGRUCell = _make_cell(_ConvGRUCell, 3, 'NCDHW', 3)
for _c, _n in [(Conv1DRNNCell, 'Conv1DRNNCell'),
               (Conv2DRNNCell, 'Conv2DRNNCell'),
               (Conv3DRNNCell, 'Conv3DRNNCell'),
               (Conv1DLSTMCell, 'Conv1DLSTMCell'),
               (Conv2DLSTMCell, 'Conv2DLSTMCell'),
               (Conv3DLSTMCell, 'Conv3DLSTMCell'),
               (Conv1DGRUCell, 'Conv1DGRUCell'),
               (Conv2DGRUCell, 'Conv2DGRUCell'),
               (Conv3DGRUCell, 'Conv3DGRUCell')]:
    _c.__name__ = _c.__qualname__ = _n
