"""Gluon fused RNN layers (reference: python/mxnet/gluon/rnn/rnn_layer.py).

PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_layer.py``: RNN / LSTM
/ GRU HybridBlocks emitting the single fused ``RNN`` op (ops/rnn.py:
cuDNN's RNN on the card).  Weights are kept per layer and direction as
separate Parameters (the reference's i2h/h2h naming) and packed into the
op's flat vector at every call (one ``Concat``), which the op then hands
to cuDNN as views.
"""
from __future__ import annotations

import functools

from ..block import HybridBlock


class _RNNLayer(HybridBlock):
    """reference: rnn_layer.py:33."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ('TNC', 'NTC'), \
            f"Invalid layout {layout}; must be one of ['TNC' or 'NTC']"
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._i2h_weight_initializer = i2h_weight_initializer
        self._h2h_weight_initializer = h2h_weight_initializer
        self._i2h_bias_initializer = i2h_bias_initializer
        self._h2h_bias_initializer = h2h_bias_initializer

        self._gates = {'rnn_relu': 1, 'rnn_tanh': 1, 'lstm': 4,
                       'gru': 3}[mode]

        ng, ni, nh = self._gates, input_size, hidden_size
        for i in range(num_layers):
            for j in (['l', 'r'] if self._dir == 2 else ['l']):
                self._register_param(
                    f'{j}{i}_i2h_weight', shape=(ng * nh, ni),
                    init=i2h_weight_initializer)
                self._register_param(
                    f'{j}{i}_h2h_weight', shape=(ng * nh, nh),
                    init=h2h_weight_initializer)
                self._register_param(
                    f'{j}{i}_i2h_bias', shape=(ng * nh,),
                    init=i2h_bias_initializer)
                self._register_param(
                    f'{j}{i}_h2h_bias', shape=(ng * nh,),
                    init=h2h_bias_initializer)
            ni = nh * self._dir

    def _register_param(self, name, shape, init):
        p = self.params.get(name, shape=shape, init=init,
                            allow_deferred_init=True)
        setattr(self, name, p)

    def __repr__(self):
        s = '{name}({mapping}, {_layout}'
        if self._num_layers != 1:
            s += ', num_layers={_num_layers}'
        if self._dropout != 0:
            s += ', dropout={_dropout}'
        if self._dir == 2:
            s += ', bidirectional'
        s += ')'
        mapping = f'{self._input_size or None} -> {self._hidden_size}'
        return s.format(name=self.__class__.__name__, mapping=mapping,
                        **self.__dict__)

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """Initial recurrent state (reference: rnn_layer.py:147)."""
        from ... import ndarray as nd_mod
        if func is None:
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            if info is not None:
                info = dict(info, **kwargs)
            else:
                info = kwargs
            info.pop('__layout__', None)
            states.append(func(shape=info.pop('shape'), **info))
        return states

    def forward(self, inputs, *states):
        """Finish deferred weight init from the eager input's feature dim
        (the packing Concat defeats graph back-fill — reference
        rnn_layer.py similarly resolves input_size in forward), then
        dispatch.  ``states`` is one list (the user's call) or the
        states one by one (a hybridized parent's trace); they go to the
        HybridBlock as positional inputs."""
        from ...ndarray import NDArray
        if isinstance(inputs, NDArray):
            self._finish_deferred(inputs.shape)
        if len(states) == 1 and isinstance(states[0], (list, tuple)):
            states = tuple(states[0])
        states = tuple(s for s in states if s is not None)
        if not states:
            return super().forward(inputs)
        out = super().forward(inputs, *states)
        # (output, h[, c]) comes back flattened from the graph
        if isinstance(out, (list, tuple)):
            return out[0], list(out[1:])
        return out

    def _finish_deferred(self, in_shape):
        ni = in_shape[2]  # feature dim is last in both TNC and NTC
        ng, nh = self._gates, self._hidden_size
        dirs = ['l', 'r'] if self._dir == 2 else ['l']
        for i in range(self._num_layers):
            for j in dirs:
                for suffix, shape in (
                        ('i2h_weight', (ng * nh, ni)),
                        ('h2h_weight', (ng * nh, nh)),
                        ('i2h_bias', (ng * nh,)),
                        ('h2h_bias', (ng * nh,))):
                    p = getattr(self, f'{j}{i}_{suffix}')
                    if p._deferred_init is not None:
                        p._finish_deferred_init(shape)
                    elif p.shape and any(s == 0 for s in p.shape):
                        p.shape = shape
            ni = nh * self._dir

    def hybrid_forward(self, F, inputs, *states, **params):
        """Emit the fused RNN op; returns output [or output + states]."""
        states = [s for s in states if s is not None]
        skip_states = not states

        # pack per-gate params into the flat vector the op consumes
        parameters = self._pack(F, params)

        if self._layout == 'NTC':
            inputs = F.SwapAxis(inputs, dim1=0, dim2=1)
        if skip_states:
            b = self._num_layers * self._dir
            H = self._hidden_size
            from ...ndarray import NDArray
            zeros = functools.partial(F.zeros, ctx=inputs.context) \
                if isinstance(inputs, NDArray) else F.zeros
            state_args = {'state': zeros((b, 1, H))}
            if self._mode == 'lstm':
                state_args['state_cell'] = zeros((b, 1, H))
        else:
            state_args = {'state': states[0]}
            if self._mode == 'lstm':
                state_args['state_cell'] = states[1]
        rnn = F.RNN(inputs, parameters, state_size=self._hidden_size,
                    num_layers=self._num_layers,
                    bidirectional=self._dir == 2, p=self._dropout,
                    state_outputs=not skip_states, mode=self._mode,
                    **state_args)
        if skip_states:
            outputs = rnn if not isinstance(rnn, (list, tuple)) else rnn[0]
            out_states = []
        else:
            outs = list(rnn)
            outputs = outs[0]
            out_states = outs[1:]
        if self._layout == 'NTC':
            outputs = F.SwapAxis(outputs, dim1=0, dim2=1)
        if skip_states:
            return outputs
        return tuple([outputs] + list(out_states))

    def _pack(self, F, params):
        """Concatenate i2h/h2h weights and biases into the op's flat
        vector (ops/rnn.py header)."""
        dirs = ['l', 'r'] if self._dir == 2 else ['l']
        chunks = []
        for i in range(self._num_layers):
            for j in dirs:
                chunks.append(F.Reshape(
                    params[f'{j}{i}_i2h_weight'], shape=(-1,)))
                chunks.append(F.Reshape(
                    params[f'{j}{i}_h2h_weight'], shape=(-1,)))
        for i in range(self._num_layers):
            for j in dirs:
                chunks.append(params[f'{j}{i}_i2h_bias'])
                chunks.append(params[f'{j}{i}_h2h_bias'])
        return F.Concat(*chunks, dim=0)


class RNN(_RNNLayer):
    """Vanilla multi-layer RNN (reference: rnn_layer.py:190)."""

    def __init__(self, hidden_size, num_layers=1, activation='relu',
                 layout='TNC', dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'rnn_' + activation, **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class LSTM(_RNNLayer):
    """Multi-layer LSTM (reference: rnn_layer.py:284)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'lstm', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'},
                {'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]


class GRU(_RNNLayer):
    """Multi-layer GRU (reference: rnn_layer.py:388)."""

    def __init__(self, hidden_size, num_layers=1, layout='TNC', dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size,
                         i2h_weight_initializer, h2h_weight_initializer,
                         i2h_bias_initializer, h2h_bias_initializer,
                         'gru', **kwargs)

    def state_info(self, batch_size=0):
        return [{'shape': (self._num_layers * self._dir, batch_size,
                           self._hidden_size), '__layout__': 'LNC'}]
