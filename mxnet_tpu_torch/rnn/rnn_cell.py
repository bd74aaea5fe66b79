"""Symbolic RNN cells (reference: python/mxnet/rnn/rnn_cell.py:108-1176).

PyTorch counterpart of ``mxnet_tpu/rnn/rnn_cell.py``; the cells build
Symbols only, so the code is the JAX package's over the port's
``symbol``.  Unfused cells build per-step graph nodes composed by
``unroll``; the ``FusedRNNCell`` emits the single fused ``RNN`` op
(ops/rnn.py: cuDNN's RNN on the card).

Compatibility contract, deliberately preserved from the reference API:
parameter names (``{prefix}i2h_weight`` …), prefixes, gate order
([i, f, c, o] for LSTM, [r, z, o] for GRU), state_info layouts, and the
packed-parameter memory layout — these are what make reference
checkpoints load and ``pack/unpack_weights`` round-trip.  Within that
contract the cell bodies are organized around shared building blocks:
``_fc_forward`` (both per-step projections with every gate batched into
one matmul), and the ``_lstm_step``/``_gru_step``
recurrences shared by the dense AND convolutional cell variants.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..base import MXNetError
from .. import symbol as sym_mod
from ..ops.rnn import rnn_param_size


class RNNParams:
    """Container for cell parameters (reference: rnn_cell.py:36)."""

    def __init__(self, prefix=''):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym_mod.Variable(name, **kwargs)
        return self._params[name]


class BaseRNNCell:
    """reference: rnn_cell.py:108."""

    def __init__(self, prefix='', params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele['shape'] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    @property
    def _num_gates(self):
        return len(self._gate_names)

    def begin_state(self, func=sym_mod.zeros, **kwargs):
        """reference: rnn_cell.py:166."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called"
        states = []
        for info in self.state_info:
            self._init_counter += 1
            if info is not None:
                info = dict(info, **kwargs)
            else:
                info = kwargs
            if 'shape' in info:
                # 0 = unknown dim (MXNet shape convention): materialize as
                # 1 — a zero state broadcasts over the batch identically
                # (ops/rnn.py broadcasts fused-op states the same way)
                info['shape'] = tuple(1 if s == 0 else s
                                      for s in info['shape'])
            state = func(name=f'{self._prefix}begin_state_'
                              f'{self._init_counter}', **info)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """Split packed gate weights into per-gate arrays
        (reference: rnn_cell.py:199)."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ['i2h', 'h2h']:
            weight = args.pop(f'{self._prefix}{group_name}_weight')
            bias = args.pop(f'{self._prefix}{group_name}_bias')
            for j, gate in enumerate(self._gate_names):
                wname = f'{self._prefix}{group_name}{gate}_weight'
                args[wname] = weight[j * h: (j + 1) * h].copy()
                bname = f'{self._prefix}{group_name}{gate}_bias'
                args[bname] = bias[j * h: (j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """reference: rnn_cell.py:226."""
        from ..ndarray.ndarray import concatenate
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ['i2h', 'h2h']:
            weight = []
            bias = []
            for gate in self._gate_names:
                weight.append(args.pop(
                    f'{self._prefix}{group_name}{gate}_weight'))
                bias.append(args.pop(
                    f'{self._prefix}{group_name}{gate}_bias'))
            args[f'{self._prefix}{group_name}_weight'] = \
                concatenate(weight, axis=0)
            args[f'{self._prefix}{group_name}_bias'] = \
                concatenate(bias, axis=0)
        return args

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """reference: rnn_cell.py:253."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    # -- helpers ------------------------------------------------------------
    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return sym_mod.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def _fc_forward(self, inputs, prev_h, name):
        """The step's two projections (input and recurrent) with ALL
        gates batched into one matmul each — the shape every dense cell
        shares; cells differ only in how they combine the slices
        (conv cells: the analogous ``_conv_forward``)."""
        i2h = sym_mod.FullyConnected(
            data=inputs, weight=self._iW, bias=self._iB,
            num_hidden=self._num_hidden * self._num_gates,
            name=f'{name}i2h')
        h2h = sym_mod.FullyConnected(
            data=prev_h, weight=self._hW, bias=self._hB,
            num_hidden=self._num_hidden * self._num_gates,
            name=f'{name}h2h')
        return i2h, h2h


def _sigmoid(x):
    return sym_mod.Activation(x, act_type='sigmoid')


def _lstm_step(gates, prev_c, act, name):
    """The LSTM recurrence over summed pre-activation gates, shared by
    LSTMCell and ConvLSTMCell.  Gate order [i, f, c, o] is the fused-op /
    pack_weights contract; ``act`` is the candidate/output nonlinearity
    (tanh for dense cells, the configured activation for conv cells)."""
    sl = list(sym_mod.SliceChannel(gates, num_outputs=4, axis=1,
                                   name=f'{name}slice'))
    in_gate, forget_gate = _sigmoid(sl[0]), _sigmoid(sl[1])
    in_transform = act(sl[2], name=f'{name}c')
    out_gate = _sigmoid(sl[3])
    next_c = forget_gate * prev_c + in_gate * in_transform
    next_h = out_gate * act(next_c, name=f'{name}out')
    return next_h, next_c


def _gru_step(i2h, h2h, prev_h, act, name):
    """The GRU recurrence over the two projection outputs, shared by
    GRUCell and ConvGRUCell.  Gate order [r, z, o]; the candidate mixes
    the reset-gated recurrent slice before ``act``."""
    i2h_r, i2h_z, i2h_o = list(sym_mod.SliceChannel(
        i2h, num_outputs=3, axis=1, name=f'{name}i2h_slice'))
    h2h_r, h2h_z, h2h_o = list(sym_mod.SliceChannel(
        h2h, num_outputs=3, axis=1, name=f'{name}h2h_slice'))
    reset_gate = _sigmoid(i2h_r + h2h_r)
    update_gate = _sigmoid(i2h_z + h2h_z)
    next_h_tmp = act(i2h_o + reset_gate * h2h_o, name=f'{name}h_act')
    return update_gate * prev_h + (1.0 - update_gate) * next_h_tmp


def _tanh(x, name=None):
    return sym_mod.Activation(x, act_type='tanh', name=name)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """reference: rnn_cell.py:46 _normalize_sequence."""
    assert inputs is not None
    axis = layout.find('T')
    in_axis = in_layout.find('T') if in_layout is not None else axis
    if isinstance(inputs, sym_mod.Symbol):
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise MXNetError(
                    "unroll doesn't allow grouped symbol as input. ")
            inputs = list(sym_mod.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
    else:
        if merge is True:
            inputs = [sym_mod.expand_dims(i, axis=axis) for i in inputs]
            inputs = sym_mod.Concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, sym_mod.Symbol) and axis != in_axis:
        inputs = sym_mod.SwapAxis(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell (reference: rnn_cell.py:330)."""

    def __init__(self, num_hidden, activation='tanh', prefix='rnn_',
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._fc_forward(inputs, states[0], name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name=f'{name}out')
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (reference: rnn_cell.py:389); gate order [i, f, g, o]
    matches the fused op."""

    def __init__(self, num_hidden, prefix='lstm_', params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._hW = self.params.get('h2h_weight')
        from ..initializer import LSTMBias
        self._iB = self.params.get(
            'i2h_bias', init=LSTMBias(forget_bias=forget_bias))
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'},
                {'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_i', '_f', '_c', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._fc_forward(inputs, states[0], name)
        next_h, next_c = _lstm_step(i2h + h2h, states[1], _tanh, name)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (reference: rnn_cell.py:461); gate order [r, z, n]."""

    def __init__(self, num_hidden, prefix='gru_', params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get('i2h_weight')
        self._iB = self.params.get('i2h_bias')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')

    @property
    def state_info(self):
        return [{'shape': (0, self._num_hidden), '__layout__': 'NC'}]

    @property
    def _gate_names(self):
        return ['_r', '_z', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._fc_forward(inputs, states[0], name)
        next_h = _gru_step(i2h, h2h, states[0], _tanh, name)
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Fused multi-layer RNN (reference: rnn_cell.py:536) → single `RNN`
    op (ops/rnn.py: cuDNN's RNN on the card)."""

    def __init__(self, num_hidden, num_layers=1, mode='lstm',
                 bidirectional=False, dropout=0., get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = f'{mode}_'
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._directions = ['l', 'r'] if bidirectional else ['l']
        from ..initializer import FusedRNN as _FusedRNNInit
        self._parameter = self.params.get(
            'parameters',
            init=_FusedRNNInit(None, num_hidden, num_layers, mode,
                               bidirectional, forget_bias))

    @property
    def state_info(self):
        b = self._num_layers * (2 if self._bidirectional else 1)
        n = 2 if self._mode == 'lstm' else 1
        return [{'shape': (b, 0, self._num_hidden), '__layout__': 'LNC'}
                for _ in range(n)]

    @property
    def _gate_names(self):
        return {'rnn_relu': [''], 'rnn_tanh': [''],
                'lstm': ['_i', '_f', '_c', '_o'],
                'gru': ['_r', '_z', '_o']}[self._mode]

    def _slice_weights(self, arr, li, lh):
        """Map the flat vector (an NDArray) to per-gate pieces by name
        (reference: rnn_cell.py:595)."""
        args = {}
        gate_names = self._gate_names
        directions = self._directions
        b = len(directions)
        p = 0
        for layer in range(self._num_layers):
            for direction in directions:
                for gate in gate_names:
                    name = f'{self._prefix}{direction}{layer}_i2h' \
                           f'{gate}_weight'
                    size = (li if layer == 0 else lh * b) * lh
                    args[name] = arr[p:p + size].reshape(
                        (lh, li if layer == 0 else lh * b))
                    p += size
                for gate in gate_names:
                    name = f'{self._prefix}{direction}{layer}_h2h' \
                           f'{gate}_weight'
                    size = lh ** 2
                    args[name] = arr[p:p + size].reshape((lh, lh))
                    p += size
        for layer in range(self._num_layers):
            for direction in directions:
                for group in ['i2h', 'h2h']:
                    for gate in gate_names:
                        name = f'{self._prefix}{direction}{layer}_' \
                               f'{group}{gate}_bias'
                        args[name] = arr[p:p + lh]
                        p += lh
        assert p == arr.size, "Invalid parameters size for FusedRNNCell"
        return args

    def unpack_weights(self, args):
        args = dict(args)
        arr = args.pop(self._parameter.name)
        b = len(self._directions)
        m = self._num_gates
        h = self._num_hidden
        num_input = arr.size // b // h // m - \
            (self._num_layers - 1) * (h + b * h + 2) - h - 2
        nargs = self._slice_weights(arr, num_input, h)
        args.update({name: nd.copy() for name, nd in nargs.items()})
        return args

    def pack_weights(self, args):
        """The per-gate pieces concatenated into the flat vector, in the
        order of :meth:`_slice_weights`, on the first piece's device and
        in its dtype."""
        import torch
        from ..ndarray.ndarray import NDArray as _ND
        args = dict(args)
        w0 = args[f'{self._prefix}l0_i2h'
                  f'{self._gate_names[0]}_weight']
        num_input = w0.shape[1]
        total = rnn_param_size(self._num_layers, num_input,
                               self._num_hidden, self._bidirectional,
                               self._mode)
        names = self._slice_weights(np.empty((total,), np.float32),
                                    num_input, self._num_hidden)
        ref = _ND(w0)._data
        pieces = [_ND(args.pop(name))._data.to(ref.device, ref.dtype)
                  .reshape(-1) for name in names]
        args[self._parameter.name] = _ND(torch.cat(pieces))
        return args

    def __call__(self, inputs, states):
        raise MXNetError(
            "FusedRNNCell cannot be stepped. Please use unroll")

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """reference: rnn_cell.py:686 — emits ONE `RNN` node."""
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            inputs = sym_mod.SwapAxis(inputs, dim1=0, dim2=1)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        if self._mode == 'lstm':
            states = {'state': states[0], 'state_cell': states[1]}
        else:
            states = {'state': states[0]}
        rnn = sym_mod.RNN(data=inputs, parameters=self._parameter,
                          state_size=self._num_hidden,
                          num_layers=self._num_layers,
                          bidirectional=self._bidirectional,
                          p=self._dropout,
                          state_outputs=self._get_next_state,
                          mode=self._mode, name=f'{self._prefix}rnn',
                          **states)
        if not self._get_next_state:
            outputs, states = rnn, []
        elif self._mode == 'lstm':
            outs = list(rnn)
            outputs, states = outs[0], [outs[1], outs[2]]
        else:
            outs = list(rnn)
            outputs, states = outs[0], [outs[1]]
        if axis == 1:
            outputs = sym_mod.SwapAxis(outputs, dim1=0, dim2=1)
        if merge_outputs is False:
            outputs = list(sym_mod.SliceChannel(
                outputs, axis=0 if axis == 0 else 1, num_outputs=length,
                squeeze_axis=1))
        return outputs, states

    def unfuse(self):
        """Equivalent stack of unfused cells (reference: rnn_cell.py:757)."""
        stack = SequentialRNNCell()
        get_cell = {
            'rnn_relu': lambda p: RNNCell(self._num_hidden,
                                          activation='relu', prefix=p),
            'rnn_tanh': lambda p: RNNCell(self._num_hidden,
                                          activation='tanh', prefix=p),
            'lstm': lambda p: LSTMCell(self._num_hidden, prefix=p),
            'gru': lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell(f'{self._prefix}l{i}_'),
                    get_cell(f'{self._prefix}r{i}_'),
                    output_prefix=f'{self._prefix}bi_l{i}_'))
            else:
                stack.add(get_cell(f'{self._prefix}l{i}_'))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix=f'{self._prefix}_dropout{i}_'))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (reference: rnn_cell.py:793)."""

    def __init__(self, params=None):
        super().__init__(prefix='', params=params)
        self._override_cell_params = params is not None
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            assert cell._own_params
            cell.params._params.update(self.params._params)
        self.params._params.update(cell.params._params)

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unpack_weights(self, args):
        for cell in self._cells:
            args = cell.unpack_weights(args)
        return args

    def pack_weights(self, args):
        for cell in self._cells:
            args = cell.pack_weights(args)
        return args

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        if begin_state is None:
            begin_state = self.begin_state()
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class BidirectionalCell(BaseRNNCell):
    """reference: rnn_cell.py:857."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix='bi_'):
        super().__init__('', params=params)
        self._output_prefix = output_prefix
        self._override_cell_params = params is not None
        if self._override_cell_params:
            assert l_cell._own_params and r_cell._own_params
            l_cell.params._params.update(self.params._params)
            r_cell.params._params.update(self.params._params)
        self.params._params.update(l_cell.params._params)
        self.params._params.update(r_cell.params._params)
        self._cells = [l_cell, r_cell]

    def unpack_weights(self, args):
        return _cells_unpack_weights(self._cells, args)

    def pack_weights(self, args):
        return _cells_pack_weights(self._cells, args)

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll")

    @property
    def state_info(self):
        return _cells_state_info(self._cells)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._cells, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        if begin_state is None:
            begin_state = self.begin_state()
        states = begin_state
        l_cell, r_cell = self._cells
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info)],
            layout=layout, merge_outputs=merge_outputs)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info):],
            layout=layout, merge_outputs=merge_outputs)
        if merge_outputs is None:
            merge_outputs = isinstance(l_outputs, sym_mod.Symbol) and \
                isinstance(r_outputs, sym_mod.Symbol)
            if not merge_outputs:
                if isinstance(l_outputs, sym_mod.Symbol):
                    l_outputs = list(sym_mod.SliceChannel(
                        l_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
                if isinstance(r_outputs, sym_mod.Symbol):
                    r_outputs = list(sym_mod.SliceChannel(
                        r_outputs, axis=axis, num_outputs=length,
                        squeeze_axis=1))
        if merge_outputs:
            reversed_r = sym_mod.SequenceReverse(r_outputs) if axis == 0 \
                else sym_mod.SwapAxis(sym_mod.SequenceReverse(
                    sym_mod.SwapAxis(r_outputs, dim1=0, dim2=1)),
                    dim1=0, dim2=1)
            outputs = sym_mod.Concat(l_outputs, reversed_r, dim=2,
                                     name=f'{self._output_prefix}out')
        else:
            outputs = [
                sym_mod.Concat(l_o, r_o, dim=1,
                               name=f'{self._output_prefix}t{i}')
                for i, (l_o, r_o) in enumerate(
                    zip(l_outputs, reversed(r_outputs)))]
        states = l_states + r_states
        return outputs, states


class ModifierCell(BaseRNNCell):
    """Base for cells wrapping another cell (reference: rnn_cell.py:944)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=sym_mod.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def unpack_weights(self, args):
        return self.base_cell.unpack_weights(args)

    def pack_weights(self, args):
        return self.base_cell.pack_weights(args)


class DropoutCell(BaseRNNCell):
    """reference: rnn_cell.py:920."""

    def __init__(self, dropout, prefix='dropout_', params=None):
        super().__init__(prefix, params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = sym_mod.Dropout(data=inputs, p=self.dropout)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """reference: rnn_cell.py:1004."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, FusedRNNCell), \
            "FusedRNNCell doesn't support zoneout. Use unfuse() first."
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout since it doesn't " \
            "support step. Please add ZoneoutCell to the cells underneath."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def reset(self):
        super().reset()
        self.prev_output = None

    def __call__(self, inputs, states):
        cell, p_outputs, p_states = (
            self.base_cell, self.zoneout_outputs, self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return sym_mod.Dropout(sym_mod.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else sym_mod.zeros_like(next_output)
        output = sym_mod.where(mask(p_outputs, next_output), next_output,
                               prev_output) if p_outputs != 0. \
            else next_output
        states = [sym_mod.where(mask(p_states, new_s), new_s, old_s)
                  for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """reference: rnn_cell.py:1055."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = sym_mod.elemwise_add(output, inputs,
                                      name=f'{output.name}_plus_residual')
        return output, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        merge_outputs = isinstance(outputs, sym_mod.Symbol) \
            if merge_outputs is None else merge_outputs
        inputs, _ = _normalize_sequence(length, inputs, layout,
                                        merge_outputs)
        if merge_outputs:
            outputs = sym_mod.elemwise_add(outputs, inputs)
        else:
            outputs = [sym_mod.elemwise_add(out, inp)
                       for out, inp in zip(outputs, inputs)]
        return outputs, states


def _cells_state_info(cells):
    return sum([c.state_info for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _cells_unpack_weights(cells, args):
    for cell in cells:
        args = cell.unpack_weights(args)
    return args


def _cells_pack_weights(cells, args):
    for cell in cells:
        args = cell.pack_weights(args)
    return args


# ---------------------------------------------------------------------------
# Convolutional RNN cells (reference: rnn_cell.py:1090-1425 —
# BaseConvRNNCell / ConvRNNCell / ConvLSTMCell / ConvGRUCell).
# States are NCHW feature maps; i2h/h2h are convolutions instead of
# FullyConnected.  NCHW only (the Convolution op's native layout here).
# ---------------------------------------------------------------------------
class BaseConvRNNCell(BaseRNNCell):
    """Shared conv-cell machinery (reference: rnn_cell.py:1090)."""

    def __init__(self, input_shape, num_hidden,
                 h2h_kernel=(3, 3), h2h_dilate=(1, 1),
                 i2h_kernel=(3, 3), i2h_stride=(1, 1),
                 i2h_pad=(1, 1), i2h_dilate=(1, 1),
                 activation='tanh', prefix='', params=None,
                 conv_layout='NCHW'):
        super().__init__(prefix=prefix, params=params)
        if conv_layout != 'NCHW':
            raise MXNetError("conv RNN cells support NCHW only")
        if h2h_kernel[0] % 2 == 0 or h2h_kernel[1] % 2 == 0:
            raise MXNetError(
                f"h2h_kernel must be odd, got {h2h_kernel}")
        self._h2h_kernel = tuple(h2h_kernel)
        self._h2h_dilate = tuple(h2h_dilate)
        self._h2h_pad = (h2h_dilate[0] * (h2h_kernel[0] - 1) // 2,
                         h2h_dilate[1] * (h2h_kernel[1] - 1) // 2)
        self._i2h_kernel = tuple(i2h_kernel)
        self._i2h_stride = tuple(i2h_stride)
        self._i2h_pad = tuple(i2h_pad)
        self._i2h_dilate = tuple(i2h_dilate)
        self._num_hidden = num_hidden
        self._input_shape = tuple(input_shape)
        self._activation = activation

        # infer the (0, C, H, W) state shape from one probe convolution
        probe = sym_mod.Convolution(
            data=sym_mod.Variable(f'{self._prefix}probe'),
            num_filter=num_hidden, kernel=self._i2h_kernel,
            stride=self._i2h_stride, pad=self._i2h_pad,
            dilate=self._i2h_dilate, no_bias=True)
        _, out_shapes, _ = probe.infer_shape(
            **{f'{self._prefix}probe': self._input_shape})
        self._state_shape = (0,) + tuple(out_shapes[0][1:])

        self._iW = self.params.get('i2h_weight')
        self._hW = self.params.get('h2h_weight')
        self._hB = self.params.get('h2h_bias')
        # _iB is fetched lazily so ConvLSTMCell can attach its forget-bias
        # initializer before the Variable is created (params.get caches)

    @property
    def _iB_var(self):
        return self.params.get('i2h_bias')

    @property
    def state_info(self):
        return [{'shape': self._state_shape, '__layout__': 'NCHW'},
                {'shape': self._state_shape, '__layout__': 'NCHW'}]

    def _act(self, x, name):
        # reference conv cells default to LeakyReLU(slope=0.2)
        # (rnn_cell.py:1224 functools.partial(symbol.LeakyReLU, ...))
        if self._activation == 'leaky':
            return sym_mod.LeakyReLU(x, act_type='leaky', slope=0.2,
                                     name=name)
        return self._get_activation(x, self._activation, name=name)

    def _conv_forward(self, inputs, states, name):
        i2h = sym_mod.Convolution(
            data=inputs, weight=self._iW, bias=self._iB_var,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._i2h_kernel, stride=self._i2h_stride,
            pad=self._i2h_pad, dilate=self._i2h_dilate,
            name=f'{name}i2h')
        h2h = sym_mod.Convolution(
            data=states[0], weight=self._hW, bias=self._hB,
            num_filter=self._num_hidden * self._num_gates,
            kernel=self._h2h_kernel, stride=(1, 1),
            pad=self._h2h_pad, dilate=self._h2h_dilate,
            name=f'{name}h2h')
        return i2h, h2h


class ConvRNNCell(BaseConvRNNCell):
    """Vanilla convolutional RNN (reference: rnn_cell.py:1176)."""

    def __init__(self, input_shape, num_hidden, activation='leaky',
                 prefix='ConvRNN_', **kwargs):
        super().__init__(input_shape, num_hidden, activation=activation,
                         prefix=prefix, **kwargs)

    @property
    def state_info(self):
        return [{'shape': self._state_shape, '__layout__': 'NCHW'}]

    @property
    def _gate_names(self):
        return ('',)

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._conv_forward(inputs, states, name)
        output = self._act(i2h + h2h, name=f'{name}out')
        return output, [output]


class ConvLSTMCell(BaseConvRNNCell):
    """Convolutional LSTM (reference: rnn_cell.py:1253; Shi et al. 2015
    "Convolutional LSTM Network").  Gate order [i, f, g, o] like LSTMCell."""

    def __init__(self, input_shape, num_hidden, activation='leaky',
                 prefix='ConvLSTM_', forget_bias=1.0, **kwargs):
        super().__init__(input_shape, num_hidden, activation=activation,
                         prefix=prefix, **kwargs)
        from ..initializer import LSTMBias
        self.params.get('i2h_bias', init=LSTMBias(forget_bias=forget_bias))

    @property
    def _gate_names(self):
        return ['_i', '_f', '_c', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._conv_forward(inputs, states, name)
        next_h, next_c = _lstm_step(i2h + h2h, states[1], self._act, name)
        return next_h, [next_h, next_c]


class ConvGRUCell(BaseConvRNNCell):
    """Convolutional GRU (reference: rnn_cell.py:1348)."""

    def __init__(self, input_shape, num_hidden, activation='leaky',
                 prefix='ConvGRU_', **kwargs):
        super().__init__(input_shape, num_hidden, activation=activation,
                         prefix=prefix, **kwargs)

    @property
    def state_info(self):
        return [{'shape': self._state_shape, '__layout__': 'NCHW'}]

    @property
    def _gate_names(self):
        return ['_r', '_z', '_o']

    def __call__(self, inputs, states):
        self._counter += 1
        name = f'{self._prefix}t{self._counter}_'
        i2h, h2h = self._conv_forward(inputs, states, name)
        next_h = _gru_step(i2h, h2h, states[0], self._act, name)
        return next_h, [next_h]
