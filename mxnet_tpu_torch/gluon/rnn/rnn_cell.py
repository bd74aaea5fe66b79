"""Gluon recurrent cells (reference: python/mxnet/gluon/rnn/rnn_cell.py).

PyTorch counterpart of ``mxnet_tpu/gluon/rnn/rnn_cell.py``.  Cells are
HybridBlocks: one set of ops per step, composed by ``unroll``; on
NDArrays they run op by op, on Symbols they build the graph a
hybridized parent traces.  Imperative begin states are made on the
input's device.

Compatibility contract, deliberately preserved from the reference API:
parameter names (``i2h_weight`` …), gate order ([i, f, c, o] for LSTM,
[r, z, o] for GRU), state_info layouts, and cell aliases — these make
reference checkpoints load into gluon models unchanged.  Within that
contract the cell bodies share ``_fc_pair`` (both per-step projections,
all gates batched into one matmul) and the ``_lstm_step``/``_gru_step``
recurrences.
"""
from __future__ import annotations

import functools

from ..block import Block, HybridBlock
from ...base import MXNetError


def _fc_pair(F, inputs, prev_h, n_units, i2h_weight, h2h_weight,
             i2h_bias, h2h_bias):
    """Both per-step projections with every gate batched into one matmul
    each — the shape all cells share."""
    i2h = F.FullyConnected(inputs, i2h_weight, i2h_bias,
                           num_hidden=n_units)
    h2h = F.FullyConnected(prev_h, h2h_weight, h2h_bias,
                           num_hidden=n_units)
    return i2h, h2h


def _lstm_step(F, gates, prev_c):
    """LSTM recurrence over summed pre-activation gates; order
    [i, f, c, o] is the checkpoint/fused-op contract."""
    sl = list(F.SliceChannel(gates, num_outputs=4))
    in_gate = F.Activation(sl[0], act_type='sigmoid')
    forget_gate = F.Activation(sl[1], act_type='sigmoid')
    in_transform = F.Activation(sl[2], act_type='tanh')
    out_gate = F.Activation(sl[3], act_type='sigmoid')
    next_c = forget_gate * prev_c + in_gate * in_transform
    next_h = out_gate * F.Activation(next_c, act_type='tanh')
    return next_h, next_c


def _gru_step(F, i2h, h2h, prev_h):
    """GRU recurrence over the two projection outputs; order [r, z, o],
    candidate mixes the reset-gated recurrent slice."""
    i2h_r, i2h_z, i2h_o = list(F.SliceChannel(i2h, num_outputs=3))
    h2h_r, h2h_z, h2h_o = list(F.SliceChannel(h2h, num_outputs=3))
    reset_gate = F.Activation(i2h_r + h2h_r, act_type='sigmoid')
    update_gate = F.Activation(i2h_z + h2h_z, act_type='sigmoid')
    next_h_tmp = F.Activation(i2h_o + reset_gate * h2h_o,
                              act_type='tanh')
    return update_gate * prev_h + (1. - update_gate) * next_h_tmp


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, F, begin_state, inputs, batch_size):
    if begin_state is None:
        from ... import ndarray as nd_mod
        if F is nd_mod:
            first = inputs if hasattr(inputs, 'context') else inputs[0]
            begin_state = cell.begin_state(
                batch_size=batch_size,
                func=functools.partial(nd_mod.zeros, ctx=first.context))
        else:
            begin_state = cell.begin_state(func=F.zeros)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """reference: gluon/rnn/rnn_cell.py:38."""
    from ... import ndarray as nd_mod
    from ... import symbol as sym_mod
    from ...ndarray import NDArray
    assert inputs is not None
    axis = layout.find('T')
    batch_axis = layout.find('N')
    batch_size = 0
    in_axis = in_layout.find('T') if in_layout is not None else axis
    if isinstance(inputs, sym_mod.Symbol):
        F = sym_mod
        if merge is False:
            if len(inputs.list_outputs()) != 1:
                raise MXNetError(
                    "unroll doesn't allow grouped symbol as input.")
            inputs = list(sym_mod.SliceChannel(
                inputs, axis=in_axis, num_outputs=length, squeeze_axis=1))
    elif isinstance(inputs, NDArray):
        F = nd_mod
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            inputs = [inputs[(slice(None),) * in_axis + (i,)]
                      for i in range(inputs.shape[in_axis])]
    else:
        assert length is None or len(inputs) == length
        if isinstance(inputs[0], sym_mod.Symbol):
            F = sym_mod
        else:
            F = nd_mod
            batch_size = inputs[0].shape[batch_axis - 1 if batch_axis > axis
                                         else batch_axis]
        if merge is True:
            inputs = [F.expand_dims(i, axis=axis) for i in inputs]
            inputs = F.Concat(*inputs, dim=axis)
            in_axis = axis
    if hasattr(inputs, 'list_outputs') or hasattr(inputs, 'shape'):
        if axis != in_axis:
            inputs = F.SwapAxis(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, F, batch_size


class RecurrentCell(Block):
    """Base recurrent cell (reference: gluon/rnn/rnn_cell.py:81)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=None, **kwargs):
        """reference: gluon/rnn/rnn_cell.py:118."""
        assert not self._modified
        if func is None:
            from ... import ndarray as nd_mod
            func = nd_mod.zeros
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info = dict(info, **kwargs)
            else:
                info = kwargs
            info.pop('__layout__', None)
            shape = info.pop('shape')
            shape = tuple(1 if s == 0 else s for s in shape)
            state = func(shape=shape,
                         name=f'{self._prefix}begin_state_'
                              f'{self._init_counter}', **info)
            states.append(state)
        return states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        """reference: gluon/rnn/rnn_cell.py:158."""
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                            merge_outputs)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def forward(self, inputs, states):
        self._counter += 1
        return super().forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """reference: gluon/rnn/rnn_cell.py:219."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        self._counter += 1
        from ...ndarray import NDArray
        if isinstance(inputs, NDArray):
            from ... import ndarray as nd_mod
            pdata = {}
            for n, p in self._reg_params.items():
                if p._deferred_init is not None:
                    p._finish_deferred_init(
                        self._infer_param_shape(n, inputs))
                pdata[n] = p.data()
            return self.hybrid_forward(nd_mod, inputs, states, **pdata)
        from ... import symbol as sym_mod
        pvars = {n: p.var() for n, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, inputs, states, **pvars)

    def _infer_param_shape(self, name, inputs):
        ng = self._gates if hasattr(self, '_gates') else 1
        nh = self._hidden_size
        if 'i2h_weight' in name:
            return (ng * nh, inputs.shape[1])
        if 'h2h_weight' in name:
            return (ng * nh, nh)
        return (ng * nh,)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class RNNCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:232."""

    def __init__(self, hidden_size, activation='tanh',
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._activation = activation
        self._input_size = input_size
        self._gates = 1
        self.i2h_weight = self.params.get(
            'i2h_weight', shape=(hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            'h2h_weight', shape=(hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            'i2h_bias', shape=(hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            'h2h_bias', shape=(hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'rnn'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = _fc_pair(F, inputs, states[0], self._hidden_size,
                            i2h_weight, h2h_weight, i2h_bias, h2h_bias)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:310."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = 4
        self.i2h_weight = self.params.get(
            'i2h_weight', shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            'h2h_weight', shape=(4 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            'i2h_bias', shape=(4 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            'h2h_bias', shape=(4 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'},
                {'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'lstm'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = _fc_pair(F, inputs, states[0], 4 * self._hidden_size,
                            i2h_weight, h2h_weight, i2h_bias, h2h_bias)
        next_h, next_c = _lstm_step(F, i2h + h2h, states[1])
        return next_h, [next_h, next_c]


class GRUCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:426."""

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None,
                 i2h_bias_initializer='zeros', h2h_bias_initializer='zeros',
                 input_size=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._input_size = input_size
        self._gates = 3
        self.i2h_weight = self.params.get(
            'i2h_weight', shape=(3 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            'h2h_weight', shape=(3 * hidden_size, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            'i2h_bias', shape=(3 * hidden_size,),
            init=i2h_bias_initializer, allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            'h2h_bias', shape=(3 * hidden_size,),
            init=h2h_bias_initializer, allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{'shape': (batch_size, self._hidden_size),
                 '__layout__': 'NC'}]

    def _alias(self):
        return 'gru'

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       i2h_bias, h2h_bias):
        i2h, h2h = _fc_pair(F, inputs, states[0], 3 * self._hidden_size,
                            i2h_weight, h2h_weight, i2h_bias, h2h_bias)
        next_h = _gru_step(F, i2h, h2h, states[0])
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:540."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)
        super(Block, self).__setattr__(
            f'_cell{len(self._children)-1}', cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        return self.forward(inputs, states)

    def forward(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.append(state)
        return inputs, sum(next_states, [])

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        num_cells = len(self._children)
        _, _, F, batch_size = _format_sequence(length, inputs, layout,
                                               None)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        p = 0
        next_states = []
        for i, cell in enumerate(self._children):
            n = len(cell.state_info())
            states = begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)


class DropoutCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:610."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, float)
        self.rate = rate

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return 'dropout'

    def hybrid_forward(self, F, inputs, states):
        if self.rate > 0:
            inputs = F.Dropout(inputs, p=self.rate)
        return inputs, states

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if hasattr(inputs, 'shape') or hasattr(inputs, 'list_outputs'):
            return self.hybrid_forward(F, inputs, [])
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs)


class ModifierCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:659."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified." % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=None, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """reference: gluon/rnn/rnn_cell.py:711."""

    def __init__(self, base_cell, zoneout_outputs=0., zoneout_states=0.):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def _alias(self):
        return 'zoneout'

    def reset(self):
        super().reset()
        self.prev_output = None

    def hybrid_forward(self, F, inputs, states):
        cell, p_outputs, p_states = (self.base_cell, self.zoneout_outputs,
                                     self.zoneout_states)
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)
        prev_output = self.prev_output if self.prev_output is not None \
            else F.zeros_like(next_output)
        output = F.where(mask(p_outputs, next_output), next_output,
                         prev_output) if p_outputs != 0. else next_output
        new_states = [F.where(mask(p_states, new_s), new_s, old_s)
                      for new_s, old_s in zip(next_states, states)] \
            if p_states != 0. else next_states
        self.prev_output = output
        return output, new_states

    def forward(self, inputs, states):
        self._counter += 1
        from ...ndarray import NDArray
        if isinstance(inputs, NDArray):
            from ... import ndarray as nd_mod
            return self.hybrid_forward(nd_mod, inputs, states)
        from ... import symbol as sym_mod
        return self.hybrid_forward(sym_mod, inputs, states)


class ResidualCell(ModifierCell):
    """reference: gluon/rnn/rnn_cell.py:770."""

    def _alias(self):
        return 'residual'

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        output = output + inputs
        return output, states

    def forward(self, inputs, states):
        self._counter += 1
        from ...ndarray import NDArray
        if isinstance(inputs, NDArray):
            from ... import ndarray as nd_mod
            return self.hybrid_forward(nd_mod, inputs, states)
        from ... import symbol as sym_mod
        return self.hybrid_forward(sym_mod, inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs)
        self.base_cell._modified = True
        from ... import symbol as sym_mod
        merge_outputs = isinstance(outputs, sym_mod.Symbol) or \
            hasattr(outputs, 'shape') if merge_outputs is None \
            else merge_outputs
        inputs, _, F, _ = _format_sequence(length, inputs, layout,
                                           merge_outputs)
        if merge_outputs:
            outputs = outputs + inputs
        else:
            outputs = [out + inp for out, inp in zip(outputs, inputs)]
        return outputs, states


class BidirectionalCell(HybridRecurrentCell):
    """reference: gluon/rnn/rnn_cell.py:830."""

    def __init__(self, l_cell, r_cell, output_prefix='bi_'):
        super().__init__(prefix='', params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise MXNetError(
            "Bidirectional cannot be stepped. Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout='NTC',
               merge_outputs=None):
        self.reset()
        inputs, axis, F, batch_size = _format_sequence(
            length, inputs, layout, False)
        begin_state = _get_begin_state(self, F, begin_state, inputs,
                                       batch_size)
        states = begin_state
        l_cell, r_cell = self._children
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=states[:len(l_cell.state_info())],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=states[len(l_cell.state_info()):],
            layout=layout, merge_outputs=False)
        outputs = [F.Concat(l_o, r_o, dim=1)
                   for l_o, r_o in zip(l_outputs, reversed(r_outputs))]
        if merge_outputs:
            outputs, _, _, _ = _format_sequence(length, outputs, layout,
                                                merge_outputs)
        states = l_states + r_states
        return outputs, states
