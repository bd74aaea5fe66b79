"""Variational dropout cell
(reference: python/mxnet/gluon/contrib/rnn/rnn_cell.py:26-160).

PyTorch counterpart of ``mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``.
"""
from __future__ import annotations

from ...rnn.rnn_cell import (ModifierCell, BidirectionalCell,
                             SequentialRNNCell)


class VariationalDropoutCell(ModifierCell):
    """Applies variational dropout (Gal & Ghahramani 2016): ONE dropout
    mask per sequence for inputs/states/outputs, sampled at the first step
    and reused until ``reset()``.

    reference: gluon/contrib/rnn/rnn_cell.py:26 — mask semantics match
    (inputs/outputs/states masks are independent; state dropout applies to
    the first state only, i.e. h, not c).
    """

    def __init__(self, base_cell, drop_inputs=0., drop_states=0.,
                 drop_outputs=0.):
        assert not drop_states or not isinstance(base_cell,
                                                 BidirectionalCell), \
            "BidirectionalCell doesn't support variational state dropout; " \
            "apply VariationalDropoutCell to the cells underneath instead."
        assert not drop_states \
            or not isinstance(base_cell, SequentialRNNCell) \
            or not getattr(base_cell, '_bidirectional', False), \
            "Bidirectional SequentialRNNCell doesn't support variational " \
            "state dropout; apply to the cells underneath instead."
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return 'vardrop'

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(F.ones_like(states[0]),
                                              p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(F.ones_like(inputs),
                                              p=self.drop_inputs)
        if self.drop_states:
            states = list(states)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(F.ones_like(next_output),
                                               p=self.drop_outputs)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def __repr__(self):
        return (f'VariationalDropoutCell(p_in={self.drop_inputs}, '
                f'p_state={self.drop_states}, p_out={self.drop_outputs})')
