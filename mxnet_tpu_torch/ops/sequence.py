"""Variable-length sequence ops.

PyTorch counterpart of ``mxnet_tpu/ops/sequence.py`` (reference:
src/operator/sequence_{mask,last,reverse}.cc): ``SequenceMask``,
``SequenceLast`` and ``SequenceReverse``.  The sequence axis is 0 (TNC)
unless ``axis`` says otherwise; the optional ``sequence_length`` input
(N,) is read only with ``use_sequence_length``.  ``CTCLoss`` is not
ported yet (ROADMAP C1.b) and raises.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


def _len_mask(max_len, lengths, total_dims):
    """(T, N, 1, ...) boolean mask, True where t < length[n]."""
    t = torch.arange(max_len, device=lengths.device)[:, None]
    m = t < lengths[None, :]
    return m.reshape(m.shape + (1,) * (total_dims - 2))


@register("SequenceMask", arg_names=["data", "sequence_length"],
          attr_defaults={"use_sequence_length": False, "value": 0.0,
                         "axis": 0})
def _sequence_mask(data, sequence_length=None, use_sequence_length=False,
                   value=0.0, axis=0, **kw):
    if not use_sequence_length or sequence_length is None:
        return data
    x = data.transpose(0, axis) if axis != 0 else data
    mask = _len_mask(x.shape[0], sequence_length.to(torch.int32), x.dim())
    out = torch.where(mask, x, torch.tensor(value, dtype=x.dtype,
                                            device=x.device))
    return out.transpose(0, axis) if axis != 0 else out


@register("SequenceLast", arg_names=["data", "sequence_length"],
          attr_defaults={"use_sequence_length": False, "axis": 0})
def _sequence_last(data, sequence_length=None, use_sequence_length=False,
                   axis=0, **kw):
    x = data.transpose(0, axis) if axis != 0 else data
    if not use_sequence_length or sequence_length is None:
        return x[-1]
    idx = sequence_length.to(torch.int64) - 1  # (N,)
    idx = idx.reshape((1, -1) + (1,) * (x.dim() - 2)).expand(
        (1,) + tuple(x.shape[1:]))
    return torch.gather(x, 0, idx)[0]


@register("SequenceReverse", arg_names=["data", "sequence_length"],
          attr_defaults={"use_sequence_length": False, "axis": 0})
def _sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                      axis=0, **kw):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (0,))
    T = data.shape[0]
    lengths = sequence_length.to(torch.int64)  # (N,)
    t = torch.arange(T, device=data.device)[:, None]
    src = torch.where(t < lengths[None, :], lengths[None, :] - 1 - t, t)
    src = src.reshape((T, src.shape[1]) + (1,) * (data.dim() - 2))
    return torch.gather(data, 0, src.expand(data.shape))


@register("CTCLoss",
          arg_names=["data", "label", "data_lengths", "label_lengths"],
          attr_defaults={"use_data_lengths": False,
                         "use_label_lengths": False,
                         "blank_label": "first"},
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
def _ctc_loss(*args, **kw):
    raise MXNetError("CTCLoss is not ported yet (ROADMAP C1.b)")
