"""Variable-length sequence ops.

PyTorch counterpart of ``mxnet_tpu/ops/sequence.py`` (reference:
src/operator/sequence_{mask,last,reverse}.cc): ``SequenceMask``,
``SequenceLast`` and ``SequenceReverse``.  The sequence axis is 0 (TNC)
unless ``axis`` says otherwise; the optional ``sequence_length`` input
(N,) is read only with ``use_sequence_length``.  ``CTCLoss`` (reference:
src/operator/contrib/ctc_loss.cc) is the CTC forward algorithm in log
space, a loop over time vectorised over the batch and the 2L + 1 states,
with torch's autograd for its gradient.
"""
from __future__ import annotations

import torch

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


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with ``jnp.logaddexp``'s value and gradient:
    max + log1p(exp(-|a - b|)), and g exp(a - out), g exp(b - out).
    Where a and b are both near the recursion's -1e30 floor, out rounds
    to them and each side gets g (torch.logaddexp gives g / 2), so an
    infeasible sequence's gradient equals the JAX package's too."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


@register("CTCLoss",
          arg_names=["data", "label", "data_lengths", "label_lengths"],
          attr_defaults={"use_data_lengths": False,
                         "use_label_lengths": False,
                         "blank_label": "first"},
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
def _ctc_loss(data, label, data_lengths=None, label_lengths=None,
              use_data_lengths=False, use_label_lengths=False,
              blank_label="first", **kw):
    """data (T, N, C) activations, label (N, L) padded -> loss (N,).

    ``blank_label='first'``: channel 0 is the blank and 0 pads a label;
    ``'last'``: channel C-1 is the blank and -1 pads.  Without
    ``use_label_lengths`` a label's length is its count of non-pad
    entries; without ``use_data_lengths`` every sequence has T steps.
    As in the JAX package, a lone ``label_lengths`` input that landed in
    the ``data_lengths`` slot (inputs left out are dropped, the flags
    say which was given) is moved back.  The recursion runs in float32
    with -1e30 as log 0 (float64 for float64 data), so an infeasible
    alignment (a label longer than its sequence allows) gives a loss of
    about 1e30, not inf."""
    if use_label_lengths and not use_data_lengths and \
            label_lengths is None and data_lengths is not None:
        label_lengths, data_lengths = data_lengths, None
    T, N, C = data.shape
    if data.device.type == "meta":
        return torch.empty((N,), device="meta")
    dev = data.device
    L = label.shape[1]
    acc = torch.float64 if data.dtype == torch.float64 else torch.float32
    logp = torch.log_softmax(data.to(acc), dim=-1)
    lab = label.long()
    blank, pad = (0, 0) if blank_label == "first" else (C - 1, -1)
    if use_label_lengths and label_lengths is not None:
        lab_len = label_lengths.long()
    else:
        lab_len = (lab != pad).sum(dim=1)
    if use_data_lengths and data_lengths is not None:
        dat_len = data_lengths.long()
    else:
        dat_len = torch.full((N,), T, dtype=torch.long, device=dev)
    S = 2 * L + 1
    neg = torch.tensor(-1e30, dtype=acc, device=dev)
    z = torch.full((N, S), blank, dtype=torch.long, device=dev)
    z[:, 1::2] = lab
    z_prev2 = torch.cat([torch.full((N, 2), -1, dtype=torch.long,
                                    device=dev), z[:, :-2]], dim=1)
    can_skip = (z != blank) & (z != z_prev2)
    z = torch.where(z < 0, z + C, z)      # a -1 pad reads channel C-1
    smask = torch.arange(S, device=dev)[None, :] < (2 * lab_len + 1)[:, None]
    has_label = (lab_len > 0)[:, None]

    def emit(t):                          # (N, S) log-probs of the states
        return logp[t].gather(1, z)

    a0 = torch.full((N, S), -1e30, dtype=acc, device=dev)
    e0 = emit(0)
    a = torch.cat([e0[:, :1], torch.where(has_label, e0[:, 1:2], neg),
                   a0[:, 2:]], dim=1)[:, :S]
    a = torch.where(smask, a, neg)
    final = torch.where((dat_len == 1)[:, None], a, neg)
    fill = torch.full((N, 2), -1e30, dtype=acc, device=dev)
    for t in range(1, T):
        p1 = torch.cat([fill[:, :1], a[:, :-1]], dim=1)
        p2 = torch.where(can_skip, torch.cat([fill, a[:, :-2]], dim=1)
                         [:, :S], neg)
        a = _LogAddExp.apply(_LogAddExp.apply(a, p1), p2) + emit(t)
        a = torch.where(smask, a, neg)
        final = torch.where((dat_len == t + 1)[:, None], a, final)
    end_blank = final.gather(1, (2 * lab_len)[:, None])[:, 0]
    end_label = torch.where(
        lab_len > 0,
        final.gather(1, (2 * lab_len - 1).clamp_min(0)[:, None])[:, 0], neg)
    return -_LogAddExp.apply(end_blank, end_label)
