"""Fused multi-layer (bi)directional RNN / LSTM / GRU op.

PyTorch counterpart of ``mxnet_tpu/ops/rnn.py`` (reference:
src/operator/rnn-inl.h, cudnn_rnn-inl.h).  The JAX package runs each
layer as a ``lax.scan``; here the whole stack goes to PyTorch's fused
RNN (``torch._VF.lstm`` / ``gru`` / ``rnn_tanh`` / ``rnn_relu``), which is
cuDNN's persistent RNN on the card and PyTorch's own loop on the CPU.
The ``RNN`` op is not a Pallas kernel in the JAX package, so no
hand-written kernel replaces it.

The flat ``parameters`` vector keeps the JAX package's (and the
reference's) layout, so ``FusedRNNCell.unpack_weights`` and checkpoints
carry over:
  for layer l, direction d: W_x[gates] (G*H, I_l), W_h[gates] (G*H, H)
  then all biases:          b_x[gates] (G*H,),     b_h[gates] (G*H,)
Gate order: lstm = [i, f, g, o]; gru = [r, z, n]; rnn_* = [x] — cuDNN's
and PyTorch's orders, and the GRU's candidate
``n = tanh(W_nx x + b_nx + r * (W_nh h + b_nh))`` is theirs too.  The op
hands PyTorch views of the flat vector in its per-layer order
``w_ih, w_hh, b_ih, b_hh``; cuDNN packs them into its own buffer on
every call (a copy of the parameters, PERF.md §5 measures it), and the
gradients flow back through the views into the flat vector.

Begin states of batch 1 (``sym.zeros`` with the unknown batch dim
materialized as 1) are expanded to the batch.  Dropout between layers
(``p``, training only) draws its mask from the executor's
``torch.Generator`` as ``Dropout`` does; it then runs the layers one
call each, since cuDNN's own dropout would draw from torch's global
stream.  Under a bf16 ``compute_dtype`` the recurrence runs in bf16, as
in the JAX package (``RNN`` is not in ``AMP_FP32_OPS``).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    """Total flat parameter count (reference: rnn-inl.h GetParamSize)."""
    g = _GATES[mode]
    d = 2 if bidirectional else 1
    size = 0
    for l in range(num_layers):
        i_l = input_size if l == 0 else state_size * d
        size += d * (g * state_size * i_l + g * state_size * state_size)
    size += num_layers * d * 2 * g * state_size  # biases
    return size


def unpack_flat(params, num_layers, input_size, H, d, g):
    """Views of the flat vector: ``[[w_ih, w_hh, b_ih, b_hh] per
    direction] per layer`` (PyTorch's per-layer order)."""
    off = 0
    layers = []
    for l in range(num_layers):
        i_l = input_size if l == 0 else H * d
        per_dir = []
        for _ in range(d):
            wx = params[off: off + g * H * i_l].view(g * H, i_l)
            off += g * H * i_l
            wh = params[off: off + g * H * H].view(g * H, H)
            off += g * H * H
            per_dir.append([wx, wh])
        layers.append(per_dir)
    for l in range(num_layers):
        for dd in range(d):
            bx = params[off: off + g * H]
            off += g * H
            bh = params[off: off + g * H]
            off += g * H
            layers[l][dd] += [bx, bh]
    if off != params.numel():
        raise MXNetError(f"RNN: parameters has {params.numel()} values, "
                         f"the layout needs {off}")
    return layers


def _vf(mode):
    return {"lstm": torch._VF.lstm, "gru": torch._VF.gru,
            "rnn_tanh": torch._VF.rnn_tanh,
            "rnn_relu": torch._VF.rnn_relu}[mode]


def _run_stack(mode, x, h0, c0, weights, num_layers, bidirectional):
    """One fused call over ``num_layers`` layers: (out, h_n, c_n)."""
    flat = [w for layer in weights for per_dir in layer for w in per_dir]
    hx = (h0, c0) if mode == "lstm" else h0
    # ``train`` keeps cuDNN's workspace for the backward; with dropout 0
    # it changes no number
    res = _vf(mode)(x, hx, flat, True, num_layers, 0.0,
                    torch.is_grad_enabled(), bidirectional, False)
    if mode == "lstm":
        return res[0], res[1], res[2]
    return res[0], res[1], None


@register("RNN", arg_names=["data", "parameters", "state", "state_cell"],
          num_outputs=-1, takes_is_train=True, needs_rng=True,
          attr_defaults={"state_size": 0, "num_layers": 1,
                         "bidirectional": False, "mode": "lstm", "p": 0.0,
                         "state_outputs": False, "lstm_state_clip_min": None,
                         "lstm_state_clip_max": None})
def _rnn(data, parameters, state, state_cell=None, state_size=0,
         num_layers=1, bidirectional=False, mode="lstm", p=0.0,
         state_outputs=False, is_train=True, generator=None, **kw):
    """data: (T, N, I); state: (L*D, N or 1, H); returns out (T, N, H*D)
    [+ state_out (+ state_cell_out for lstm) if state_outputs]."""
    if mode not in _GATES:
        raise MXNetError(f"RNN: unknown mode {mode!r}")
    if kw.get("lstm_state_clip_min") is not None \
            or kw.get("lstm_state_clip_max") is not None:
        raise MXNetError("RNN: lstm_state_clip_* is not supported (the "
                         "JAX package ignores it)")
    T, N, I = data.shape
    H, L = int(state_size), int(num_layers)
    d = 2 if bidirectional else 1
    p = float(p)
    if data.device.type == "meta":  # shape inference
        outs = [torch.empty((T, N, H * d), dtype=data.dtype, device="meta")]
        if state_outputs:
            outs += [torch.empty((L * d, N, H), dtype=data.dtype,
                                 device="meta")] * (2 if mode == "lstm"
                                                    else 1)
        return tuple(outs)
    weights = unpack_flat(parameters.to(data.dtype), L, I, H, d,
                          _GATES[mode])
    h0 = state.to(data.dtype).expand(L * d, N, H).contiguous()
    c0 = (state_cell.to(data.dtype).expand(L * d, N, H).contiguous()
          if mode == "lstm" else None)
    if not (is_train and p > 0.0 and L > 1):
        x, h_n, c_n = _run_stack(mode, data, h0, c0, weights, L,
                                 bidirectional)
    else:
        x, hs, cs = data, [], []
        for l in range(L):
            sl = slice(l * d, (l + 1) * d)
            x, h, c = _run_stack(mode, x, h0[sl], None if c0 is None
                                 else c0[sl], weights[l:l + 1], 1,
                                 bidirectional)
            hs.append(h)
            cs.append(c)
            if l < L - 1:
                keep = torch.rand(x.shape, generator=generator,
                                  device=x.device) < (1.0 - p)
                x = x * (keep.to(x.dtype) / (1.0 - p))
        h_n = torch.cat(hs, 0)
        c_n = torch.cat(cs, 0) if mode == "lstm" else None
    if not state_outputs:
        return (x,)
    if mode == "lstm":
        return x, h_n, c_n
    return x, h_n
