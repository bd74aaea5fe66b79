"""The ``Custom`` op: ``operator.CustomOp`` / ``CustomOpProp`` in the
registry (reference: src/operator/custom/custom.cc).

PyTorch counterpart of ``mxnet_tpu/ops/custom.py``.  The user's
``forward`` and ``backward`` run on numpy copies of the tensors (bf16
ones as float32); a ``torch.autograd.Function`` keeps the real outputs
for ``backward``, gives the auxiliary states no gradient, and puts every
result back on the inputs' device in the dtype ``infer_type`` names (a
bf16 input's outputs in bf16).  It runs in a ``Module`` graph and
imperatively under ``autograd.record()``.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _host(t):
    """A numpy copy of a tensor (bf16 as float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _np_dtype(t):
    """The numpy dtype of a tensor's host copy (meta tensors too)."""
    if t.dtype == torch.bfloat16:
        return np.dtype("float32")
    return torch.empty(0, dtype=t.dtype).numpy().dtype


def _torch_dtype(dtype, like):
    """The torch dtype of numpy ``dtype``, or bf16 where ``like`` is."""
    if like.dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def _back(arr, like, dtype):
    """A host array as a tensor on ``like``'s device (_torch_dtype)."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(
        device=like.device, dtype=_torch_dtype(dtype, like))


class _CustomFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, state, n_in, is_train, *vals):
        from .. import operator as _op
        ins = [_op._NDView(_host(v)) for v in vals[:n_in]]
        auxs = [_op._NDView(_host(v)) for v in vals[n_in:]]
        outs = [_op._NDView(np.zeros(s, d))
                for s, d in zip(state.out_shapes, state.out_types)]
        state.op.forward(is_train, ["write"] * len(outs), ins, outs, auxs)
        res = tuple(_back(o.arr, vals[0], d)
                    for o, d in zip(outs, state.out_types))
        ctx.state, ctx.n_in = state, n_in
        ctx.save_for_backward(*vals, *res)
        return res

    @staticmethod
    def backward(ctx, *gs):
        from .. import operator as _op
        state, n_in = ctx.state, ctx.n_in
        saved = ctx.saved_tensors
        n_out = len(gs)
        vals, outs = saved[:-n_out], saved[-n_out:]
        ogs = [_op._NDView(_host(g) if g is not None
                           else np.zeros(o.shape, _np_dtype(o)))
               for g, o in zip(gs, outs)]
        ins = [_op._NDView(_host(v)) for v in vals[:n_in]]
        auxs = [_op._NDView(_host(v)) for v in vals[n_in:]]
        outv = [_op._NDView(_host(o)) for o in outs]
        igs = [_op._NDView(np.zeros(s, d))
               for s, d in zip(state.in_shapes, state.in_types)]
        state.op.backward(["write"] * n_in, ogs, ins, outv, igs, auxs)
        grads = tuple(_back(g.arr, v, g.arr.dtype)
                      for g, v in zip(igs, vals[:n_in]))
        return (None, None, None) + grads + (None,) * (len(vals) - n_in)


def _num_visible(attrs):
    from .. import operator as _op
    return _op.num_outputs_for(attrs)


@register("Custom", variadic=True, num_outputs=-1, num_visible=_num_visible,
          takes_is_train=True, attr_defaults={"op_type": ""})
def _custom(*inputs, op_type="", is_train=True, **attrs):
    """reference: src/operator/custom/custom.cc (op ``Custom``): the inputs
    are the prop's arguments, then its auxiliary states."""
    from .. import operator as _op
    prop = _op._make_prop(op_type, attrs)
    n_out = len(prop.list_outputs())
    n_in = len(prop.list_arguments())
    n_aux = len(prop.list_auxiliary_states())
    data_in = inputs[:n_in]
    in_shapes = [tuple(x.shape) for x in data_in]
    _, out_shapes, _ = prop.infer_shape(list(in_shapes))
    in_types = [_np_dtype(x) for x in data_in]
    _, out_types, _ = prop.infer_type(list(in_types))
    out_types = [np.dtype(d) for d in out_types]
    if data_in[0].device.type == "meta":
        outs = tuple(torch.empty(tuple(s), device="meta",
                                 dtype=_torch_dtype(d, data_in[0]))
                     for s, d in zip(out_shapes, out_types))
    else:
        state = _op._HostState(prop, in_shapes, in_types)
        state.in_shapes, state.in_types = in_shapes, in_types
        state.out_shapes = [tuple(s) for s in out_shapes]
        state.out_types = out_types
        outs = _CustomFunction.apply(state, n_in, bool(is_train),
                                     *inputs[:n_in + n_aux])
    return outs[0] if n_out == 1 else tuple(outs)
