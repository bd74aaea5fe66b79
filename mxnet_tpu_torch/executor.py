"""Graph interpreter (forward only).

PyTorch counterpart of ``build_interpreter`` in ``mxnet_tpu/executor.py``:
a Symbol becomes a plain function that runs the graph's ops on torch
tensors in topological order.  PyTorch runs eagerly, so there is no
compile step; the mixed-precision cast policy is the JAX package's.
Backward, ``Executor`` and the fused multi-step drivers are not ported
yet, and no op that draws random numbers is on this path: building an
interpreter over one raises.
"""
from __future__ import annotations

import torch

from .base import MXNetError
from .ops import registry as _reg
from .symbol.symbol import Symbol, _topo_sort


# Ops kept in float32 under mixed precision: normalization statistics and
# loss heads (same set as the JAX package).
AMP_FP32_OPS = frozenset({
    "InstanceNorm", "L2Normalization", "LRN", "norm",
    "SoftmaxOutput", "SoftmaxActivation", "softmax", "log_softmax",
    "log_softmax_mx", "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MakeLoss", "SVMOutput", "CTCLoss",
    "softmax_cross_entropy",
})

# Ops with a SPLIT precision contract: only the listed input indices are
# cast to the compute dtype.
AMP_SPLIT_OPS = {"BatchNorm": (0,)}


def as_torch_dtype(dtype):
    """None, a torch.dtype, or a dtype name ("bfloat16", "float32", ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"unknown dtype {dtype!r}")
    return dt


def build_interpreter(sym: Symbol, compute_dtype=None):
    """Build ``run(arg_vals, aux_vals, is_train=False, device=None) ->
    (outs, new_aux)``.

    ``arg_vals``/``aux_vals`` follow ``list_arguments()`` /
    ``list_auxiliary_states()``.  ``device`` (default: the first argument's
    device) is handed to ops that create a tensor from no input.

    ``compute_dtype`` (e.g. ``"bfloat16"``) enables mixed precision: all
    floating-point op inputs are cast to it except ops in
    ``AMP_FP32_OPS``, which run in float32; master parameters stay as
    given."""
    nodes = _topo_sort(sym.heads)
    arg_names = sym.list_arguments()
    aux_names = sym.list_auxiliary_states()
    arg_pos = {n: i for i, n in enumerate(arg_names)}
    aux_pos = {n: i for i, n in enumerate(aux_names)}
    heads = sym.heads
    rng_ops = sorted({n.op for n in nodes
                      if not n.is_variable and _reg.get(n.op).needs_rng})
    if rng_ops:
        raise MXNetError(f"build_interpreter: ops {rng_ops} draw random "
                         "numbers, which this package does not port yet")
    cd = as_torch_dtype(compute_dtype)

    def _amp_cast(ins, op):
        split = AMP_SPLIT_OPS.get(op)
        if split is not None:
            return [v.to(cd) if (i in split and v.is_floating_point()
                                 and v.dtype != cd) else v
                    for i, v in enumerate(ins)]
        want = torch.float32 if op in AMP_FP32_OPS else cd
        return [v.to(want) if (v.is_floating_point() and v.dtype != want)
                else v for v in ins]

    def run(arg_vals, aux_vals, is_train=False, device=None):
        if device is None:
            if not arg_vals:
                raise MXNetError("run: no arguments to take a device "
                                 "from; pass device=")
            device = arg_vals[0].device
        env = {}
        new_aux = list(aux_vals)
        for n in nodes:
            if n.is_variable:
                if n.name in arg_pos:
                    env[(id(n), 0)] = arg_vals[arg_pos[n.name]]
                else:
                    env[(id(n), 0)] = aux_vals[aux_pos[n.name]]
                continue
            opdef = _reg.get(n.op)
            _reg.record_execution(n.op)
            ins = [env[(id(src), i)] for src, i in n.inputs]
            if cd is not None:
                ins = _amp_cast(ins, n.op)
            kwargs = dict(n.attrs)
            kwargs.pop("name", None)
            if opdef.takes_is_train:
                kwargs["is_train"] = is_train
            if not n.inputs:
                kwargs["device"] = device
            outs = opdef.fn(*ins, **kwargs)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if opdef.num_aux and opdef.takes_is_train and is_train:
                updates = outs[-opdef.num_aux:]
                outs = outs[:-opdef.num_aux]
                for (src, _), u in zip(n.inputs[-opdef.num_aux:], updates):
                    if src.is_variable and src.name in aux_pos:
                        new_aux[aux_pos[src.name]] = u
            for i, o in enumerate(outs):
                env[(id(n), i)] = o
        out_vals = tuple(env[(id(h), i)] for h, i in heads)
        return out_vals, tuple(new_aux)

    return run, arg_names, aux_names
