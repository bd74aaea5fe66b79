"""Graph interpreter and Executor.

PyTorch counterpart of ``mxnet_tpu/executor.py``.  ``build_interpreter``
turns a Symbol into a plain function that runs the graph's ops on torch
tensors in topological order; PyTorch runs eagerly, so there is no
compile step, and the mixed-precision cast policy is the JAX package's.
A training run (``is_train=True``) runs with grad mode on, so autograd
records the graph; an inference run records nothing.

``Executor`` binds a Symbol to argument, gradient and auxiliary arrays
(``NDArray``) on one device: ``forward(is_train)`` runs the interpreter,
``backward(out_grads)`` seeds every floating output with ones (or the
given cotangents) and writes the parameter gradients per ``grad_req``.
The JAX package's fused forward+backward jit and the multi-step drivers
have no counterpart here: autograd keeps the forward's graph until the
backward.  Ops that draw random numbers (``needs_rng``, e.g. Dropout)
get the executor's ``torch.Generator`` as ``generator=``: one per
executor, on its device, seeded at bind from
:func:`mxnet_tpu_torch.random.generator`, so the same ``random.seed``
gives the same draws.  The draws are not the JAX package's.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import as_device, current_context
from .ndarray.ndarray import NDArray, torch_dtype
from .ops import registry as _reg
from .symbol.symbol import Symbol, _topo_sort
from . import profiler as _prof
from . import random as _random


# Ops kept in float32 under mixed precision: normalization statistics and
# loss heads (same set as the JAX package).  Every name has an op in the
# port but CTCLoss (ROADMAP C1.b.2).
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
    """Build ``run(arg_vals, aux_vals, is_train=False, device=None,
    generator=None, grad=None) -> (outs, new_aux)``.

    ``arg_vals``/``aux_vals`` follow ``list_arguments()`` /
    ``list_auxiliary_states()``.  ``device`` (default: the first argument's
    device) is handed to ops that create a tensor from no input, and
    ``generator`` to ops that draw random numbers (``run.needs_rng`` says
    whether the graph has one; it then raises without a generator).

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

    def run(arg_vals, aux_vals, is_train=False, device=None,
            generator=None, grad=None):
        with torch.set_grad_enabled(bool(is_train if grad is None
                                         else grad)):
            return _run(arg_vals, aux_vals, is_train, device, generator)

    def _run(arg_vals, aux_vals, is_train, device, generator):
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
            if opdef.needs_rng:
                if generator is None:
                    raise MXNetError(f"run: {n.op} ({n.name}) draws random "
                                     "numbers; pass generator=")
                kwargs["generator"] = generator
            outs = opdef.fn(*ins, **kwargs)
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if opdef.num_aux and opdef.takes_is_train and is_train:
                updates = outs[-opdef.num_aux:]
                outs = outs[:-opdef.num_aux]
                for (src, _), u in zip(n.inputs[-opdef.num_aux:], updates):
                    if src.is_variable and src.name in aux_pos:
                        old = aux_vals[aux_pos[src.name]]
                        new_aux[aux_pos[src.name]] = u.to(old.dtype)
            for i, o in enumerate(outs):
                env[(id(n), i)] = o
        out_vals = tuple(env[(id(h), i)] for h, i in heads)
        return out_vals, tuple(new_aux)

    run.needs_rng = any(not n.is_variable and _reg.get(n.op).needs_rng
                        for n in nodes)
    return run, arg_names, aux_names


def graph_generator(run, device) -> Optional[torch.Generator]:
    """The random stream of one bound graph: a ``torch.Generator`` on
    ``device`` seeded from the package's generator, or None where the
    graph draws nothing (so binding any other graph leaves the
    initializers' numbers as they were)."""
    if not run.needs_rng:
        return None
    seed = int(torch.randint(0, 2 ** 62, (1,),
                             generator=_random.generator()))
    return torch.Generator(device).manual_seed(seed)


def _as_tensor(value, device, dtype=None) -> torch.Tensor:
    """An NDArray, tensor or array-like as a tensor on ``device``: a new
    tensor, never one the caller holds."""
    if isinstance(value, NDArray):
        value = value._data
    if not isinstance(value, torch.Tensor):
        arr = np.asarray(value)
        value = torch.from_numpy(np.ascontiguousarray(arr))
    return value.to(device=device, dtype=dtype, copy=True)


class Executor:
    """reference: include/mxnet/executor.h:52; python/mxnet/executor.py.

    ``args``/``aux_states``: lists (in ``list_arguments()`` /
    ``list_auxiliary_states()`` order) or dicts of NDArrays on one device.
    ``grad_req``: ``write``, ``add`` or ``null``, one for all or per
    argument."""

    def __init__(self, symbol: Symbol, ctx=None, args=None,
                 grad_req="write", aux_states=None, compute_dtype=None):
        self._symbol = symbol
        self._ctx = ctx if ctx is not None else current_context()
        self._device = as_device(self._ctx)
        self._compute_dtype = compute_dtype
        run, arg_names, aux_names = build_interpreter(symbol, compute_dtype)
        self._run = run
        self._gen = graph_generator(run, self._device)
        self._arg_names = arg_names
        self._aux_names = aux_names
        self.arg_arrays = self._canon(args, arg_names, "args")
        self.aux_arrays = self._canon(aux_states, aux_names, "aux_states",
                                      allow_empty=True)
        if isinstance(grad_req, str):
            grad_req = {n: grad_req for n in arg_names}
        elif isinstance(grad_req, (list, tuple)):
            grad_req = dict(zip(arg_names, grad_req))
        self.grad_req = {n: grad_req.get(n, "null") for n in arg_names}
        bad = sorted({r for r in self.grad_req.values()}
                     - {"write", "add", "null"})
        if bad:
            raise MXNetError(f"grad_req must be write|add|null, got {bad}")
        # gradient arrays: simple_bind allocates them; otherwise the first
        # backward does
        self.grad_arrays = [None] * len(arg_names)
        self._out_arrays: Optional[List[NDArray]] = None
        # (leaf tensors by arg position, outputs) of the last training
        # forward whose graph the backward has not consumed yet
        self._graph = None

    @staticmethod
    def _canon(arrays, names, what, allow_empty=False):
        if arrays is None:
            if allow_empty and not names:
                return []
            raise MXNetError(f"bind: {what} must be provided (or use "
                             "simple_bind)")
        if isinstance(arrays, dict):
            missing = [n for n in names if n not in arrays]
            if missing:
                raise MXNetError(f"bind: missing {what}: {missing}")
            arrays = [arrays[n] for n in names]
        arrays = [a if isinstance(a, NDArray) else NDArray(a)
                  for a in arrays]
        if len(arrays) != len(names):
            raise MXNetError(f"bind: expected {len(names)} {what}, "
                             f"got {len(arrays)}")
        return arrays

    @classmethod
    def simple_bind(cls, symbol: Symbol, ctx=None, grad_req="write",
                    type_dict=None, shapes=None, compute_dtype=None):
        """Infer every shape from the given input shapes and allocate
        zeroed argument, gradient and auxiliary arrays on ``ctx``'s
        device (reference: MXExecutorSimpleBind).  ``type_dict`` gives
        dtypes by name (default float32)."""
        ctx = ctx if ctx is not None else current_context()
        device = as_device(ctx)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**(shapes or {}))
        type_dict = type_dict or {}

        def alloc(name, shape):
            dt = torch_dtype(type_dict.get(name, np.float32))
            return NDArray(torch.zeros(tuple(shape), dtype=dt,
                                       device=device))
        arg_names = symbol.list_arguments()
        args = [alloc(n, s) for n, s in zip(arg_names, arg_shapes)]
        aux = [alloc(n, s) for n, s in
               zip(symbol.list_auxiliary_states(), aux_shapes)]
        ex = cls(symbol, ctx, args=args, grad_req=grad_req, aux_states=aux,
                 compute_dtype=compute_dtype)
        ex.grad_arrays = [
            alloc(n, s) if ex.grad_req[n] != "null" else None
            for n, s in zip(arg_names, arg_shapes)]
        return ex

    # -- dict views ----------------------------------------------------------
    @property
    def arg_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._arg_names, self.arg_arrays))

    @property
    def grad_dict(self) -> Dict[str, Optional[NDArray]]:
        return dict(zip(self._arg_names, self.grad_arrays))

    @property
    def aux_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._aux_names, self.aux_arrays))

    @property
    def outputs(self) -> List[NDArray]:
        if self._out_arrays is None:
            self.forward(False)
        return self._out_arrays

    # -- compute -------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        """Set the named inputs (NDArrays, tensors or arrays, copied to
        the device in their own dtype) and run the graph.  A training
        forward keeps autograd's graph for :meth:`backward`; an inference
        forward records nothing."""
        for name, value in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"forward: unknown argument {name!r}")
            pos = self._arg_names.index(name)
            self.arg_arrays[pos]._set_data(_as_tensor(value, self._device))
        vals = [a._data for a in self.arg_arrays]
        leaves = {}
        if is_train:
            for i, name in enumerate(self._arg_names):
                if self.grad_req[name] != "null":
                    vals[i] = leaves[i] = vals[i].detach().requires_grad_()
        _prof.record_dispatch("executor.forward")
        outs, new_aux = self._run(vals, [a._data for a in self.aux_arrays],
                                  is_train=is_train, device=self._device,
                                  generator=self._gen)
        if is_train:
            for a, v in zip(self.aux_arrays, new_aux):
                a._set_data(v.detach())
        self._out_arrays = [NDArray(o.detach()) for o in outs]
        self._graph = (leaves, outs) if (is_train and leaves) else None
        return self._out_arrays

    def backward(self, out_grads=None):
        """Gradients of the outputs, seeded with ones (the JAX package's
        head cotangent; loss heads ignore it) or with ``out_grads``,
        written into ``grad_arrays`` per ``grad_req``.  The backward
        consumes the last training forward's graph; without one (after
        an inference forward, or a second backward) it runs a training
        forward first."""
        if not any(r != "null" for r in self.grad_req.values()):
            raise MXNetError("backward: no gradients required "
                             "(all grad_req are null)")
        if self._graph is None:
            self.forward(is_train=True)
        leaves, outs = self._graph
        self._graph = None
        if out_grads is not None:
            if isinstance(out_grads, (NDArray, torch.Tensor, np.ndarray)):
                out_grads = [out_grads]
            out_grads = [_as_tensor(g, self._device) for g in out_grads]
        heads, cts = [], []
        for i, o in enumerate(outs):
            if not (o.is_floating_point() and o.requires_grad):
                continue
            heads.append(o)
            cts.append(torch.ones_like(o) if out_grads is None
                       else out_grads[i].to(o.dtype))
        pos = sorted(leaves)
        _prof.record_dispatch("executor.backward")
        grads = torch.autograd.grad(heads, [leaves[i] for i in pos], cts,
                                    allow_unused=True) if heads else \
            [None] * len(pos)
        for i, g in zip(pos, grads):
            if g is None:
                g = torch.zeros_like(leaves[i])
            garr = self.grad_arrays[i]
            if garr is None:
                self.grad_arrays[i] = NDArray(g)
            elif self.grad_req[self._arg_names[i]] == "add":
                garr._set_data(garr._data + g)
            else:
                garr._set_data(g)

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy values (NDArrays, tensors or numpy arrays) into the bound
        arrays, on their device and in their dtype (reference:
        executor.py copy_params_from)."""
        for kind, given, arrays in (("argument", arg_params, self.arg_dict),
                                    ("aux state", aux_params or {},
                                     self.aux_dict)):
            for name, value in given.items():
                if name in arrays:
                    arr = arrays[name]
                    arr._set_data(_as_tensor(value, self._device,
                                             arr._data.dtype))
                elif not allow_extra_params:
                    raise MXNetError(f"unknown {kind} {name!r}")
