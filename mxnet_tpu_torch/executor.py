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
given cotangents) and writes the parameter gradients per ``grad_req``;
an argument whose ``grad_req`` is ``null`` is no leaf of autograd's
graph, so the backward stops where the trainable graph starts.
``reshape`` rebinds to new input shapes and keeps every array whose
shape stays, the same NDArray objects.
The JAX package's fused forward+backward jit and its scanned multi-step
programs have no counterpart here: autograd keeps the forward's graph
until the backward.  The chunked dist_async driver
(:func:`drive_chunked_dist`) is the JAX package's, over a plain step
loop.  Ops that draw random numbers (``needs_rng``, e.g. Dropout)
get the executor's ``torch.Generator`` as ``generator=``: one per
executor, on its device, seeded at bind from
:func:`mxnet_tpu_torch.random.generator`, so the same ``random.seed``
gives the same draws.  The draws are not the JAX package's.
``set_monitor_callback`` hands every op node's outputs of each forward
to a callback (``Monitor``) as the interpreter makes them, named
``<node>_output`` or ``<node>_output<i>``, before the interpreter drops
them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .context import as_device, current_context
from .ndarray.ndarray import NDArray, torch_dtype
from .ops import registry as _reg
from .symbol.symbol import Symbol, _topo_sort, node_num_outputs
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
    generator=None, grad=None, collect=None) -> (outs, new_aux)``.

    ``arg_vals``/``aux_vals`` follow ``list_arguments()`` /
    ``list_auxiliary_states()``.  ``device`` (default: the first argument's
    device) is handed to ops that create a tensor from no input, and
    ``generator`` to ops that draw random numbers (``run.needs_rng`` says
    whether the graph has one; it then raises without a generator).
    ``collect(node, outputs)`` is called with each op node's visible
    outputs as soon as the node has run.

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
    # each value is dropped from the run's environment after the last
    # node that reads it (heads are kept), so that a forward holds only
    # the activations autograd saves and those still to be read
    last_read = {}
    for k, n in enumerate(nodes):
        for src, i in n.inputs:
            last_read[(id(src), i)] = k
    needed = set(last_read) | {(id(h), i) for h, i in heads}
    for h, i in heads:
        last_read.pop((id(h), i), None)
    dead_after = [[] for _ in nodes]
    for key, k in last_read.items():
        dead_after[k].append(key)

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
            generator=None, grad=None, collect=None):
        with torch.set_grad_enabled(bool(is_train if grad is None
                                         else grad)):
            return _run(arg_vals, aux_vals, is_train, device, generator,
                        collect)

    def _run(arg_vals, aux_vals, is_train, device, generator, collect):
        if device is None:
            if not arg_vals:
                raise MXNetError("run: no arguments to take a device "
                                 "from; pass device=")
            device = arg_vals[0].device
        env = {}
        new_aux = list(aux_vals)
        for k, n in enumerate(nodes):
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
                if (id(n), i) in needed:
                    env[(id(n), i)] = o
            if collect is not None:
                collect(n, outs[:node_num_outputs(n)])
            for key in dead_after[k]:
                env.pop(key, None)
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
    ``args_grad``: the arrays the backward writes the gradients into, as
    a list or a dict (a missing one is allocated by the first backward).
    ``grad_req``: ``write``, ``add`` or ``null``, one for all or per
    argument.  ``group2ctx`` (the reference's model-parallel placement
    of ``ctx_group`` attributes) is accepted and places every group on
    the executor's one device, as the JAX package places it on its one
    mesh; ``shared_exec`` (the reference's memory sharing with another
    executor) is accepted and changes nothing, as in the JAX package:
    the caching allocator shares the memory."""

    def __init__(self, symbol: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None, group2ctx=None,
                 shared_exec=None, compute_dtype=None):
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
        # gradient arrays: the caller's args_grad, simple_bind's, or the
        # first backward's
        self.grad_arrays = self._canon_grads(args_grad, arg_names)
        self._out_arrays: Optional[List[NDArray]] = None
        # (leaf tensors by arg position, outputs) of the last training
        # forward whose graph the backward has not consumed yet
        self._graph = None
        self._monitor_callback = None
        self._monitor_all = False

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

    @staticmethod
    def _canon_grads(args_grad, names):
        if args_grad is None:
            return [None] * len(names)
        if isinstance(args_grad, dict):
            grads = [args_grad.get(n) for n in names]
        else:
            grads = list(args_grad)
            if len(grads) != len(names):
                raise MXNetError("bind: args_grad length mismatch")
        return [g if g is None or isinstance(g, NDArray) else NDArray(g)
                for g in grads]

    @classmethod
    def simple_bind(cls, symbol: Symbol, ctx=None, grad_req="write",
                    type_dict=None, shared_exec=None, shapes=None,
                    compute_dtype=None):
        """Infer every shape from the given input shapes and allocate
        zeroed argument, gradient and auxiliary arrays on ``ctx``'s
        device (reference: MXExecutorSimpleBind).  ``type_dict`` gives
        dtypes by name (default float32); ``shared_exec`` is accepted and
        changes nothing, as in the JAX package."""
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
    def output_dict(self) -> Dict[str, NDArray]:
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    @property
    def symbol(self):
        return self._symbol

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
        collect = None if self._monitor_callback is None else self._collect
        with _prof.scope("executor_forward" if collect is None
                         else "executor_forward_monitored", "symbolic"):
            outs, new_aux = self._run(
                vals, [a._data for a in self.aux_arrays], is_train=is_train,
                device=self._device, generator=self._gen, collect=collect)
        if is_train:
            for a, v in zip(self.aux_arrays, new_aux):
                a._set_data(v.detach())
        self._out_arrays = [NDArray(o.detach()) for o in outs]
        self._graph = (leaves, outs) if (is_train and leaves) else None
        return self._out_arrays

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the outputs, seeded with ones (the JAX package's
        head cotangent; loss heads ignore it) or with ``out_grads``,
        written into ``grad_arrays`` per ``grad_req``.  The backward
        consumes the last training forward's graph; without one (after
        an inference forward, or a second backward) it runs a training
        forward first.  ``is_train`` is the reference's signature and,
        as in the JAX package, changes nothing."""
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
        with _prof.scope("executor_backward", "symbolic"):
            grads = torch.autograd.grad(
                heads, [leaves[i] for i in pos], cts,
                allow_unused=True) if heads else [None] * len(pos)
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

    def debug_str(self):
        """The graph's outputs and nodes, one a line (the JAX package's
        format)."""
        lines = [f"Symbol outputs: {self._symbol.list_outputs()}"]
        for n in self._symbol.nodes():
            if n.is_variable:
                lines.append(f"Variable:{n.name}")
            else:
                lines.append(f"Op:{n.op}, Name={n.name}")
        return "\n".join(lines)

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` with every op node's outputs
        of each forward (reference: GraphExecutor::SetMonitorCallback,
        graph_executor.cc:120).  The arrays are detached from autograd's
        graph; ``None`` removes the callback."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def _collect(self, node, outs):
        cb = self._monitor_callback
        for i, o in enumerate(outs):
            name = (node.name + "_output" if len(outs) == 1
                    else f"{node.name}_output{i}")
            cb(name, NDArray(o.detach()))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """An executor over the same graph for the input shapes in
        ``kwargs`` (reference: executor.py reshape).  Every argument,
        gradient and auxiliary array whose shape does not change is the
        same NDArray object in both executors (parameters, optimizer
        state keyed on them, ``grad_req`` and the random stream carry
        over).  The shapes are inferred with every argument that
        ``kwargs`` does not name held at its old shape, so a conflict
        (an FC weight behind a flatten whose input grew) raises instead
        of zeroing a trained weight, as the JAX package's and the
        reference's reshape do.  With ``partial_shaping=True`` such
        arguments and auxiliary states may change shape, and are then
        new zeros of the same dtype."""
        given = {k: tuple(v) for k, v in kwargs.items()}
        if partial_shaping:
            try:
                arg_shapes, _, aux_shapes = self._symbol._infer_shape_impl(
                    partial=True, **given)
            except MXNetError:
                raise
            except Exception as e:
                raise MXNetError(f"reshape: infer_shape error: {e}")
        else:
            held = {n: tuple(a.shape) for n, a in
                    zip(self._arg_names, self.arg_arrays) if n not in given}
            arg_shapes, _, aux_shapes = self._symbol.infer_shape(
                **held, **given)
        # what the new shapes do not determine keeps its shape
        arg_shapes = [tuple(a.shape) if s is None else tuple(s)
                      for a, s in zip(self.arg_arrays, arg_shapes)]
        aux_shapes = [tuple(a.shape) if s is None else tuple(s)
                      for a, s in zip(self.aux_arrays,
                                      aux_shapes or [None] * len(
                                          self.aux_arrays))]
        changed = [n for n, a, s in zip(self._arg_names + self._aux_names,
                                        self.arg_arrays + self.aux_arrays,
                                        arg_shapes + aux_shapes)
                   if n not in given and tuple(a.shape) != s]
        if changed and not partial_shaping:
            raise MXNetError(
                f"reshape: the shape of unspecified arrays {changed} "
                "changed; pass partial_shaping=True to allocate new ones")

        def keep_or_new(old, shape, changed):
            if old is not None and not changed \
                    and tuple(old.shape) == tuple(shape):
                return old
            return NDArray(torch.zeros(tuple(shape),
                                       dtype=old._data.dtype,
                                       device=self._device))

        new = Executor.__new__(Executor)
        new.__dict__.update(self.__dict__)
        new.arg_arrays = [keep_or_new(a, s, n in kwargs) for n, a, s in
                          zip(self._arg_names, self.arg_arrays, arg_shapes)]
        new.grad_arrays = [
            None if g is None else keep_or_new(g, s, False)
            for g, s in zip(self.grad_arrays, arg_shapes)]
        new.aux_arrays = [keep_or_new(a, s, False)
                          for a, s in zip(self.aux_arrays, aux_shapes)]
        new._out_arrays = None
        new._graph = None
        return new

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


def fused_dist_knobs(k):
    """``(chunk_size, staleness)`` of the chunked dist_async drivers
    (``MXNET_KVSTORE_FUSED_CHUNK``, ``MXNET_KVSTORE_FUSED_STALENESS``),
    one reader for Module and Trainer."""
    from .base import env
    chunk = max(1, min(k, int(env("MXNET_KVSTORE_FUSED_CHUNK", 8))))
    staleness = max(0, int(env("MXNET_KVSTORE_FUSED_STALENESS", 1)))
    return chunk, staleness


def drive_chunked_dist(num_steps, chunk_size, staleness, dispatch_chunk,
                       ship_chunk):
    """The chunked dist_async driver (JAX package ``executor.py:223``):
    overlap the kvstore wire behind the compute.  ``num_steps`` splits
    into ceil(num_steps / chunk_size) chunks; per chunk ``j``:

    1. if chunk ``j-1-staleness`` has a wire round in flight, block on it
       and hand its pulled weights to ``dispatch_chunk`` for adoption
       (staleness 0 is a barrier'd chunk boundary; with S >= 1 the round
       has had S chunks of compute to resolve),
    2. ``dispatch_chunk(j, lo, hi, adopted) -> grads`` runs steps [lo, hi)
       and returns their per-step gradients,
    3. ``ship_chunk(j, grads) -> handle`` pushes them (fire and forget)
       and enqueues the next pull; ``handle.wait() -> {name: host
       array}`` resolves it.

    The lag is exact: chunk ``j`` adopts the round issued after chunk
    ``j-1-staleness``'s pushes.  Returns the final round's pulled values
    (the servers' weights at the sync point), or None for 0 steps."""
    import math
    from . import tracing as _tr
    from . import health as _health
    n_chunks = math.ceil(num_steps / chunk_size)
    pending = {}
    for j in range(n_chunks):
        _health.note_progress("fused.chunk")
        with _tr.span("fused.chunk", cat="fused", args={"chunk": j}):
            due = j - 1 - staleness
            if due in pending:
                with _tr.span("fused.adopt_wait", cat="fused",
                              args={"due": due}):
                    adopted = pending.pop(due).wait()
            else:
                adopted = None
            lo = j * chunk_size
            hi = min(num_steps, lo + chunk_size)
            with _tr.span("fused.chunk_compute", cat="fused",
                          args={"lo": lo, "hi": hi}):
                grads = dispatch_chunk(j, lo, hi, adopted)
            pending[j] = ship_chunk(j, grads)
    final = None
    for j in sorted(pending):
        with _tr.span("fused.drain_wait", cat="fused", args={"chunk": j}):
            final = pending[j].wait()
    return final
