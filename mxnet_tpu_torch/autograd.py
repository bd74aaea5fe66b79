"""Imperative autograd.

PyTorch counterpart of ``mxnet_tpu/autograd.py`` (reference:
python/mxnet/autograd.py, src/imperative/imperative.cc RecordOp /
Backward), built on torch autograd with MXNet's semantics:

- only ops run inside :func:`record` are differentiable: the dispatcher
  (``ndarray._invoke``) runs every other op under ``torch.no_grad``;
- a variable is an NDArray marked by ``attach_grad`` / ``mark_variables``.
  The first recorded op that reads it turns its tensor into a torch leaf
  (``requires_grad``) and notes (leaf, array) here; :func:`backward`
  differentiates the heads with respect to every noted leaf with
  ``torch.autograd.grad`` and writes each result into the array's grad
  NDArray by rebinding it (``grad_req="write"``) or adding to it
  (``"add"``): the grad object itself is never replaced, since
  ``Parameter`` and ``Trainer`` hold it;
- NDArrays are rebound, never written in place, so a variable mutated
  after recording keeps its recorded leaf in the graph, and the gradient
  is that of the recorded value (the JAX package's handle versioning);
- the noted leaves are dropped after a backward unless ``retain_graph``;
  a backward with none noted, or on a head no recorded op produced,
  raises :class:`MXNetError`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

from .base import MXNetError
from . import profiler as _prof


class _State(threading.local):
    def __init__(self):
        super().__init__()
        self.recording = False
        self.training = False
        # id(leaf tensor) -> (NDArray, leaf tensor), in recording order
        self.leaves: Dict[int, Tuple[object, torch.Tensor]] = {}


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_recording: bool) -> bool:
    prev, _state.recording = _state.recording, bool(is_recording)
    return prev


def set_training(train_mode: bool) -> bool:
    prev, _state.training = _state.training, bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)
        return self

    def __exit__(self, *a):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode: bool = True):
    """Scope: record imperative ops for backward."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach grad buffers (reference: MXAutogradMarkVariables)."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v._grad = g if req != "null" else None
        v._grad_req = req


def variable_tensor(arr) -> torch.Tensor:
    """The tensor a recorded op reads from ``arr``: for a marked floating
    array, a torch leaf noted for :func:`backward` (made from its tensor
    at its first recorded read since it was last rebound)."""
    t = arr._data
    if getattr(arr, "_grad", None) is None or arr._grad_req == "null" \
            or not t.is_floating_point():
        return t
    if not t.requires_grad:
        t = t.detach().requires_grad_()
        arr._data = t
    if t.is_leaf:
        _state.leaves.setdefault(id(t), (arr, t))
    return t


def _as_tensors(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is not None and not isinstance(head_grads, (list, tuple)):
        head_grads = [head_grads]
    hts = [h._data for h in heads]
    if any(not t.requires_grad for t in hts):
        raise MXNetError("head output was not produced by the recorded "
                         "graph (record it inside autograd.record())")
    cts = []
    for i, t in enumerate(hts):
        g = None if head_grads is None else head_grads[i]
        if g is None:
            cts.append(torch.ones_like(t))
        else:
            g = g._data if isinstance(g, NDArray) else torch.as_tensor(g)
            cts.append(g.detach().to(device=t.device, dtype=t.dtype))
    return hts, cts


def _grad(hts, inputs, cts, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(hts, inputs, cts,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        raise MXNetError(f"backward: {e}") from None


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Differentiate the heads with respect to every variable a recorded
    op read, writing each gradient into its array's grad buffer."""
    leaves: List[Tuple[object, torch.Tensor]] = list(_state.leaves.values())
    if not leaves:
        raise MXNetError("backward called outside of autograd.record scope "
                         "or no marked (attach_grad) variable was recorded")
    hts, cts = _as_tensors(heads, head_grads)
    _prof.record_dispatch("autograd.backward")
    grads = _grad(hts, [t for _, t in leaves], cts, retain_graph)
    # sum per array: one array may have been read under several leaves
    # (it was rebound between recorded reads)
    total: Dict[int, list] = {}
    for (arr, t), g in zip(leaves, grads):
        if g is None:
            g = torch.zeros_like(t)
        entry = total.setdefault(id(arr), [arr, None])
        entry[1] = g if entry[1] is None else entry[1] + g
    with torch.no_grad():
        for arr, g in total.values():
            buf = arr._grad
            if buf is None:
                continue
            if arr._grad_req == "add":
                buf._set_data(buf._data + g.to(buf._data.dtype))
            else:
                buf._set_data(g.to(buf._data.dtype))
    if not retain_graph:
        _state.leaves = {}


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of the heads with respect to ``variables`` (marked
    arrays read under :func:`record`), as new NDArrays; with
    ``create_graph`` they are themselves differentiable under a later
    :func:`record`."""
    from .ndarray.ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    ins = [v._data for v in variables]
    if any(not t.requires_grad for t in ins):
        raise MXNetError("grad: a variable was not read by a recorded op "
                         "(attach_grad it before autograd.record())")
    hts, cts = _as_tensors(heads, head_grads)
    gs = _grad(hts, ins, cts, retain_graph, create_graph)
    out = [NDArray(torch.zeros_like(t) if g is None
                   else (g if create_graph else g.detach()))
           for t, g in zip(ins, gs)]
    if not retain_graph:
        _state.leaves = {}
    return out[0] if single else out


def get_symbol(x):
    raise MXNetError("autograd.get_symbol is not supported in mxnet_tpu; "
                     "use gluon HybridBlock tracing instead")


class Function:
    """Custom differentiable function (reference: autograd.py:369
    Function).  Subclass and override ``forward`` / ``backward``, which
    take and return NDArrays; under :func:`record` the call is one
    ``torch.autograd.Function`` whose backward runs ``backward``."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        func = self

        def _tuple(x):
            return (x,) if isinstance(x, NDArray) else tuple(x)

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *vals):
                with pause():
                    outs = _tuple(func.forward(*[NDArray(v) for v in vals]))
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    igrads = _tuple(func.backward(*[NDArray(g)
                                                    for g in gs]))
                return tuple(g._data for g in igrads)

        recording = is_recording()
        vals = [variable_tensor(x) if recording else x._data
                for x in inputs]
        with torch.set_grad_enabled(recording):
            outs = _Apply.apply(*vals)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else tuple(outs)
