"""Gluon Block / HybridBlock / SymbolBlock.

PyTorch counterpart of ``mxnet_tpu/gluon/block.py`` (reference:
python/mxnet/gluon/block.py, Block :120, HybridBlock :305, SymbolBlock
:497).  Name scopes give the JAX package's parameter names for the same
construction order (the ``NameManager`` counter, then per-scope
counters), so a ``save_params`` file of one package loads into the other.

Imperatively, ``hybrid_forward(F=nd, ...)`` runs op by op through the
dispatcher.  ``hybridize()`` traces ``hybrid_forward(F=symbol, ...)``
into a Symbol once per input signature (shapes and dtypes) and runs it
through :func:`mxnet_tpu_torch.executor.build_interpreter`; PyTorch runs
eagerly, so there is no compile step, and under ``autograd.record()``
torch autograd records the interpreter's ops.  Training mode follows
``autograd.is_training()``: BatchNorm normalises with the batch's
statistics and its new moving statistics are written back into the
parameters only then.  ``hybridize(compute_dtype="bfloat16")`` runs the
graph under the executor's mixed-precision policy over fp32 parameters,
as ``Module(compute_dtype=...)`` does.
"""
from __future__ import annotations

import re
from typing import Dict, List

from ..base import MXNetError
from .. import name as _name_mod
from ..ndarray import NDArray
from .. import autograd
from .. import profiler as _prof
from .. import random as _random
from .parameter import Parameter, ParameterDict, DeferredInitializationError


class _BlockScope:
    """Name scoping for Blocks (reference: block.py:33 _BlockScope)."""
    _current = None

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = _BlockScope._current
        if current is None:
            if prefix is None:
                prefix = _name_mod.current().get(None, hint) + '_'
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = f'{hint}{count}_'
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        self._old_scope = _BlockScope._current
        _BlockScope._current = self
        return self

    def __exit__(self, *a):
        _BlockScope._current = self._old_scope


class Block:
    """Base class of all layers and models (reference: block.py:120)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ''
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith('_') \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children: List[Block] = []
        self._reg_params: Dict[str, Parameter] = {}

    def _alias(self):
        return self.__class__.__name__.lower()

    def __repr__(self):
        modstr = '\n'.join(f'  ({i}): {_indent(repr(b), 2)}'
                           for i, b in enumerate(self._children))
        return f'{self.__class__.__name__}(\n{modstr}\n)'

    def __setattr__(self, name, value):
        """Registers children and parameters (reference: block.py:180)."""
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(
                    f"Changing attribute type for {name!r} from "
                    f"{type(existing)} to {type(value)} is not allowed.")
            if isinstance(existing, Block) and isinstance(value, Block):
                self._children[self._children.index(existing)] = value
                super().__setattr__(name, value)
                return
        if isinstance(value, Block):
            self.register_child(value)
        elif isinstance(value, Parameter):
            assert name not in self._reg_params or \
                self._reg_params[name] is value, \
                "Overriding Parameter attribute %s is not allowed." % name
            self._reg_params[name] = value
        super().__setattr__(name, value)

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None) -> ParameterDict:
        """Every Parameter of this block and its children, optionally
        those whose name matches the regex ``select``."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self.params)
        else:
            pat = re.compile(select)
            ret.update({k: v for k, v in self.params.items()
                        if pat.match(k)})
        for child in self._children:
            ret.update(child.collect_params(select))
        return ret

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        from .. import initializer as init_mod
        self.collect_params().initialize(
            init or init_mod.Uniform(), ctx, verbose,
            force_reinit=force_reinit)

    def hybridize(self, active=True, **kwargs):
        for child in self._children:
            child.hybridize(active, **kwargs)

    def cast(self, dtype):
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def save_params(self, filename):
        """reference: block.py save_params."""
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        """reference: block.py load_params."""
        self.collect_params().load(filename, ctx, allow_missing,
                                   ignore_extra, self.prefix)

    def __call__(self, *args):
        return self.forward(*args)

    def forward(self, *args):
        raise NotImplementedError

    def summary(self, *inputs):
        """Per-layer output shapes."""
        lines = [f"{'Layer':<40}{'Output':<24}"]
        x = inputs[0]
        for c in self._children:
            x = c(x)
            lines.append(f"{c.name:<40}{str(getattr(x, 'shape', '?')):<24}")
        return '\n'.join(lines)


def _indent(s, n):
    return ('\n' + ' ' * n).join(s.split('\n'))


class _CachedGraph:
    """The CachedOp counterpart: the Symbol traced from hybrid_forward
    and its interpreter, for one input signature (reference: cached_op.cc
    GetForwardGraph)."""

    def __init__(self, sym, data_names, compute_dtype=None):
        from ..executor import build_interpreter
        self.sym = sym
        self.run, self.arg_names, self.aux_names = build_interpreter(
            sym, compute_dtype=compute_dtype)
        self.data_names = data_names


class HybridBlock(Block):
    """reference: block.py:305 HybridBlock."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graphs: Dict[tuple, _CachedGraph] = {}
        self._flags = {}

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._flags = kwargs
        self._cached_graphs = {}
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._cached_graphs = {}
        super().cast(dtype)

    def infer_shape(self, *args):
        """Finish the deferred initialization of this block's parameters
        from the input shapes (reference: block.py infer_shape)."""
        self._deferred_infer(args)

    def _deferred_infer(self, args):
        from .. import symbol as sym_mod
        with autograd.pause():
            inputs = [sym_mod.Variable(f'data{i}')
                      for i in range(len(args))]
            try:
                out = self.hybrid_forward(
                    sym_mod, *inputs,
                    **{n: p.var() for n, p in self._reg_params.items()})
            except DeferredInitializationError:
                raise MXNetError(
                    f"{self.name}: cannot infer shapes symbolically")
            out = _flatten_output(out)
            grouped = sym_mod.Group(out) if len(out) > 1 else out[0]
            _finish_deferred(self.collect_params(), grouped,
                             {f'data{i}': tuple(a.shape)
                              for i, a in enumerate(args)})

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            from .. import ndarray as nd_mod
            if any(p._deferred_init is not None
                   for p in self._reg_params.values()):
                self._deferred_infer((x,) + args)
            if self._active:
                return self._call_cached(x, *args)
            pdata = {n: p.data() for n, p in self._reg_params.items()}
            return self.hybrid_forward(nd_mod, x, *args, **pdata)
        from .. import symbol as sym_mod
        pvars = {n: p.var() for n, p in self._reg_params.items()}
        return self.hybrid_forward(sym_mod, x, *args, **pvars)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    # -- the hybridized path -----------------------------------------------
    def _trace_symbol(self, n_inputs):
        from .. import symbol as sym_mod
        inputs = [sym_mod.Variable(f'data{i}') for i in range(n_inputs)]
        out = _flatten_output(self(*inputs))
        sym = sym_mod.Group(out) if len(out) > 1 else out[0]
        return sym, [f'data{i}' for i in range(n_inputs)]

    def _call_cached(self, *args):
        params = self.collect_params()
        sig = tuple((tuple(a.shape), str(a.dtype)) for a in args)
        cg = self._cached_graphs.get(sig)
        if cg is None:
            sym, data_names = self._trace_symbol(len(args))
            cg = _CachedGraph(sym, data_names,
                              compute_dtype=self._flags.get('compute_dtype'))
            self._cached_graphs[sig] = cg
        if any(p._deferred_init is not None for p in params.values()):
            _finish_deferred(params, cg.sym,
                             {dn: tuple(a.shape)
                              for dn, a in zip(cg.data_names, args)})
        by_name = dict(zip(cg.data_names, args))
        arrays = [by_name[n] if n in by_name else params[n].data()
                  for n in cg.arg_names]
        recording = autograd.is_recording()
        is_train = autograd.is_training()
        vals = [autograd.variable_tensor(a) if recording else a._data
                for a in arrays]
        aux_arrays = [params[n].data() for n in cg.aux_names]
        device = args[0]._data.device
        gen = _random.device_generator(device) if cg.run.needs_rng \
            else None
        _prof.record_dispatch("gluon.cached_forward")
        outs, new_aux = cg.run(vals, [a._data for a in aux_arrays],
                               is_train=is_train, device=device,
                               generator=gen, grad=recording)
        if is_train:
            for a, v in zip(aux_arrays, new_aux):
                a._set_data(v.detach())
        out_arrays = [NDArray(o) for o in outs]
        return out_arrays[0] if len(out_arrays) == 1 else out_arrays

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (``arg:`` /
        ``aux:`` keys), which ``Module.load`` of either package reads."""
        if not self._cached_graphs:
            raise MXNetError("run forward at least once before export()")
        cg = next(iter(self._cached_graphs.values()))
        cg.sym.save(f'{path}-symbol.json')
        from .. import serialization
        params = self.collect_params()
        arg = {'arg:' + n: params[n].data() for n in cg.arg_names
               if n not in cg.data_names}
        arg.update({'aux:' + n: params[n].data() for n in cg.aux_names})
        serialization.save_ndarrays('%s-%04d.params' % (path, epoch), arg)


def _finish_deferred(params, sym, data_shapes):
    """Finish the deferred initialization of ``params`` from the shapes
    ``sym`` infers from ``data_shapes``."""
    arg_shapes, _, aux_shapes = sym.infer_shape_partial(**data_shapes)
    shape_of = dict(zip(sym.list_arguments(), arg_shapes or []))
    shape_of.update(zip(sym.list_auxiliary_states(), aux_shapes or []))
    for p in params.values():
        if p._deferred_init is not None and shape_of.get(p.name):
            p._finish_deferred_init(shape_of[p.name])


def _flatten_output(out):
    if isinstance(out, (list, tuple)):
        res = []
        for o in out:
            res.extend(_flatten_output(o))
        return res
    return [out]


class SymbolBlock(HybridBlock):
    """Wrap an existing Symbol as a callable block (reference:
    block.py:497).  The graph runs in inference mode."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        # the symbol's variable names are the parameter names
        self._params = ParameterDict('', params)
        from .. import symbol as sym_mod
        if isinstance(inputs, sym_mod.Symbol):
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(list(outputs))
        self._output_sym = outputs
        self._input_names = [i.name for i in inputs]
        for n in outputs.list_arguments() + outputs.list_auxiliary_states():
            if n not in self._input_names:
                self.params.get(n, allow_deferred_init=True,
                                grad_req='null')
        self._cached = None

    def forward(self, *args):
        from ..executor import build_interpreter
        params = self.collect_params()
        if self._cached is None:
            self._cached = build_interpreter(self._output_sym)
        run, arg_names, aux_names = self._cached
        by_name = dict(zip(self._input_names, args))
        recording = autograd.is_recording()
        vals = [autograd.variable_tensor(a) if recording else a._data
                for a in (by_name[n] if n in by_name else params[n].data()
                          for n in arg_names)]
        aux = [params[n].data()._data for n in aux_names]
        device = args[0]._data.device
        outs, _ = run(vals, aux, is_train=False, device=device,
                      generator=(_random.device_generator(device)
                                 if run.needs_rng else None),
                      grad=recording)
        outs = [NDArray(o) for o in outs]
        return outs[0] if len(outs) == 1 else outs
