"""Generate the ``sym.*`` namespace from the op registry.

PyTorch counterpart of ``mxnet_tpu/symbol/register.py`` (reference:
python/mxnet/symbol/register.py codegen over MXSymbolCreateAtomicSymbol +
Compose).
"""
from __future__ import annotations

from ..ops import registry as _reg
from .symbol import Symbol, _compose, _skip_args


def make_sym_func(opdef: _reg.OpDef, name: str):
    def sym_func(*args, **kwargs):
        sym_name = kwargs.pop("name", None)
        user_attr = kwargs.pop("attr", None)
        if len(args) == 1 and isinstance(args[0], (list, tuple)) \
                and opdef.variadic:
            args = tuple(args[0])
        if opdef.variadic:
            inputs = [a for a in args if isinstance(a, Symbol)]
            attrs = {k: v for k, v in kwargs.items()
                     if not isinstance(v, Symbol)}
            inputs += [v for v in kwargs.values() if isinstance(v, Symbol)]
            return _compose(opdef.name, inputs, attrs, sym_name,
                            user_attr=user_attr)
        attrs = {}
        supplied = {}
        for k, v in kwargs.items():
            if isinstance(v, Symbol):
                supplied[k] = v
            else:
                attrs[k] = v
        skip = _skip_args(opdef.name, attrs)
        wanted = [a for a in (opdef.arg_names or []) + (opdef.aux_names or [])
                  if a not in skip]
        pos = list(args)
        inputs = []
        for nm in wanted:
            if nm in supplied:
                inputs.append(supplied.pop(nm))
            elif pos:
                inputs.append(pos.pop(0))
            else:
                break  # the rest become auto-created variables in _compose
        inputs.extend(pos)
        return _compose(opdef.name, inputs, attrs, sym_name,
                        user_attr=user_attr)

    sym_func.__name__ = name
    sym_func.__doc__ = _reg.build_op_doc(opdef, name)
    return sym_func


def init_symbol_module(namespace: dict):
    for name in _reg.list_ops():
        namespace.setdefault(name, make_sym_func(_reg.get(name), name))
