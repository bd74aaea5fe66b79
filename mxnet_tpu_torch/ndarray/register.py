"""Generate the ``nd.*`` namespace from the op registry.

PyTorch counterpart of ``mxnet_tpu/ndarray/register.py`` (reference:
python/mxnet/ndarray/register.py ``_make_ndarray_function``): one closure
an op name, which places positional and keyword array inputs in the
op's argument order and dispatches through ``_invoke``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import registry as _reg
from .ndarray import NDArray, _invoke


def _is_tensor(x):
    return isinstance(x, (NDArray, np.ndarray, torch.Tensor))


def make_op_func(opdef: _reg.OpDef, name: str):
    def op_func(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)  # a symbol's name; meaningless eagerly
        if len(args) == 1 and isinstance(args[0], (list, tuple)) \
                and opdef.variadic:
            args = tuple(args[0])
        if opdef.variadic:
            return _invoke(opdef.name, [a for a in args if a is not None],
                           kwargs, out=out)
        names = (opdef.arg_names or []) + (opdef.aux_names or [])
        supplied = {an: kwargs.pop(an) for an in list(kwargs)
                    if an in names and (_is_tensor(kwargs[an])
                                        or kwargs[an] is None)}
        pos = list(args)
        inputs = []
        for nm in names:
            if nm in supplied:
                inputs.append(supplied[nm])
            elif pos:
                inputs.append(pos.pop(0))
            else:
                inputs.append(None)
        inputs.extend(pos)
        # an optional input left out (a bias, LeakyReLU's gamma) is
        # dropped, and the op's own default takes its place
        inputs = [i for i in inputs if i is not None]
        return _invoke(opdef.name, inputs, kwargs, out=out)

    op_func.__name__ = name
    op_func.__doc__ = _reg.build_op_doc(opdef, name, flavor="nd")
    return op_func


def init_ndarray_module(namespace: dict):
    for name in _reg.list_ops():
        namespace.setdefault(name, make_op_func(_reg.get(name), name))
