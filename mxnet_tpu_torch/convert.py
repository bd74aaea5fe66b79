"""Carry parameters between the JAX package (as numpy) and this package.

Parameter names and layouts are the same in both packages (an FC weight
is (out, in), an embedding (vocab, d)), so conversion moves values; it
still checks every name and shape: against this package's symbol for
``Module`` parameters, against a Gluon ``ParameterDict`` for a Gluon
net's (``collect_params()`` of the same construction in either package
holds the same names).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import as_device


def params_from_numpy(arg_params: Dict[str, np.ndarray],
                      aux_params: Dict[str, np.ndarray], ctx, symbol,
                      input_shapes: Dict[str, tuple]
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """Turn ``{name: numpy array}`` parameter dicts (e.g.
    ``{k: v.asnumpy()}`` of the JAX package's) into tensors on ``ctx``'s
    device.

    ``input_shapes`` gives the full shapes (batch included) of the
    symbol's non-parameter inputs (data, labels); every other argument of
    ``symbol`` must be in ``arg_params`` with the shape ``infer_shape``
    gives it, and every auxiliary state in ``aux_params``.  A missing,
    extra or mis-shaped parameter raises."""
    device = as_device(ctx)
    aux_params = dict(aux_params or {})
    arg_shapes, _, aux_shapes = symbol.infer_shape(**input_shapes)
    want = {n: s for n, s in zip(symbol.list_arguments(), arg_shapes)
            if n not in input_shapes}
    want_aux = dict(zip(symbol.list_auxiliary_states(), aux_shapes))
    out = []
    for kind, given, expect in (("argument", dict(arg_params), want),
                                ("auxiliary state", aux_params, want_aux)):
        missing = sorted(set(expect) - set(given))
        extra = sorted(set(given) - set(expect))
        if missing or extra:
            raise MXNetError(f"params_from_numpy: {kind} names differ "
                             f"from the symbol's: missing {missing}, "
                             f"extra {extra}")
        tensors = {}
        for name, shape in expect.items():
            arr = np.asarray(given[name])
            if tuple(arr.shape) != tuple(shape):
                raise MXNetError(f"params_from_numpy: {name!r} has shape "
                                 f"{tuple(arr.shape)}, the symbol wants "
                                 f"{tuple(shape)}")
            tensors[name] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(device)
        out.append(tensors)
    return out[0], out[1]


def gluon_params_to_numpy(params) -> Dict[str, np.ndarray]:
    """``{name: numpy array}`` of a Gluon ``ParameterDict`` of either
    package (every parameter initialized), running statistics included."""
    return {name: np.asarray(p.data().asnumpy())
            for name, p in params.items()}


def gluon_params_from_numpy(params, values: Dict[str, np.ndarray],
                            ctx=None) -> None:
    """Set every parameter of this package's Gluon ``ParameterDict``
    from ``values`` (e.g. :func:`gluon_params_to_numpy` of the JAX
    package's net), on each parameter's device and in its dtype; a
    parameter still waiting for its shape (deferred) takes the value's
    shape and ``ctx``.  A missing, extra or mis-shaped name raises."""
    missing = sorted(set(params.keys()) - set(values))
    extra = sorted(set(values) - set(params.keys()))
    if missing or extra:
        raise MXNetError(f"gluon_params_from_numpy: names differ: missing "
                         f"{missing}, extra {extra}")
    for name, p in params.items():
        v = np.asarray(values[name])
        if p._data is None:
            p._load_init(v, ctx)
            continue
        if tuple(v.shape) != tuple(p.shape):
            raise MXNetError(f"gluon_params_from_numpy: {name!r} has shape "
                             f"{tuple(v.shape)}, the parameter "
                             f"{tuple(p.shape)}")
        p.set_data(v)
