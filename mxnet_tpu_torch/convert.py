"""Carry parameters from the JAX package (as numpy) into this package.

Parameter names and layouts are the same in both packages (an FC weight
is (out, in), an embedding (vocab, d)), so conversion moves values; it
still checks every name and shape against this package's symbol.
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
