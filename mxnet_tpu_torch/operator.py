"""Custom operators defined in Python (reference: python/mxnet/operator.py
CustomOp / CustomOpProp / register, src/operator/custom/custom.cc).

PyTorch counterpart of ``mxnet_tpu/operator.py``: the same classes and
registry.  The ``Custom`` op (``ops/custom.py``) runs the user's numpy
``forward`` and ``backward`` on host copies of the tensors, as the JAX
package's ``pure_callback`` does, inside a ``torch.autograd.Function``
that saves the real outputs for ``backward``, gives the auxiliary states
no gradient and copies the results back to the inputs' device.  As in
the reference, a custom op costs a round trip through the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .base import MXNetError


class CustomOp:
    """Base class for operator implementations
    (reference: operator.py:466 CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """reference: operator.py CustomOp.assign."""
        if req == 'null':
            return
        if req in ('write', 'inplace'):
            dst[:] = src
        elif req == 'add':
            dst[:] += src


class CustomOpProp:
    """Operator metadata: shapes/types/state
    (reference: operator.py:533 CustomOpProp)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return in_type, [in_type[0]] * len(self.list_outputs()), []

    def list_arguments(self):
        return ['data']

    def list_outputs(self):
        return ['output']

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


_PROP_REGISTRY: Dict[str, type] = {}


def register(reg_name):
    """Class decorator registering a CustomOpProp
    (reference: operator.py:743 register / MXCustomOpRegister)."""
    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("can only register subclasses of CustomOpProp")
        _PROP_REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_prop_cls(op_type):
    if op_type not in _PROP_REGISTRY:
        raise MXNetError(
            f"custom op type {op_type!r} is not registered "
            f"(use @mx.operator.register({op_type!r}))")
    return _PROP_REGISTRY[op_type]


def _make_prop(op_type, attrs):
    kwargs = {k: v for k, v in attrs.items()
              if k not in ('op_type',) and not k.startswith('__')}
    return get_prop_cls(op_type)(**kwargs)


def num_outputs_for(attrs):
    return len(_make_prop(attrs.get('op_type', ''), attrs).list_outputs())


class _HostState:
    """The op instance of one call: its forward and its backward see the
    same object, as the reference's stateful dispatch gives them."""

    def __init__(self, prop, in_shapes, in_dtypes):
        self.prop = prop
        self.op = prop.create_operator(None, in_shapes, in_dtypes)


class _NDView:
    """Mutable numpy holder passed to user forward/backward: supports the
    [:] assignment pattern plus asnumpy()."""

    def __init__(self, arr):
        self.arr = np.array(arr, copy=True)

    def __getitem__(self, k):
        return self.arr[k]

    def __setitem__(self, k, v):
        self.arr[k] = np.asarray(v.asnumpy() if hasattr(v, 'asnumpy')
                                 else v)

    @property
    def shape(self):
        return self.arr.shape

    @property
    def dtype(self):
        return self.arr.dtype

    def asnumpy(self):
        return self.arr



# NDArrayOp / NumpyOp legacy aliases (reference: operator.py NDArrayOp —
# older callback op generations; the modern CustomOp covers them)
NDArrayOp = CustomOp
