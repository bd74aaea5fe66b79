"""Testing utilities (reference: python/mxnet/test_utils.py).

PyTorch counterpart of ``mxnet_tpu/test_utils.py``, over the port's
``Executor`` and ``NDArray``: ``check_numeric_gradient``
(test_utils.py:789, finite differences against autograd's gradients),
``check_symbolic_forward`` / ``backward`` (:921, :995, against numpy
references), ``check_consistency`` (:1203, one symbol across contexts
and dtypes, cross-checked) and ``default_context`` (:50), which follows
the port's current context (``with mt.cpu():``) unless
``set_default_context`` fixed one.  Arrays are made on the context the
check runs on.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu, current_context
from .executor import Executor
from .ndarray import NDArray
from .ndarray.ndarray import array as nd_array
from .symbol import Symbol

_default_ctx = None


def default_context() -> Context:
    """reference: test_utils.py:50."""
    return _default_ctx or current_context()


def set_default_context(ctx):
    global _default_ctx
    _default_ctx = ctx


def default_dtype():
    return np.float32


def rand_shape_2d(dim0=10, dim1=10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1))


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return tuple(np.random.randint(1, d + 1) for d in (dim0, dim1, dim2))


def rand_ndarray(shape, stype='default', density=None, dtype=None,
                 ctx=None):
    """reference: test_utils.py rand_ndarray."""
    ctx = ctx or default_context()
    if stype == 'default':
        return nd_array(np.random.uniform(-1, 1, shape).astype(
            dtype or np.float32), ctx=ctx)
    from .ndarray import sparse
    return sparse.rand_sparse_ndarray(shape, stype, density=density,
                                      dtype=dtype, ctx=ctx)[0]


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    """reference: test_utils.py np_reduce."""
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else \
            range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def _parse_tols(dtype, rtol, atol):
    # reference: test_utils.py:68-80 per-dtype default tolerances
    defaults = {np.dtype(np.float16): (1e-2, 1e-4),
                np.dtype(np.float32): (1e-4, 1e-6),
                np.dtype(np.float64): (1e-5, 1e-8)}
    drt, dat = defaults.get(np.dtype(dtype) if dtype else
                            np.dtype(np.float32), (1e-4, 1e-6))
    return rtol if rtol is not None else drt, \
        atol if atol is not None else dat


def assert_almost_equal(a, b, rtol=None, atol=None, names=('a', 'b'),
                        equal_nan=False):
    """reference: test_utils.py:467."""
    a = a.asnumpy() if isinstance(a, NDArray) else np.asarray(a)
    b = b.asnumpy() if isinstance(b, NDArray) else np.asarray(b)
    rtol, atol = _parse_tols(a.dtype, rtol, atol)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                               equal_nan=equal_nan,
                               err_msg=f'{names[0]} vs {names[1]}')


def same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b))


def same_array(array1, array2):
    """Same underlying buffer (reference: test_utils.py same_array)."""
    a, b = array1._data, array2._data
    return a is b or (a.device == b.device and a.numel() > 0
                      and a.data_ptr() == b.data_ptr())


def _nd(value, ctx, dtype=None):
    """An NDArray of a numpy value on ``ctx``, of the value's shape (a
    0-d value stays 0-d: a cotangent of a scalar output)."""
    return NDArray(torch.from_numpy(np.array(value, copy=True)), ctx=ctx,
                   dtype=dtype)


def _set(arr, value):
    """Set an NDArray to a numpy value, on its device, in its dtype."""
    arr._set_data(torch.from_numpy(np.array(value, copy=True)).to(
        device=arr._data.device, dtype=arr._data.dtype))


def _bind(sym, location, aux_states=None, grad_req='write', ctx=None):
    ctx = ctx or default_context()
    arg_names = sym.list_arguments()

    def on_ctx(v):
        if isinstance(v, NDArray):
            return v.as_in_context(ctx)
        return nd_array(np.asarray(v), ctx=ctx)
    if isinstance(location, dict):
        args = {k: on_ctx(v) for k, v in location.items()}
    else:
        args = {n: on_ctx(v) for n, v in zip(arg_names, location)}
    aux = None
    aux_names = sym.list_auxiliary_states()
    if aux_states is not None:
        if isinstance(aux_states, dict):
            aux = {k: on_ctx(v) for k, v in aux_states.items()}
        else:
            aux = {n: on_ctx(v) for n, v in zip(aux_names, aux_states)}
    elif aux_names:
        # the aux shapes from the arguments' (the reference's simple_bind)
        _, _, aux_shapes = sym.infer_shape(
            **{n: tuple(a.shape) for n, a in args.items()})
        aux = {n: nd_array(np.zeros(s, np.float32), ctx=ctx)
               for n, s in zip(aux_names, aux_shapes)}
    ex = Executor(sym, ctx, args=args, grad_req=grad_req, aux_states=aux)
    if grad_req != 'null':
        ex.grad_arrays = [
            nd_array(np.zeros(args[n].shape, np.float32), ctx=ctx,
                     dtype=args[n].dtype)
            if ex.grad_req[n] != 'null' else None for n in arg_names]
    return ex


def simple_forward(sym, ctx=None, is_train=False, **inputs):
    """reference: test_utils.py simple_forward."""
    ex = _bind(sym, inputs, grad_req='null', ctx=ctx)
    outputs = [o.asnumpy() for o in ex.forward(is_train=is_train)]
    return outputs[0] if len(outputs) == 1 else outputs


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True):
    """Finite-difference gradients (reference: test_utils.py:744)."""
    approx_grads = {}
    for k in sorted(location):
        val = location[k]
        if not np.issubdtype(np.asarray(val).dtype, np.floating):
            continue
        old = np.asarray(val, dtype=np.float64).copy()
        grad = np.zeros_like(old).ravel()
        flat = old.ravel()
        for i in range(flat.size):
            base = flat[i]
            flat[i] = base + eps / 2
            _set(executor.arg_dict[k], old.astype(np.float32))
            fp = executor.forward(is_train=use_forward_train)
            fplus = fp[0].asnumpy().sum()
            flat[i] = base - eps / 2
            _set(executor.arg_dict[k], old.astype(np.float32))
            fm = executor.forward(is_train=use_forward_train)
            fminus = fm[0].asnumpy().sum()
            grad[i] = (fplus - fminus) / eps
            flat[i] = base
        _set(executor.arg_dict[k], old.astype(np.float32))
        approx_grads[k] = grad.reshape(old.shape)
    return approx_grads


def check_numeric_gradient(sym, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, use_forward_train=True,
                           ctx=None, grad_stype_dict=None,
                           dtype=np.float32):
    """Finite-difference vs autodiff gradients
    (reference: test_utils.py:789)."""
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    location = {k: np.asarray(v, dtype=dtype) for k, v in location.items()}
    if grad_nodes is None:
        grad_nodes = [k for k, v in location.items()
                      if np.issubdtype(np.asarray(v).dtype, np.floating)]

    # random projection to a scalar head so d(head)/dx is well defined
    # (reference builds sum(out * random_proj))
    out = sym
    ex = _bind(out, location, aux_states, ctx=ctx)
    outs = ex.forward(is_train=use_forward_train)
    proj = [np.asarray(np.random.uniform(-1, 1, o.shape), dtype)
            for o in outs]
    ex.backward(out_grads=[_nd(p, ex._ctx) for p in proj])
    sym_grads = {k: ex.grad_dict[k].asnumpy() for k in grad_nodes
                 if ex.grad_dict.get(k) is not None}

    # numeric: f = sum(out_i * proj_i) over one bound executor, with only
    # the perturbed argument swapped
    def f_of(k, arr):
        _set(ex.arg_dict[k], arr.astype(dtype))
        os_ = ex.forward(is_train=use_forward_train)
        return sum(float((o.asnumpy() * p).sum())
                   for o, p in zip(os_, proj))

    for k in grad_nodes:
        old = location[k].astype(np.float64).copy()
        ngrad = np.zeros_like(old).ravel()
        flat = old.ravel()
        for i in range(flat.size):
            base = flat[i]
            flat[i] = base + numeric_eps / 2
            fplus = f_of(k, old)
            flat[i] = base - numeric_eps / 2
            fminus = f_of(k, old)
            ngrad[i] = (fplus - fminus) / numeric_eps
            flat[i] = base
        _set(ex.arg_dict[k], old.astype(dtype))
        ngrad = ngrad.reshape(old.shape)
        assert_almost_equal(ngrad, sym_grads[k], rtol=rtol,
                            atol=atol if atol is not None else 1e-4,
                            names=(f'numeric_{k}', f'symbolic_{k}'))


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=None,
                           aux_states=None, ctx=None, dtype=np.float32,
                           equal_nan=False):
    """reference: test_utils.py:921."""
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    location = {k: np.asarray(v, dtype=dtype)
                if np.issubdtype(np.asarray(v).dtype, np.floating)
                else np.asarray(v) for k, v in location.items()}
    ex = _bind(sym, location, aux_states, grad_req='null', ctx=ctx)
    outputs = ex.forward(is_train=False)
    if isinstance(expected, dict):
        expected = [expected[n] for n in sym.list_outputs()]
    for out, exp in zip(outputs, expected):
        assert_almost_equal(out, exp, rtol=rtol, atol=atol,
                            names=('output', 'expected'),
                            equal_nan=equal_nan)
    return [o.asnumpy() for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected,
                            rtol=1e-5, atol=None, aux_states=None,
                            grad_req='write', ctx=None, dtype=np.float32,
                            equal_nan=False):
    """reference: test_utils.py:995."""
    if isinstance(location, (list, tuple)):
        location = dict(zip(sym.list_arguments(), location))
    location = {k: np.asarray(v, dtype=dtype)
                if np.issubdtype(np.asarray(v).dtype, np.floating)
                else np.asarray(v) for k, v in location.items()}
    ex = _bind(sym, location, aux_states, grad_req=grad_req, ctx=ctx)
    ex.forward(is_train=True)
    ex.backward(out_grads=[_nd(np.asarray(g, dtype=dtype), ex._ctx)
                           for g in out_grads])
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym.list_arguments(), expected))
    grads = {k: v.asnumpy() for k, v in ex.grad_dict.items()
             if v is not None}
    for name, exp in expected.items():
        assert_almost_equal(grads[name], exp, rtol=rtol, atol=atol,
                            names=(f'grad_{name}', f'expected_{name}'),
                            equal_nan=equal_nan)
    return grads


def check_consistency(sym, ctx_list, scale=1.0, grad_req='write',
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None):
    """Run the symbol on every (ctx, dtype) config and cross-assert
    (reference: test_utils.py:1203 — the GPU/CPU, fp16/fp32 matrix)."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1, np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5}
    elif isinstance(tol, numbers.Number):
        tol = {np.dtype(np.float16): tol, np.dtype(np.float32): tol,
               np.dtype(np.float64): tol}
    assert len(ctx_list) > 1
    if isinstance(sym, Symbol):
        sym = [sym] * len(ctx_list)
    else:
        assert len(sym) == len(ctx_list)

    output_points = sym[0].list_outputs()
    arg_names = sym[0].list_arguments()
    arg_shapes, _, aux_shapes = sym[0].infer_shape(
        **{k: v for k, v in ctx_list[0].items() if k != 'ctx'
           and k != 'type_dict' and isinstance(v, tuple)})
    rng = np.random.RandomState(0)
    base_args = {n: rng.normal(0, scale, s).astype(np.float64)
                 for n, s in zip(arg_names, arg_shapes)}
    if arg_params:
        base_args.update({k: np.asarray(v, np.float64)
                          for k, v in arg_params.items()})
    base_aux = {n: np.zeros(s) for n, s in
                zip(sym[0].list_auxiliary_states(), aux_shapes)}
    if aux_params:
        base_aux.update({k: np.asarray(v, np.float64)
                         for k, v in aux_params.items()})

    results = []
    dtypes = []
    for s, config in zip(sym, ctx_list):
        ctx = config.get('ctx', default_context())
        type_dict = config.get('type_dict', {})
        dtype = np.dtype(list(type_dict.values())[0]) if type_dict \
            else np.dtype(np.float32)
        dtypes.append(dtype)
        args = {k: v.astype(type_dict.get(k, np.float32))
                for k, v in base_args.items()}
        aux = {k: v.astype(np.float32) for k, v in base_aux.items()}
        ex = _bind(s, args, aux, grad_req=grad_req, ctx=ctx)
        outs = ex.forward(is_train=True)
        # cotangents must match each output's dtype (fp16 configs
        # produce fp16 outputs)
        ex.backward(out_grads=[
            _nd(np.ones(o.shape, np.float32), ctx, dtype=o.dtype)
            for o in outs])
        results.append({
            'outputs': [o.asnumpy().astype(np.float64) for o in outs],
            'grads': {k: v.asnumpy().astype(np.float64)
                      for k, v in ex.grad_dict.items() if v is not None},
        })

    # compare every config against the most precise one
    gt_idx = int(np.argmax([np.dtype(d).itemsize for d in dtypes]))
    gt = ground_truth or results[gt_idx]
    for i, (res, dtype) in enumerate(zip(results, dtypes)):
        if res is gt:
            continue
        t = tol[np.dtype(dtype)]
        try:
            for o, og in zip(res['outputs'], gt['outputs']):
                np.testing.assert_allclose(o, og, rtol=t, atol=t)
            for k in res['grads']:
                np.testing.assert_allclose(res['grads'][k],
                                           gt['grads'][k], rtol=t, atol=t)
        except AssertionError:
            if raise_on_err:
                raise
    return results


def check_speed(sym, location=None, ctx=None, N=20, grad_req='write',
                typ='whole', **kwargs):
    """Time forward(+backward) throughput (reference: test_utils.py:1129)."""
    import time
    if location is None:
        arg_shapes, _, _ = sym.infer_shape(**kwargs)
        location = {k: np.random.normal(size=s, scale=1.0).astype(
            np.float32) for k, s in zip(sym.list_arguments(), arg_shapes)}
    ex = _bind(sym, location, grad_req=grad_req, ctx=ctx)
    if typ == 'whole':
        def run():
            outs = ex.forward(is_train=True)
            ex.backward(out_grads=[
                _nd(np.ones(o.shape, np.float32), ex._ctx) for o in outs])
    elif typ == 'forward':
        def run():
            ex.forward(is_train=False)[0].asnumpy()
    else:
        raise MXNetError(f'typ must be whole/forward, got {typ!r}')
    run()  # warm up
    tic = time.time()
    for _ in range(N):
        run()
    if typ == 'whole':
        ex.grad_dict[sym.list_arguments()[0]].asnumpy()
    return (time.time() - tic) / N


def retry(n):
    """Decorator: retry flaky tests n times (reference: test_utils.py:550)."""
    assert n > 0

    def decorate(f):
        import functools

        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError:
                    if i == n - 1:
                        raise
        return wrapper
    return decorate
