"""The imperative slice's ops and the NDArray of the PyTorch port against
the JAX package, on the same numpy inputs.

Each op the Gluon layers and the NDArray methods run (elemwise, reduce,
indexing, matrix and nn additions) is held against the JAX op, forward
(every output) and gradient (``jax.vjp`` against ``torch.autograd.grad``
of sum(out0 * g) with the same seeded g).  Then the NDArray: operator
overloads, in-place forms, indexing, methods and free functions, run in
both packages (the ported cases of ``tests/test_ndarray.py``).

Tolerance: 1e-5 relative and absolute in float32; both packages compute
in f32 and differ in the order of sums and in the last ulp of the
transcendental functions (XLA's and ATen's exp, log, tanh, erf, lgamma).
Integer and selection results (argsort, topk indices, comparisons, one_hot)
must be equal."""
import os
import pickle
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg
import mxnet_tpu.ops  # noqa: F401  registers the JAX ops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = mt.cpu()


def _tuple(out):
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _compare(name, arrays, attrs, grad=True, seed=0, tol=TOL):
    jfn, tfn = jreg.get(name), treg.get(name)
    jouts = _tuple(jfn(*[jnp.asarray(a) for a in arrays], **attrs))
    tins = [torch.from_numpy(a.copy()) for a in arrays]
    floats = [i for i, a in enumerate(arrays)
              if np.issubdtype(a.dtype, np.floating)]
    if grad:
        for i in floats:
            tins[i].requires_grad_()
    touts = _tuple(tfn(*tins, **attrs))
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        j, t = np.asarray(j), t.detach().numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, (j.shape, t.shape,
                                                           j.dtype, t.dtype)
        np.testing.assert_allclose(t, j, **tol)
    if not grad:
        return
    g = np.asarray(np.random.RandomState(seed + 1).randn(
        *np.shape(jouts[0])), dtype=np.float32)

    def jf(*fl):
        full = [jnp.asarray(a) for a in arrays]
        for i, v in zip(floats, fl):
            full[i] = v
        return _tuple(jfn(*full, **attrs))[0]
    _, vjp = jax.vjp(jf, *[jnp.asarray(arrays[i]) for i in floats])
    jgrads = vjp(jnp.asarray(g))
    tgrads = torch.autograd.grad(touts[0], [tins[i] for i in floats],
                                 torch.from_numpy(g), allow_unused=True) \
        if touts[0].requires_grad else [None] * len(floats)
    for i, jg, tg in zip(floats, jgrads, tgrads):
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, jg, err_msg=f"input {i}", **tol)


R = np.random.RandomState(0)


def _u(lo, hi, *shape):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _n(*shape):
    return R.randn(*shape).astype(np.float32)


# unary ops, on inputs inside each function's domain
UNARY_DOMAIN = {
    "abs": (-2, 2), "sign": (-2, 2), "rint": (-3, 3), "ceil": (-3, 3),
    "floor": (-3, 3), "trunc": (-3, 3), "fix": (-3, 3),
    "square": (-2, 2), "sqrt": (0.1, 3), "rsqrt": (0.1, 3),
    "cbrt": (0.1, 3), "rcbrt": (0.1, 3), "exp": (-2, 2),
    "log": (0.1, 3), "log10": (0.1, 3), "log2": (0.1, 3),
    "log1p": (-0.5, 2), "expm1": (-2, 2), "sin": (-3, 3), "cos": (-3, 3),
    "tan": (-1, 1), "arcsin": (-0.9, 0.9), "arccos": (-0.9, 0.9),
    "arctan": (-3, 3), "sinh": (-2, 2), "cosh": (-2, 2), "tanh": (-2, 2),
    "arcsinh": (-2, 2), "arccosh": (1.1, 3), "arctanh": (-0.9, 0.9),
    "degrees": (-3, 3), "radians": (-90, 90), "sigmoid": (-3, 3),
    "softsign": (-3, 3), "relu": (-2, 2), "gamma": (0.5, 3),
    "gammaln": (0.5, 3), "erf": (-2, 2), "reciprocal": (0.5, 3),
    "negative": (-2, 2), "logical_not": (-2, 2), "round": (-3, 3),
}
# piecewise-constant functions: no gradient to compare (both are 0)
NO_GRAD = {"sign", "rint", "ceil", "floor", "trunc", "fix", "logical_not",
           "round"}


@pytest.mark.parametrize("name", sorted(UNARY_DOMAIN))
def test_unary_op(name):
    lo, hi = UNARY_DOMAIN[name]
    x = _u(lo, hi, 3, 5)
    # keep clear of the integer and half-integer breaks of the rounding
    # functions, where one ulp flips the result
    if name in NO_GRAD:
        x = np.round(x * 4) / 4 + 0.1
    # gamma and arccosh: XLA's and ATen's f32 kernels differ by a few ulps
    # of values up to 2 (gamma) and of a steep derivative (arccosh)
    tol = dict(rtol=2e-5, atol=2e-5) if name in ("gamma", "arccosh") \
        else TOL
    _compare(name, [x], {}, grad=name not in NO_GRAD, tol=tol)


def test_round_is_half_away_from_zero_and_rint_half_even():
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 0.49999997, 8388609.0],
                 np.float32)
    _compare("round", [x], {}, grad=False)
    _compare("rint", [x], {}, grad=False)


BINARY = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
          "hypot", "equal", "not_equal", "greater", "greater_equal",
          "lesser", "lesser_equal", "logical_and", "logical_or",
          "logical_xor"]
# gradients compared (ties split evenly between the operands in both)
SMOOTH_BINARY = {"add", "sub", "mul", "div", "mod", "power", "hypot",
                 "maximum", "minimum"}


@pytest.mark.parametrize("stem", BINARY)
def test_broadcast_op(stem):
    a, b = _u(0.5, 2, 3, 1, 4), _u(0.5, 2, 1, 5, 4)
    # exact ties are in the data on purpose for the comparisons
    b[0, :2, :2] = a[:1, 0, :2]
    _compare("broadcast_" + stem, [a, b], {}, grad=stem in SMOOTH_BINARY)


@pytest.mark.parametrize("name", ["elemwise_add", "_plus", "elemwise_sub",
                                  "elemwise_mul", "elemwise_div",
                                  "elemwise_mod", "_power", "_maximum",
                                  "_equal", "_lesser_equal"])
def test_elemwise_and_alias(name):
    a, b = _u(0.5, 2, 4, 5), _u(0.5, 2, 4, 5)
    _compare(name, [a, b], {}, grad=name not in ("_equal",
                                                 "_lesser_equal"))


SCALAR = ["_plus_scalar", "_minus_scalar", "_rminus_scalar", "_mul_scalar",
          "_div_scalar", "_rdiv_scalar", "_mod_scalar", "_rmod_scalar",
          "_power_scalar", "_rpower_scalar", "_hypot_scalar",
          "_maximum_scalar", "_minimum_scalar", "_equal_scalar",
          "_not_equal_scalar", "_greater_scalar", "_greater_equal_scalar",
          "_lesser_scalar", "_lesser_equal_scalar", "_logical_and_scalar",
          "_logical_or_scalar", "_logical_xor_scalar",
          "_scatter_plus_scalar", "_scatter_minus_scalar", "smooth_l1"]
PIECEWISE_SCALAR = {"_equal_scalar", "_not_equal_scalar", "_greater_scalar",
                    "_greater_equal_scalar", "_lesser_scalar",
                    "_lesser_equal_scalar", "_logical_and_scalar",
                    "_logical_or_scalar", "_logical_xor_scalar"}


@pytest.mark.parametrize("name", SCALAR)
def test_scalar_op(name):
    x = _u(0.5, 2.5, 4, 6)
    x[0, 0] = 1.5    # a tie with the scalar
    _compare(name, [x], {"scalar": 1.5}, grad=name not in PIECEWISE_SCALAR)


def test_clip_cast_where_addn_blockgrad():
    x = _n(4, 5)
    _compare("clip", [x], {"a_min": -0.5, "a_max": 0.7})
    _compare("Cast", [x], {"dtype": "float16"}, grad=False,
             tol=dict(rtol=1e-3, atol=1e-3))
    _compare("Cast", [x * 10], {"dtype": "int32"}, grad=False)
    cond = (R.rand(4, 5) > 0.5).astype(np.float32)
    _compare("where", [cond, x, _n(4, 5)], {})
    _compare("where", [(R.rand(4) > 0.5).astype(np.float32), x, _n(4, 5)],
             {})
    _compare("add_n", [x, _n(4, 5), _n(4, 5)], {})
    _compare("BlockGrad", [x], {})
    _compare("zeros_like", [x], {}, grad=False)
    _compare("ones_like", [x], {}, grad=False)


def test_make_loss_replaces_the_cotangent():
    x = torch.from_numpy(_n(3, 4)).requires_grad_()
    out = treg.get("make_loss").fn(x)
    (g,) = torch.autograd.grad(out, x, torch.full((3, 4), 7.0))
    np.testing.assert_array_equal(g.numpy(), np.ones((3, 4)))


REDUCE_CASES = {
    "norm_all": ("norm", {}),
    "norm_axis1_keep": ("norm", {"axis": 1, "keepdims": True}),
    "norm_l1": ("norm", {"ord": 1, "axis": (0, 2)}),
    "square_sum": ("_square_sum", {"axis": 1}),
    "argmax_none": ("argmax", {}),
    "argmax_axis": ("argmax", {"axis": 1}),
    "argmax_keep": ("argmax", {"axis": -1, "keepdims": True}),
    "argmin_axis": ("argmin", {"axis": 0}),
    "argmax_channel": ("argmax_channel", {}),
    "l2norm_instance": ("L2Normalization", {}),
    "l2norm_channel": ("L2Normalization", {"mode": "channel"}),
    "l2norm_spatial": ("L2Normalization", {"mode": "spatial"}),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_reduce_op(case):
    name, attrs = REDUCE_CASES[case]
    _compare(name, [_n(3, 4, 5)], attrs,
             grad=not name.startswith("arg"))


def test_broadcast_to_axis_like():
    x = _n(3, 1, 4)
    _compare("broadcast_to", [x], {"shape": (3, 5, 4)})
    _compare("broadcast_to", [x], {"shape": (0, 5, 0)})
    _compare("broadcast_axis", [x], {"axis": 1, "size": 6})
    _compare("broadcast_like", [x, _n(3, 2, 4)], {})


INDEX_CASES = {
    "pick_last": ("pick", lambda: [_n(4, 5), R.randint(0, 5, 4)
                                   .astype(np.float32)], {}),
    "pick_axis0_keep": ("batch_take", lambda: [_n(4, 5), R.randint(
        0, 4, 5).astype(np.float32)], {"axis": 0, "keepdims": True}),
    "pick_int_index": ("pick", lambda: [_n(2, 3, 4), R.randint(
        0, 3, (2, 4)).astype(np.int32)], {"axis": 1}),
    "one_hot": ("one_hot", lambda: [np.array([0, 2, 5, -1, 3], np.float32)],
                {"depth": 4}),
    "one_hot_values": ("one_hot", lambda: [np.array([[1, 0], [3, 2]],
                                                    np.int32)],
                       {"depth": 4, "on_value": 2.0, "off_value": -1.0}),
    "sort": ("sort", lambda: [_n(3, 6)], {}),
    "sort_desc_axis0": ("sort", lambda: [_n(5, 3)],
                        {"axis": 0, "is_ascend": False}),
    "argsort": ("argsort", lambda: [np.array([[3, 1, 2, 1, 3, 0]],
                                             np.float32)], {}),
    "argsort_desc": ("argsort", lambda: [np.array([[3, 1, 2, 1, 3, 0]],
                                                  np.float32)],
                     {"is_ascend": False}),
    "topk_indices": ("topk", lambda: [np.array([[3, 1, 2, 1, 3, 0],
                                                [0, 5, 5, 2, 1, 4]],
                                               np.float32)], {"k": 3}),
    "topk_value_axis0": ("topk", lambda: [_n(5, 3)],
                         {"k": 2, "axis": 0, "ret_typ": "value"}),
    "topk_both_ascend": ("topk", lambda: [np.array([[3, 1, 2, 1, 3, 0]],
                                                   np.float32)],
                         {"k": 4, "ret_typ": "both", "is_ascend": True}),
    "topk_mask": ("topk", lambda: [_n(3, 6)], {"k": 2, "ret_typ": "mask"}),
    "gather_nd": ("gather_nd", lambda: [_n(3, 4, 2), np.array(
        [[0, 2, 1], [3, 0, 3]], np.float32)], {}),
    "scatter_nd": ("scatter_nd", lambda: [_n(3), np.array(
        [[0, 2, 1], [3, 0, 2]], np.float32)], {"shape": (3, 4)}),
}
DIFFERENTIABLE_INDEX = {"pick", "batch_take", "sort", "gather_nd",
                        "scatter_nd"}


@pytest.mark.parametrize("case", sorted(INDEX_CASES))
def test_indexing_op(case):
    name, make, attrs = INDEX_CASES[case]
    grad = name in DIFFERENTIABLE_INDEX or attrs.get("ret_typ") == "value"
    _compare(name, make(), attrs, grad=grad)


MATRIX_CASES = {
    "slice": ("slice", [(4, 5, 6)], {"begin": (1, None, 0),
                                     "end": (3, None, 5), "step": ()}),
    "slice_step": ("slice", [(4, 5, 6)], {"begin": (0, 4, 1),
                                          "end": (4, 0, 6),
                                          "step": (2, -1, 2)}),
    "crop": ("crop", [(4, 5)], {"begin": (1, 1), "end": (3, 4)}),
    "reshape_like": ("reshape_like", [(4, 6), (3, 8)], {}),
    "slice_like": ("slice_like", [(4, 6), (3, 2)], {}),
    "split": ("SliceChannel", [(4, 6)], {"num_outputs": 3}),
    "split_squeeze": ("split", [(4, 3, 2)], {"num_outputs": 3, "axis": 1,
                                             "squeeze_axis": True}),
    "dot_2d": ("dot", [(3, 4), (4, 5)], {}),
    "dot_t": ("dot", [(4, 3), (5, 4)], {"transpose_a": True,
                                        "transpose_b": True}),
    "dot_3d": ("dot", [(2, 3, 4), (4, 5)], {}),
    "dot_1d": ("dot", [(4,), (4,)], {}),
    "tile": ("tile", [(2, 3)], {"reps": (2, 1, 3)}),
    "flip": ("flip", [(3, 4, 5)], {"axis": 1}),
    "reverse_axes": ("reverse", [(3, 4, 5)], {"axis": (0, 2)}),
    "pad_constant": ("Pad", [(2, 3, 4, 5)], {"mode": "constant",
                                             "pad_width": (0, 0, 1, 2, 2, 1,
                                                           0, 3),
                                             "constant_value": 1.5}),
    "pad_edge": ("Pad", [(2, 3, 4, 5)], {"mode": "edge",
                                         "pad_width": (0, 0, 0, 0, 1, 2,
                                                       2, 1)}),
    "pad_reflect": ("pad", [(2, 3, 4, 5)], {"mode": "reflect",
                                            "pad_width": (0, 0, 0, 0, 2, 2,
                                                          3, 1)}),
    "squeeze": ("squeeze", [(3, 1, 4, 1)], {}),
    "squeeze_axis": ("squeeze", [(3, 1, 4, 1)], {"axis": 1}),
    "stack": ("stack", [(3, 4), (3, 4)], {"axis": 1}),
}


@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_matrix_op(case):
    name, shapes, attrs = MATRIX_CASES[case]
    _compare(name, [_n(*s) for s in shapes], attrs)


NN_CASES = {
    "instance_norm": ("InstanceNorm", [(2, 3, 4, 5), (3,), (3,)],
                      {"eps": 1e-5}),
    "instance_norm_1d": ("InstanceNorm", [(2, 3, 7), (3,), (3,)], {}),
    "log_softmax": ("log_softmax", [(3, 7)], {}),
    "log_softmax_axis_temp": ("log_softmax", [(3, 7, 2)],
                              {"axis": 1, "temperature": 2.0}),
    "softmax_activation": ("SoftmaxActivation", [(2, 3, 4)], {}),
    "softmax_activation_channel": ("SoftmaxActivation", [(2, 3, 4)],
                                   {"mode": "channel"}),
    "deconv2d": ("Deconvolution", [(2, 4, 5, 5), (4, 3, 3, 3), (3,)],
                 {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                  "adj": (1, 1), "num_filter": 3, "no_bias": False}),
    "deconv2d_group_dilate": ("Deconvolution", [(2, 4, 5, 6),
                                                (4, 3, 3, 2)],
                              {"kernel": (3, 2), "stride": (1, 2),
                               "dilate": (2, 1), "num_filter": 6,
                               "num_group": 2}),
    "deconv1d": ("Deconvolution", [(2, 3, 7), (3, 2, 4)],
                 {"kernel": (4,), "stride": (3,), "pad": (1,),
                  "num_filter": 2}),
    "deconv3d": ("Deconvolution", [(1, 2, 3, 4, 3), (2, 2, 2, 2, 2)],
                 {"kernel": (2, 2, 2), "stride": (2, 1, 2),
                  "num_filter": 2}),
}


@pytest.mark.parametrize("case", sorted(NN_CASES))
def test_nn_op(case):
    name, shapes, attrs = NN_CASES[case]
    _compare(name, [_n(*s) for s in shapes], attrs)


@pytest.mark.parametrize("act", ["leaky", "elu", "selu", "gelu", "prelu",
                                 "prelu_scalar", "rrelu_eval"])
def test_leaky_relu(act):
    x = _n(2, 3, 4)
    attrs = {"act_type": act.split("_")[0], "slope": 0.3}
    arrays = [x]
    if act == "prelu":
        arrays.append(_u(0.1, 0.5, 3))
    elif act == "prelu_scalar":
        arrays.append(_u(0.1, 0.5, 1))
    jfn, tfn = jreg.get("LeakyReLU"), treg.get("LeakyReLU")
    jout = jfn(jax.random.PRNGKey(0), *[jnp.asarray(a) for a in arrays],
               is_train=act != "rrelu_eval", **attrs)
    tins = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    tout = tfn(*tins, is_train=act != "rrelu_eval", **attrs)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    g = R.randn(*x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jfn(jax.random.PRNGKey(0), *a,
                                    is_train=act != "rrelu_eval", **attrs),
                     *[jnp.asarray(a) for a in arrays])
    for jg, tg in zip(vjp(jnp.asarray(g)),
                      torch.autograd.grad(tout, tins, torch.from_numpy(g))):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


def test_rrelu_training_draws_slopes_in_bounds():
    """rrelu draws its negative slopes (not the JAX package's bits): held
    by statistics.  Positives pass; each negative's slope x/y lies in
    [lower, upper] and their mean is near the middle (40000 draws: the
    mean of U(0.125, 0.334) has a standard error of 3e-4)."""
    x = -np.abs(_n(200, 200)) - 0.01
    gen = torch.Generator().manual_seed(0)
    out = treg.get("LeakyReLU").fn(torch.from_numpy(x), act_type="rrelu",
                                   is_train=True, generator=gen).numpy()
    slopes = out / x
    assert slopes.min() >= 0.125 - 1e-6 and slopes.max() <= 0.334 + 1e-6
    assert abs(slopes.mean() - (0.125 + 0.334) / 2) < 3e-3
    pos = np.abs(x)
    out = treg.get("LeakyReLU").fn(torch.from_numpy(pos), act_type="rrelu",
                                   is_train=True, generator=gen).numpy()
    np.testing.assert_array_equal(out, pos)


def test_creation_ops():
    for name, attrs in (("_zeros", {"shape": (2, 3)}),
                        ("_ones", {"shape": (4,), "dtype": "int32"}),
                        ("_full", {"shape": (2, 2), "value": 2.5})):
        j = np.asarray(jreg.get(name)(**attrs))
        t = treg.get(name).fn(device=torch.device("cpu"), **attrs).numpy()
        assert j.dtype == t.dtype
        np.testing.assert_array_equal(t, j)


# --------------------------------------------------------------------------
# the NDArray, in both packages
# --------------------------------------------------------------------------
def _pkgs():
    return ((mx.nd, lambda x: mx.nd.array(x)),
            (mt.nd, lambda x: mt.nd.array(x, ctx=CPU)))


def _both(fn, *arrays):
    """``fn(nd, *NDArrays)`` in each package: the two results, as lists
    of numpy arrays."""
    out = []
    for nd, mk in _pkgs():
        res = fn(nd, *[mk(a) for a in arrays])
        res = res if isinstance(res, (list, tuple)) else [res]
        out.append([np.asarray(r.asnumpy()) for r in res])
    return out


NDARRAY_CASES = {
    "arithmetic": lambda nd, a, b: [a + b, a - b, a * b, a / b, a ** 2,
                                    2 + a, 2 - a, 2 / a, -a, abs(-a),
                                    a @ b.T, a % 0.7, 3 % a, 2 ** a, a ** b],
    "comparisons": lambda nd, a, b: [a > b, a >= b, a < b, a <= b, a == b,
                                     a != b, a > 1.2, a == a],
    "inplace": lambda nd, a, b: _inplace(a, b),
    "indexing_read": lambda nd, a, b: [a[1], a[1:3], a[:, 2], a[1, 2],
                                       a[::2, 1:4], a[-1], a[::-1]],
    "index_by_array": lambda nd, a, b: [a[nd.array([2, 0], ctx=_ctx(nd))],
                                        a[nd.array([[1], [3]],
                                                   ctx=_ctx(nd))]],
    "reshape_transpose": lambda nd, a, b: [
        a.reshape(5, 4), a.reshape((2, 10)), a.reshape(-1), a.T,
        a.reshape(2, 2, 5).transpose(0, 2, 1), a.flatten(),
        a.expand_dims(0), a.slice_axis(1, 0, 2), a.reshape_like(b.T),
        a.reshape(1, 4, 5).squeeze(), a.swapaxes(0, 1)],
    "reduce_methods": lambda nd, a, b: [
        a.sum(), a.sum(axis=1), a.mean(axis=0, keepdims=True), a.max(),
        a.min(axis=1), a.prod(axis=0), a.norm(), a.norm(axis=1),
        a.argmax(axis=1), a.argmin(), a.sort(), a.argsort(axis=0),
        a.topk(k=2), a.topk(k=2, ret_typ="value", axis=0),
        a.sort(is_ascend=False)],
    "unary_methods": lambda nd, a, b: [
        a.abs(), a.sign(), abs(a).sqrt(), a.square(), a.exp(),
        abs(a).log(), a.tanh(), a.sigmoid(), a.relu(), a.softmax(),
        a.log_softmax(axis=0), a.clip(-0.3, 0.4)],
    "shape_methods": lambda nd, a, b: [
        a.broadcast_to((2, 4, 5)) if False else a[:1].broadcast_to((3, 5)),
        a.slice(begin=(1, 0), end=(3, 4)), a.flip(1), a.tile((2, 1)),
        a.repeat(2, axis=0)] + list(a.split(2, axis=0)) + [
        a.dot(b.T), a.take(nd.array([0, 3], ctx=_ctx(nd))),
        a.pick(nd.array([0, 1, 2, 3], ctx=_ctx(nd)), axis=1),
        nd.array([1, 0, 3], ctx=_ctx(nd)).one_hot(4)],
    "free_functions": lambda nd, a, b: [
        nd.concatenate([a, b], axis=1), nd.stack_arrays([a, b], axis=0),
        nd.moveaxis(a.reshape(2, 2, 5), 0, 2), nd.concat(a, b, dim=0),
        nd.stack(a, b), nd.relu(a), nd.broadcast_add(a, b[:1]),
        nd.where(a > 0, a, b), nd.add_n(a, b, a)],
}


def _ctx(nd):
    return CPU if nd is mt.nd else None


def _inplace(a, b):
    out = []
    c = a.copy()
    c += 1
    out.append(c.copy())
    c *= b
    out.append(c.copy())
    c -= 2
    c /= 4
    out.append(c)
    out.append(a)   # the copy is deep: a is untouched
    return out


@pytest.mark.parametrize("case", sorted(NDARRAY_CASES))
def test_ndarray_against_jax(case):
    a, b = _u(0.3, 1.8, 4, 5), _u(0.3, 1.8, 4, 5)
    a[0, :2] = b[0, :2]     # ties for the comparisons
    jres, tres = _both(NDARRAY_CASES[case], a, b)
    assert len(jres) == len(tres)
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert j.shape == t.shape, (i, j.shape, t.shape)
        np.testing.assert_allclose(t, j, err_msg=f"result {i}", **TOL)


def test_setitem_variants_against_jax():
    """reference test_ndarray.py:63 test_ndarray_setitem shapes."""
    res = []
    for nd, mk in _pkgs():
        x = mk(np.zeros((3, 4), np.float32))
        x[:] = 2.5
        x[1] = np.arange(4)
        x[0:2, 1:3] = 7.0
        x[2] = nd.array(np.ones(4, np.float32), ctx=_ctx(nd)) * 9
        x[0, 3] = -1.0
        x[2, 1:3] = nd.array([7.0, 8.0], ctx=_ctx(nd))
        res.append(x.asnumpy())
    np.testing.assert_array_equal(res[1], res[0])


def test_properties_and_protocol():
    a = mt.nd.array([[1, 2, 3], [4, 5, 6]], ctx=CPU)
    assert a.shape == (2, 3) and a.size == 6 and a.ndim == 2
    assert a.dtype == np.float32 and a.context == CPU and a.stype == "default"
    b = mt.nd.array(np.arange(4, dtype=np.int64), ctx=CPU)
    assert b.dtype == np.int64
    assert mt.nd.array([3.5], ctx=CPU).asscalar() == 3.5
    assert float(mt.nd.array([3.5], ctx=CPU)) == 3.5
    assert int(mt.nd.array([7], ctx=CPU)) == 7
    assert len(mt.nd.zeros((4, 2), ctx=CPU)) == 4
    assert [r.shape for r in a] == [(3,), (3,)]
    assert bool(mt.nd.array([1.0], ctx=CPU))
    with pytest.raises(ValueError):
        bool(mt.nd.zeros((2, 2), ctx=CPU))
    assert a.wait_to_read() is a
    with pytest.raises(mt.MXNetError, match="C2"):
        a.tostype("row_sparse")
    with pytest.raises(mt.MXNetError, match="C2"):
        a.attach_grad(stype="row_sparse")
    assert a.tostype("default") is a


def test_dtypes_astype_copyto_and_contexts():
    for dt in ("float16", "float32", "float64", "int32", "int64", "uint8"):
        z = mt.nd.zeros((2, 2), ctx=CPU, dtype=dt)
        assert str(z.asnumpy().dtype) == dt
    assert mt.nd.zeros((2, 2), ctx=CPU, dtype="bfloat16").dtype == \
        "bfloat16"
    a = mt.nd.array([1.5, 2.5], ctx=CPU)
    assert a.astype("int32").asnumpy().dtype == np.int32
    assert a.astype(np.float16).dtype == np.float16
    b = mt.nd.zeros((2,), ctx=CPU)
    assert a.copyto(b) is b
    np.testing.assert_array_equal(b.asnumpy(), [1.5, 2.5])
    c = a.copyto(CPU)
    assert c is not a and c.as_torch().data_ptr() != a.as_torch().data_ptr()
    assert a.as_in_context(CPU) is a
    np.testing.assert_array_equal(mt.nd.ones((2, 3), ctx=CPU).asnumpy(),
                                  np.ones((2, 3)))
    np.testing.assert_array_equal(
        mt.nd.full((2,), 4, ctx=CPU, dtype="int32").asnumpy(), [4, 4])
    assert mt.nd.empty((3,), ctx=CPU).shape == (3,)
    for args, kw in (((5,), {}), ((2, 9, 2), {}), ((3,), {"step": 0.5}),
                     ((3,), {"repeat": 2})):
        np.testing.assert_array_equal(
            mt.nd.arange(*args, ctx=CPU, **kw).asnumpy(),
            mx.nd.arange(*args, **kw).asnumpy())
    out = mt.nd.zeros((3, 4), ctx=CPU)
    mt.nd.onehot_encode(mt.nd.array([0, 3, 1], ctx=CPU), out)
    np.testing.assert_array_equal(out.asnumpy(), np.eye(4)[[0, 3, 1]])
    mt.nd.waitall()


def test_without_cuda_the_default_context_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default context works")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.zeros((2,))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.array([1.0])


def test_save_load_and_pickle():
    rng = np.random.RandomState(0)
    arrs = [mt.nd.array(rng.randn(3, 2).astype('f'), ctx=CPU)
            for _ in range(3)]
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, 'arrs')
        mt.nd.save(f, arrs)
        for a, b in zip(arrs, mt.nd.load(f)):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
        mt.nd.save(f, {'w': arrs[0], 'b': arrs[1]})
        assert set(mt.nd.load(f)) == {'w', 'b'}
    b = pickle.loads(pickle.dumps(arrs[0]))
    np.testing.assert_array_equal(b.asnumpy(), arrs[0].asnumpy())


def test_namespace_out_and_contrib():
    a = mt.nd.array(_n(3, 4), ctx=CPU)
    out = mt.nd.zeros((3, 4), ctx=CPU)
    res = mt.nd.relu(a, out=out)
    assert res is out
    np.testing.assert_array_equal(out.asnumpy(), np.maximum(a.asnumpy(), 0))
    assert mt.nd.contrib.FlashAttention is mt.nd._contrib_FlashAttention
    assert "FullyConnected" in mt.nd.FullyConnected.__doc__
    w, bias = mt.nd.array(_n(2, 4), ctx=CPU), mt.nd.zeros((2,), ctx=CPU)
    y = mt.nd.FullyConnected(data=a, weight=w, bias=bias, num_hidden=2)
    np.testing.assert_allclose(y.asnumpy(), a.asnumpy() @ w.asnumpy().T,
                               rtol=1e-5)
    y2 = mt.nd.FullyConnected(a, w, num_hidden=2, no_bias=True)
    np.testing.assert_allclose(y2.asnumpy(), y.asnumpy(), rtol=1e-6)


def test_batchnorm_aux_write_back_follows_the_training_flag():
    """Imperative BatchNorm writes its new moving statistics into the aux
    arrays in training only, with the JAX package's update rule and in
    the aux arrays' dtype; held against the JAX package's _invoke."""
    x = _n(4, 3, 2, 2)
    res = []
    for nd, mk in _pkgs():
        ag = mx.autograd if nd is mx.nd else mt.autograd
        g, beta = mk(np.ones(3, np.float32)), mk(np.zeros(3, np.float32))
        mm, mv = mk(np.zeros(3, np.float32)), mk(np.ones(3, np.float32))
        nd.BatchNorm(mk(x), g, beta, mm, mv, fix_gamma=False)
        frozen = [mm.asnumpy().copy(), mv.asnumpy().copy()]
        with ag.train_mode():
            y = nd.BatchNorm(mk(x), g, beta, mm, mv, fix_gamma=False)
        res.append(frozen + [mm.asnumpy(), mv.asnumpy(), y.asnumpy()])
    np.testing.assert_array_equal(res[1][0], np.zeros(3))
    np.testing.assert_array_equal(res[1][1], np.ones(3))
    for j, t in zip(res[0], res[1]):
        np.testing.assert_allclose(t, j, **TOL)
