"""Each op of the PyTorch port's slice against the same op of the JAX
package, on the same numpy inputs.  Shape ops and Embedding must agree
exactly; arithmetic in float32 within 1e-6 (summation order and libm
differ)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import registry as jreg
import mxnet_tpu.ops  # noqa: F401  registers the JAX ops

from mxnet_tpu_torch.ops import registry as treg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-6, atol=1e-6)


def _both(name, *arrays, **attrs):
    j = jreg.get(name)(*[jnp.asarray(a) for a in arrays], **attrs)
    t = treg.get(name)(*[torch.from_numpy(a) for a in arrays], **attrs)
    return j, t


def _check(j, t, exact=False):
    j = j if isinstance(j, (tuple, list)) else (j,)
    t = t if isinstance(t, (tuple, list)) else (t,)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape
        if exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, **TOL)


RNG = np.random.RandomState(0)
X = RNG.randn(2, 3, 4, 5).astype(np.float32)


@pytest.mark.parametrize("shape,reverse", [
    ((0, -1), False), ((-1, 20), False), ((0, 0, -1), False),
    ((-2,), False), ((0, -2), False), ((-3, -2), False),
    ((0, -3, 0), False), ((-4, 1, 2, -2), False), ((-4, -1, 1, 0, -1), False),
    ((0, -4, 3, -1, -2), False), ((-1, 0), True), ((6, -1, 0), True),
])
def test_reshape_special_codes(shape, reverse):
    j, t = _both("Reshape", X, shape=shape, reverse=reverse)
    _check(j, t, exact=True)


@pytest.mark.parametrize("name,attrs", [
    ("transpose", {"axes": (0, 2, 1, 3)}),
    ("transpose", {}),
    ("expand_dims", {"axis": 0}),
    ("expand_dims", {"axis": 2}),
    ("slice_axis", {"axis": 1, "begin": 1, "end": 3}),
    ("slice_axis", {"axis": 3, "begin": 2, "end": None}),
    ("slice_axis", {"axis": -1, "begin": 0, "end": -2}),
])
def test_shape_ops(name, attrs):
    j, t = _both(name, X, **attrs)
    _check(j, t, exact=True)


@pytest.mark.parametrize("dim", [0, 1, 3])
def test_concat(dim):
    y = RNG.randn(*[s if i != dim else 2 for i, s in
                    enumerate(X.shape)]).astype(np.float32)
    for name in ("Concat", "concat"):
        j, t = _both(name, X, y, dim=dim)
        _check(j, t, exact=True)


def test_embedding_clamps_and_truncates_ids():
    w = RNG.randn(10, 4).astype(np.float32)
    ids = np.array([[0, 9, 10, 57], [-1, -30, 2.7, 3.2]], np.float32)
    j, t = _both("Embedding", ids, w, input_dim=10, output_dim=4)
    _check(j, t, exact=True)
    # the edge rows, as jnp.take(mode="clip")
    np.testing.assert_array_equal(t.numpy()[0, 2], w[9])
    np.testing.assert_array_equal(t.numpy()[1, 1], w[0])
    ids_int = np.array([[1, 12], [-5, 4]], np.int32)
    _check(*_both("Embedding", ids_int, w, input_dim=10, output_dim=4),
           exact=True)


@pytest.mark.parametrize("flatten,no_bias", [(True, False), (True, True),
                                             (False, False)])
def test_fully_connected(flatten, no_bias):
    data = RNG.randn(3, 4, 6).astype(np.float32)
    in_dim = 24 if flatten else 6
    w = RNG.randn(5, in_dim).astype(np.float32)
    b = RNG.randn(5).astype(np.float32)
    args = (data, w) if no_bias else (data, w, b)
    j, t = _both("FullyConnected", *args, num_hidden=5, no_bias=no_bias,
                 flatten=flatten)
    _check(j, t)


@pytest.mark.parametrize("axis", [-1, 1])
def test_layer_norm_three_outputs(axis):
    x = (RNG.randn(3, 7, 8) * 3 + 1).astype(np.float32)
    c = x.shape[axis]
    g = RNG.randn(c).astype(np.float32)
    b = RNG.randn(c).astype(np.float32)
    j, t = _both("LayerNorm", x, g, b, axis=axis, eps=1e-5)
    _check(j, t)
    assert treg.get("LayerNorm").num_outputs == 3
    assert treg.get("LayerNorm").num_visible == 1


def test_softmax_and_softmax_output_forward():
    x = (RNG.randn(6, 11) * 4).astype(np.float32)
    for attrs in ({}, {"axis": 0}, {"temperature": 2.0}):
        _check(*_both("softmax", x, **attrs))
    label = RNG.randint(0, 11, (6,)).astype(np.float32)
    for name in ("SoftmaxOutput", "Softmax"):
        _check(*_both(name, x, label))
    x3 = RNG.randn(2, 5, 3).astype(np.float32)
    _check(*_both("SoftmaxOutput", x3, np.zeros((2, 3), np.float32),
                  multi_output=True))


A = RNG.randn(3, 4).astype(np.float32)
B_ROW = (RNG.rand(1, 4) + 0.5).astype(np.float32)


@pytest.mark.parametrize("name", [
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "_plus", "_minus", "_grad_add", "_add", "_sub", "_mul", "_div"])
def test_elemwise_binary(name):
    b = (RNG.rand(3, 4) + 0.5).astype(np.float32)
    _check(*_both(name, A, b))


@pytest.mark.parametrize("name", [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "broadcast_greater_equal", "_greater_equal"])
def test_broadcast_binary(name):
    _check(*_both(name, A, B_ROW))
    _check(*_both(name, B_ROW, A))


@pytest.mark.parametrize("name", ["_plus_scalar", "_minus_scalar",
                                  "_rminus_scalar", "_mul_scalar",
                                  "_div_scalar"])
def test_scalar_ops(name):
    _check(*_both(name, A, scalar=1.702))


@pytest.mark.parametrize("name", ["sigmoid", "exp", "cos", "sin"])
def test_unary(name):
    _check(*_both(name, A))


def test_arange():
    j = jreg.get("_arange")(start=0, stop=7)
    t = treg.get("_arange")(start=0, stop=7, device=torch.device("cpu"))
    _check(j, t, exact=True)
    j = jreg.get("_arange")(start=1.0, stop=4.0, step=0.5, repeat=2)
    t = treg.get("_arange")(start=1.0, stop=4.0, step=0.5, repeat=2)
    _check(j, t, exact=True)


def test_registry_metadata_matches_jax():
    for name in ("FullyConnected", "LayerNorm", "Embedding", "softmax",
                 "SoftmaxOutput", "_contrib_FlashAttention", "Reshape",
                 "slice_axis", "Concat", "broadcast_add", "_mul_scalar"):
        j, t = jreg.get(name), treg.get(name)
        for f in ("num_outputs", "num_visible", "needs_rng",
                  "takes_is_train", "num_aux", "arg_names", "variadic"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert t.attr_defaults == j.attr_defaults, name
    assert treg.find("no_such_op") is None
    assert "_contrib_FlashAttention" in treg.list_ops()
