"""Indexing and ordering ops of the PyTorch port at their edges, against
the JAX package on the same numpy inputs: out-of-range and negative
indices (``pick``, ``gather_nd``, ``scatter_nd``), duplicate scatter
indices (output and gradient), ``axis=None`` sorts, ``topk`` over NaN and
signed zeros, and two recorded differences: the JAX package's
``topk(ret_typ="mask")`` along a leading axis (a fault of the
reference), and its 64-bit integer results (it runs with x64 on; the port
keeps MXNet's int32 and float32).

Every value compared is selected, not summed, so outputs must be equal
(NaN equal to NaN); gradients are the cotangent's entries or 0."""
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


def _both(name, arrays, attrs):
    """(JAX output, port output) of one op as numpy, outputs as tuples."""
    j = jreg.get(name)(*[jnp.asarray(a) for a in arrays], **attrs)
    t = treg.get(name)(*[torch.from_numpy(np.array(a)) for a in arrays],
                       **attrs)
    j = tuple(j) if isinstance(j, (tuple, list)) else (j,)
    t = tuple(t) if isinstance(t, (tuple, list)) else (t,)
    return [np.asarray(x) for x in j], [x.detach().numpy() for x in t]


def _assert_same(name, arrays, attrs):
    js, ts = _both(name, arrays, attrs)
    assert len(js) == len(ts)
    for j, t in zip(js, ts):
        assert j.shape == t.shape, (j.shape, t.shape)
        np.testing.assert_array_equal(t, j.astype(t.dtype))
    return ts


A = np.arange(10, dtype=np.float32).reshape(2, 5)

PICK_CASES = {
    # 7 and -6 lie outside [-5, 5): NaN in the JAX package
    "out_of_range": (A, np.array([7, -6], np.float32), {}),
    "negative_in_range": (A, np.array([-1, -5], np.float32), {}),
    "edges": (A, np.array([5, -5], np.float32), {}),
    "axis0_keepdims": (A, np.array([2, -3, 1, 0, 5], np.float32),
                       {"axis": 0, "keepdims": True}),
    # a signed integer input fills with its least value
    "int32": (A.astype(np.int32), np.array([7, -2], np.int32), {}),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_out_of_range_indices_match_jax(case):
    a, idx, attrs = PICK_CASES[case]
    for name in ("pick", "batch_take"):
        _assert_same(name, [a, idx], attrs)


def test_pick_gradient_is_zero_where_the_index_is_out_of_range():
    idx = np.array([7, -1], np.float32)
    g = np.array([2.0, 3.0], np.float32)
    _, vjp = jax.vjp(lambda a: jreg.get("pick")(a, jnp.asarray(idx)),
                     jnp.asarray(A))
    (want,) = vjp(jnp.asarray(g))
    a = torch.from_numpy(A.copy()).requires_grad_()
    out = treg.get("pick")(a, torch.from_numpy(idx))
    (got,) = torch.autograd.grad(out, a, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


GATHER_ND_CASES = {
    # (7, 9) clamps to (1, 4)
    "out_of_range": np.array([[0, 1], [7, 9]], np.float32),
    # a negative index counts from the end once, then clamps
    "negative": np.array([[-1, -3, -7], [-1, -9, 2]], np.int32),
}


@pytest.mark.parametrize("case", sorted(GATHER_ND_CASES))
def test_gather_nd_out_of_range_indices_match_jax(case):
    _assert_same("gather_nd", [A, GATHER_ND_CASES[case]], {})


SCATTER_ND_CASES = {
    # (1, 2) twice: the last write wins
    "duplicates": (np.array([1, 2, 3], np.float32),
                   np.array([[0, 1, 1], [1, 2, 2]], np.float32)),
    "duplicate_rows": (np.arange(12, dtype=np.float32).reshape(4, 3),
                       np.array([[1, 0, 1, 1]], np.int32)),
    # (-1, -1) counts from the end; (5, 0) is dropped
    "negative_and_out_of_range": (np.array([1, 2, 3], np.float32),
                                  np.array([[0, -1, 5], [1, -1, 0]],
                                           np.int32)),
}


@pytest.mark.parametrize("case", sorted(SCATTER_ND_CASES))
def test_scatter_nd_last_write_wins_in_output_and_gradient(case):
    data, idx = SCATTER_ND_CASES[case]
    shape = (2, 3) if idx.shape[0] == 2 else (3, 3)
    attrs = {"shape": shape}
    _assert_same("scatter_nd", [data, idx], attrs)
    g = np.arange(np.prod(shape), dtype=np.float32).reshape(shape) + 1
    _, vjp = jax.vjp(lambda d: jreg.get("scatter_nd")(d, jnp.asarray(idx),
                                                      **attrs),
                     jnp.asarray(data))
    (want,) = vjp(jnp.asarray(g))
    d = torch.from_numpy(data.copy()).requires_grad_()
    out = treg.get("scatter_nd")(d, torch.from_numpy(idx), **attrs)
    (got,) = torch.autograd.grad(out, d, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_scatter_nd_duplicate_gradient_is_the_last_writes():
    """data (1, 2, 3) at (0,1), (1,2), (1,2) with the cotangent of 1 at
    (0, 1) and 6 at (1, 2): only the first and the last write get one."""
    g = np.zeros((2, 3), np.float32)
    g[0, 1], g[1, 2] = 1.0, 6.0
    d = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    idx = torch.tensor([[0, 1, 1], [1, 2, 2]])
    out = treg.get("scatter_nd")(d, idx, shape=(2, 3))
    (got,) = torch.autograd.grad(out, d, torch.from_numpy(g))
    assert got.tolist() == [1.0, 0.0, 6.0]
    assert out.tolist() == [[0.0, 1.0, 0.0], [0.0, 0.0, 3.0]]


SORT_CASES = {
    "sort": ("sort", {"axis": None}),
    "sort_desc": ("sort", {"axis": None, "is_ascend": False}),
    "argsort": ("argsort", {"axis": None}),
    "argsort_desc": ("argsort", {"axis": None, "is_ascend": False}),
}


@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_sort_and_argsort_with_axis_none_flatten(case):
    name, attrs = SORT_CASES[case]
    x = np.random.RandomState(3).permutation(12).astype(np.float32)
    (t,) = _assert_same(name, [x.reshape(3, 4)], attrs)
    assert t.shape == (12,)


def test_topk_with_axis_none_raises_in_both_packages():
    """A fault of the reference kept as it is: the JAX package computes
    ``axis % ndim`` with axis None; the port raises as well."""
    with pytest.raises(TypeError):
        jreg.get("topk")(jnp.asarray(A), k=2, axis=None)
    with pytest.raises(TypeError):
        treg.get("topk")(torch.from_numpy(A), k=2, axis=None)


NAN = np.float32(np.nan)
TOPK_CASES = {
    "nan_k1": ([1, NAN, 3], {"k": 1}),
    "nans_both": ([1, NAN, 3, NAN], {"k": 3, "ret_typ": "both"}),
    "nans_ascending": ([1, NAN, 3, NAN], {"k": 4, "is_ascend": True}),
    # a negative NaN sits below -inf
    "negative_nan": ([1, -NAN, 3, NAN], {"k": 4}),
    "negative_nan_ascending": ([1, -NAN, 3, NAN], {"k": 4,
                                                    "is_ascend": True}),
    "infinities": ([1, np.inf, -np.inf, NAN], {"k": 4, "is_ascend": True,
                                                "ret_typ": "both"}),
    # +0.0 ranks above -0.0
    "signed_zeros": ([-0.0, 0.0, -1], {"k": 2}),
    "signed_zeros_ascending": ([-0.0, 0.0, 1], {"k": 2, "is_ascend": True}),
    "nan_rows_axis0": ([[1, 2], [NAN, 0], [3, NAN]], {"k": 2, "axis": 0}),
}


@pytest.mark.parametrize("case", sorted(TOPK_CASES))
def test_topk_ranks_nan_and_zeros_as_lax_top_k(case):
    x, attrs = TOPK_CASES[case]
    _assert_same("topk", [np.array(x, np.float32)], attrs)


def test_topk_int32_ascending_matches_jax():
    _assert_same("topk", [np.array([3, -2, 7, 7], np.int32)],
                 {"k": 3, "is_ascend": True, "ret_typ": "both"})


def test_topk_mask_along_axis0_is_a_reference_fault():
    """The JAX package moves the indices back to ``axis`` before it
    scatters the mask on the moved array (mxnet_tpu/ops/indexing.py:124,
    131-133), so along axis 0 it marks the wrong entries.  The port's
    mask holds k ones in every column, at the k largest entries."""
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    attrs = {"k": 3, "axis": 0, "ret_typ": "mask"}
    (j,), (t,) = _both("topk", [x], attrs)
    want = np.zeros_like(x)
    np.put_along_axis(want, np.argsort(-x, axis=0)[:3], 1.0, axis=0)
    np.testing.assert_array_equal(t, want)
    assert (t.sum(axis=0) == 3).all()
    # the reference: some column holds fewer than k ones
    assert (j.sum(axis=0) != 3).any()
    assert not np.array_equal(j, want)


def test_integer_results_follow_mxnet_not_x64():
    """A recorded difference: with x64 on, the JAX package returns int64
    sums and products and float64 norms and mixed int/float results; the
    port keeps MXNet's int32 and float32.  The values agree."""
    x = np.arange(1, 7, dtype=np.int32).reshape(2, 3)
    ja = mx.nd.array(x, dtype="int32")
    ta = mt.nd.array(x, dtype="int32", ctx=mt.cpu())
    cases = {
        "sum": (lambda n, a: n.sum(a), "int64", torch.int32),
        "prod": (lambda n, a: n.prod(a), "int64", torch.int32),
        "norm": (lambda n, a: n.norm(a), "float64", torch.float32),
        "div_int": (lambda n, a: a / 2, "float64", torch.float32),
        "div_float": (lambda n, a: a / 2.5, "float64", torch.float32),
        "mul_float": (lambda n, a: a * 1.5, "float64", torch.float32),
    }
    for name, (fn, jdt, tdt) in cases.items():
        j, t = fn(mx.nd, ja), fn(mt.nd, ta)
        assert str(j.dtype) == jdt, (name, j.dtype)
        assert t._data.dtype == tdt, (name, t._data.dtype)
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6,
                                   err_msg=name)
