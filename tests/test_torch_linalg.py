"""The linear-algebra ops (``linalg_*``, ``khatri_rao``) and the
``nd.linalg`` / ``sym.linalg`` namespaces of the PyTorch port against
the JAX package: every op's outputs and its gradient (``jax.vjp``
against torch's autograd), batched (3 matrices of 5 x 5, well
conditioned).

``syevd``'s eigenvectors and ``gelqf``'s factors are unique only up to
the sign of each vector (LAPACK's and XLA's routines may choose
differently), so each row of Q and of the eigenvector matrix, with L's
matching column, is first turned so that its largest entry is positive;
their gradients are compared through sign-independent functions (the
reconstruction L Q and the projector V^T diag(w) V).  Tolerances:
float32, 1e-4 relative and 1e-5 absolute (factorisations and solves of
condition number under 100, summed in other orders; measured up to
4e-6)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

RTOL, ATOL = 1e-4, 1e-5
NB, M = 3, 5


def _rng(seed):
    return np.random.default_rng(seed)


def _spd(seed):
    a = _rng(seed).standard_normal((NB, M, M)).astype(np.float32)
    return (a @ a.transpose(0, 2, 1) / M + np.eye(M, dtype=np.float32))


def _lower(seed):
    a = _rng(seed).standard_normal((NB, M, M)).astype(np.float32) * 0.3
    return a + 2 * np.eye(M, dtype=np.float32)   # upper part: ignored


def _gen(seed, shape=(NB, M, M)):
    return _rng(seed).standard_normal(shape).astype(np.float32)


# op name, attrs, inputs (numpy), output post-processing for both
CASES = {
    "gemm": ("linalg_gemm", dict(transpose_a=True, alpha=0.5, beta=2.0),
             lambda: [_gen(1), _gen(2), _gen(3)]),
    "gemm2": ("linalg_gemm2", dict(transpose_b=True, alpha=1.5),
              lambda: [_gen(4), _gen(5)]),
    "potrf": ("linalg_potrf", {}, lambda: [_spd(6)]),
    "potri": ("linalg_potri", {},
              lambda: [np.linalg.cholesky(_spd(7)).astype(np.float32)]),
    "trmm": ("linalg_trmm", dict(transpose=True, alpha=2.0),
             lambda: [_lower(8), _gen(9)]),
    "trmm_right": ("linalg_trmm", dict(rightside=True),
                   lambda: [_lower(10), _gen(11)]),
    "trsm": ("linalg_trsm", dict(alpha=0.5), lambda: [_lower(12), _gen(13)]),
    "trsm_t_right": ("linalg_trsm", dict(transpose=True, rightside=True),
                     lambda: [_lower(14), _gen(15)]),
    "syrk": ("linalg_syrk", dict(transpose=True, alpha=0.7),
             lambda: [_gen(16, (NB, M, 3))]),
    "sumlogdiag": ("linalg_sumlogdiag", {},
                   lambda: [np.abs(_lower(17)) + 0.5]),
    "inverse": ("linalg_inverse", {}, lambda: [_spd(18)]),
    "det": ("linalg_det", {},
            lambda: [_spd(19) - 0.5 * np.eye(M, dtype=np.float32)]),
    "slogdet": ("linalg_slogdet", {},
                lambda: [_gen(20) + 3 * np.eye(M, dtype=np.float32)]),
    "khatri_rao": ("khatri_rao", {},
                   lambda: [_gen(21, (3, 4)), _gen(22, (2, 4)),
                            _gen(23, (5, 4))]),
}


def _run_both(op, attrs, args, post=None):
    """Outputs and input gradients of both packages, for a random
    cotangent on every floating output."""
    jop = jreg.get(op).fn
    tfn = mt.ops.registry.get(op).fn
    post = post or (lambda outs: outs)

    def jf(*a):
        out = jop(*a, **attrs)
        return post(tuple(out) if isinstance(out, (tuple, list)) else (out,))
    jout, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    rng = _rng(99)
    cot = tuple(jnp.asarray(rng.standard_normal(o.shape).astype(o.dtype))
                for o in jout)
    jg = vjp(cot)
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out = tfn(*ts, **attrs)
    tout = post(tuple(out) if isinstance(out, (tuple, list)) else (out,))
    torch.autograd.backward([o for o in tout if o.is_floating_point()],
                            [torch.tensor(np.asarray(c)) for c, o in
                             zip(cot, tout) if o.is_floating_point()])
    return ([np.asarray(o) for o in jout], [np.asarray(g) for g in jg],
            [o.detach().numpy() for o in tout],
            [t.grad.numpy() if t.grad is not None else np.zeros_like(a)
             for t, a in zip(ts, args)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_and_gradient_match_jax(case):
    op, attrs, make = CASES[case]
    jout, jg, tout, tg = _run_both(op, attrs, make())
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _turn_rows(rows, *cols):
    """Each row of ``rows`` times the sign of its largest-magnitude
    entry, and each matching column of ``cols`` likewise."""
    idx = np.abs(rows).argmax(-1)
    s = np.sign(np.take_along_axis(rows, idx[..., None], -1))
    return [rows * s] + [c * np.swapaxes(s, -1, -2) for c in cols]


def test_gelqf_factors_match_jax_up_to_signs():
    a = _gen(30, (NB, 3, M))                      # wide: A = L Q
    (jl, jq), _, (tl, tq), _ = _run_both("linalg_gelqf", {}, [a])
    tq, tl = _turn_rows(tq, tl)
    jq, jl = _turn_rows(jq, jl)
    np.testing.assert_allclose(tq, jq, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tl @ tq, a, rtol=RTOL, atol=ATOL)
    # the gradient of the sign-free product L Q
    _, jg, _, tg = _run_both("linalg_gelqf", {}, [a],
                             post=lambda o: (o[0] @ o[1],))
    np.testing.assert_allclose(tg[0], jg[0], rtol=RTOL, atol=ATOL)


def test_syevd_matches_jax_up_to_signs():
    a = _spd(31)
    (jv, jw), _, (tv, tw), _ = _run_both("linalg_syevd", {}, [a])
    np.testing.assert_allclose(tw, jw, rtol=RTOL, atol=ATOL)
    assert (np.diff(tw, axis=-1) > 0).all()       # ascending
    np.testing.assert_allclose(_turn_rows(tv)[0], _turn_rows(jv)[0],
                               rtol=RTOL, atol=ATOL)
    # rows are eigenvectors: A v = w v
    np.testing.assert_allclose(np.einsum("bij,bkj->bki", a, tv),
                               tv * tw[..., None], rtol=RTOL, atol=1e-4)

    def proj(o):     # V^T diag(w) V (= A), and w: free of the signs
        v, w = o
        return v.swapaxes(-1, -2) @ (w[..., None] * v), w
    _, jg, _, tg = _run_both("linalg_syevd", {}, [a], post=proj)
    np.testing.assert_allclose(tg[0], jg[0], rtol=RTOL, atol=ATOL)


def test_spd_chain_and_namespaces():
    """``nd.linalg``: potrf -> potri gives the inverse, as ``inverse``
    does; ``sumlogdiag`` of the factor is half ``slogdet``; the
    ``sym.linalg`` graph of the same chain, bound and run, agrees."""
    a = _spd(40)
    with mt.cpu():
        A = mt.nd.array(a)
        L = mt.nd.linalg.potrf(A)
        inv = mt.nd.linalg.potri(L)
        np.testing.assert_allclose(inv.asnumpy(),
                                   mt.nd.linalg.inverse(A).asnumpy(),
                                   rtol=1e-4, atol=1e-5)
        sign, logdet = mt.nd.linalg.slogdet(A)
        np.testing.assert_allclose(2 * mt.nd.linalg.sumlogdiag(L).asnumpy(),
                                   logdet.asnumpy(), rtol=1e-5)
        assert (sign.asnumpy() == 1).all()
    x = mt.sym.Variable("a")
    s = mt.sym.linalg.potri(mt.sym.linalg.potrf(x))
    ex = mt.executor.Executor(s, mt.cpu(),
                              {"a": mt.nd.array(a, ctx=mt.cpu())},
                              grad_req="null")
    np.testing.assert_allclose(ex.forward()[0].asnumpy(), inv.asnumpy(),
                               rtol=1e-5, atol=1e-6)
    assert mx.nd.linalg.gemm2.__name__ == mt.nd.linalg.gemm2.__name__
    public = [sorted(n for n in dir(ns) if not n.startswith("_")
                     and n != "annotations")
              for ns in (mt.sym.linalg, mx.sym.linalg, mt.nd.linalg,
                         mx.nd.linalg)]
    assert public[0] == public[1] and public[2] == public[3]
