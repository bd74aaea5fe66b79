"""The sampling ops (``_random_*``, ``_sample_*``, ``_sample_multinomial``,
``_shuffle``) and the ``nd.random`` / ``sym.random`` namespaces of the
PyTorch port against the JAX package.

The JAX package draws from counter-based JAX keys and the port from
``torch.Generator`` streams, so the two never give the same values: the
comparison is by distribution, not by value.  For each distribution,
20000 draws from each package: the port's mean and variance against the
analytic ones within 5 standard errors (the variance's standard error
from the sample's fourth central moment), the JAX package's likewise,
and a two-sample Kolmogorov-Smirnov test of the port's draws against the
JAX package's at p > 1e-3 (for the discrete distributions the test is
conservative).  The draws are made from fixed seeds, so each run of the
test sees the same numbers.  Then the port's own rules: every draw comes
from the generator ``mx.random.seed`` sets (a reseed repeats a draw bit
for bit, torch's global generator is never touched), ``shuffle`` is a
permutation along axis 0, and a bound graph draws from its executor's
generator."""
import numpy as np
import pytest
import torch
from scipy import stats

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

N = 20000
SE = 5.0
CPU = mt.cpu()

# name, kwargs, analytic mean, analytic variance
SCALAR = {
    "uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12),
    "normal": (dict(loc=2.0, scale=0.5), 2.0, 0.25),
    "gamma": (dict(alpha=2.5, beta=1.5), 3.75, 2.5 * 1.5 ** 2),
    "exponential": (dict(scale=2.0), 2.0, 4.0),
    "poisson": (dict(lam=3.5), 3.5, 3.5),
    "negative_binomial": (dict(k=3, p=0.4), 3 * 0.6 / 0.4,
                          3 * 0.6 / 0.4 ** 2),
    "generalized_negative_binomial": (dict(mu=2.0, alpha=0.5), 2.0,
                                      2.0 + 0.5 * 4.0),
    "randint": (dict(low=-3, high=5), 0.5, (8 ** 2 - 1) / 12),
}


def _moments_ok(x, mean, var, what):
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    m, v = x.mean(), x.var(ddof=1)
    m4 = ((x - m) ** 4).mean()
    assert abs(m - mean) <= SE * np.sqrt(var / n), (what, "mean", m, mean)
    assert abs(v - var) <= SE * np.sqrt(max(m4 - v * v, 1e-12) / n), \
        (what, "var", v, var)


@pytest.mark.parametrize("name", sorted(SCALAR))
def test_scalar_parameter_draws_match_jax_in_distribution(name):
    kw, mean, var = SCALAR[name]
    mt.random.seed(1)
    mx.random.seed(1)
    got = getattr(mt.nd.random, name)(shape=(N,), ctx=CPU, **kw).asnumpy()
    want = getattr(mx.nd.random, name)(shape=(N,), **kw).asnumpy()
    assert got.shape == want.shape == (N,)
    assert got.dtype == want.dtype
    _moments_ok(got, mean, var, "port")
    _moments_ok(want, mean, var, "jax")
    assert stats.ks_2samp(got, want).pvalue > 1e-3


# _sample_<name>: two parameter elements, each with its own distribution
PARAM = {
    "uniform": ([[0.0, 1.0], [2.0, 5.0]],
                lambda a, b: ((a + b) / 2, (b - a) ** 2 / 12)),
    "normal": ([[0.0, -3.0], [1.0, 0.5]], lambda a, b: (a, b * b)),
    "gamma": ([[0.7, 4.0], [2.0, 0.5]], lambda a, b: (a * b, a * b * b)),
    "exponential": ([[0.5, 4.0]], lambda lam: (1 / lam, 1 / lam ** 2)),
    "poisson": ([[0.5, 6.0]], lambda lam: (lam, lam)),
    "negative_binomial": ([[2.0, 5.0], [0.3, 0.7]],
                          lambda k, p: (k * (1 - p) / p,
                                        k * (1 - p) / p ** 2)),
    "generalized_negative_binomial": ([[3.0, 2.0], [0.0, 0.25]],
                                      lambda mu, a: (mu, mu + a * mu * mu)),
}


@pytest.mark.parametrize("name", sorted(PARAM))
def test_parameter_array_draws_match_jax_in_distribution(name):
    """``nd.random.<name>(NDArray, ...)``: output ``param.shape + shape``,
    each row drawn from its own parameters (``gamma``'s beta a scale;
    the generalized NB's alpha 0 a Poisson)."""
    params, moments = PARAM[name]
    mt.random.seed(2)
    mx.random.seed(2)
    tp = [mt.nd.array(np.array(p, np.float32), ctx=CPU) for p in params]
    jp = [mx.nd.array(np.array(p, np.float32)) for p in params]
    if name == "exponential":   # the frontends take the scale 1 / lam
        tp, jp = [1.0 / tp[0]], [1.0 / jp[0]]
    if name in ("negative_binomial", "generalized_negative_binomial"):
        # the frontends take numbers only: the ops themselves
        got = getattr(mt.nd, f"_sample_{name}")(*tp, shape=(N,))
        want = getattr(mx.nd, f"_sample_{name}")(*jp, shape=(N,))
    else:
        got = getattr(mt.nd.random, name)(*tp, shape=(N,))
        want = getattr(mx.nd.random, name)(*jp, shape=(N,))
    got, want = got.asnumpy(), want.asnumpy()
    assert got.shape == want.shape == (2, N)
    for row in range(2):
        ps = [np.float64(p[row]) for p in params]
        mean, var = moments(*ps)
        _moments_ok(got[row], mean, var, ("port", row))
        _moments_ok(want[row], mean, var, ("jax", row))
        assert stats.ks_2samp(got[row], want[row]).pvalue > 1e-3


def test_multinomial_frequencies_and_log_probabilities():
    """``nd.random.multinomial``: a (2, 4) array of distributions, 20000
    draws a row; each category's frequency within 5 standard errors of
    its probability in both packages; ``get_prob`` gives log p of each
    draw."""
    probs = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.05, 0.25]],
                     np.float32)
    mt.random.seed(3)
    got, lp = mt.nd.random.multinomial(mt.nd.array(probs, ctx=CPU),
                                       shape=(N,), get_prob=True)
    want = mx.nd.random.multinomial(mx.nd.array(probs), shape=(N,))
    got, lp, want = got.asnumpy(), lp.asnumpy(), want.asnumpy()
    assert got.shape == want.shape == lp.shape == (2, N)
    assert got.dtype == np.int32
    for row in range(2):
        for c in range(4):
            p = probs[row, c]
            se = SE * np.sqrt(max(p * (1 - p), 1e-12) / N)
            assert abs((got[row] == c).mean() - p) <= se + 1e-12
            assert abs((want[row] == c).mean() - p) <= se + 1e-12
    np.testing.assert_allclose(
        lp, np.log(np.take_along_axis(probs, got.astype(int), 1)),
        rtol=1e-6)
    one = mt.nd.random.multinomial(mt.nd.array(probs[0], ctx=CPU))
    assert one.shape == () and 0 <= int(one.asnumpy()) < 4


def test_reseeding_repeats_and_the_global_generator_is_untouched():
    state = torch.get_rng_state()
    draws = []
    for _ in range(2):
        mt.random.seed(42)
        draws.append([getattr(mt.nd.random, n)(shape=(64,), ctx=CPU,
                                               **SCALAR[n][0]).asnumpy()
                      for n in sorted(SCALAR)]
                     + [mt.nd.random.shuffle(mt.nd.array(
                         np.arange(32, dtype=np.float32),
                         ctx=CPU)).asnumpy()])
    for a, b in zip(*draws):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(torch.get_rng_state(), state)
    mt.random.seed(43)
    other = mt.nd.random.uniform(shape=(64,), ctx=CPU).asnumpy()
    assert not np.array_equal(other, draws[0][sorted(SCALAR).index(
        "uniform")])


def test_shuffle_permutes_rows():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    mt.random.seed(5)
    y = mt.nd.random.shuffle(mt.nd.array(x, ctx=CPU)).asnumpy()
    assert sorted(map(tuple, y)) == sorted(map(tuple, x))
    assert not np.array_equal(y, x)
    np.testing.assert_array_equal(y[:, 1] - y[:, 0], 1)   # rows intact


def test_a_bound_graph_draws_from_its_executors_generator():
    """``sym.random``: a graph of a scalar and a parameter-array draw,
    shape-inferred on meta tensors (no generator) and bound twice after
    the same seed gives the same draws; a Symbol parameter with a number
    beside it raises, as in the JAX package."""
    mu = mt.sym.Variable("mu")
    s = mt.sym.Group([mt.sym.random.normal(shape=(3, 4)),
                      mt.sym.random.gamma(mu, mu * 2.0, shape=(5,))])
    _, outs, _ = s.infer_shape(mu=(2,))
    assert outs == [(3, 4), (2, 5)]
    runs = []
    for _ in range(2):
        mt.random.seed(9)
        ex = mt.executor.Executor(s, CPU, {"mu": mt.nd.array(
            np.array([1.0, 2.0], np.float32), ctx=CPU)}, grad_req="null")
        runs.append([o.asnumpy() for o in ex.forward()])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    assert (runs[0][1] > 0).all()
    with pytest.raises(ValueError):
        mt.sym.random.uniform(mu, 1.0)


def test_generalized_negative_binomial_at_alpha_zero_is_poisson():
    """Scalar alpha 0: the port draws Poisson(mu), as the parameter-array
    form does in both packages; the JAX package's scalar form divides by
    alpha and raises (ROADMAP §3, reference fault)."""
    mt.random.seed(6)
    got = mt.nd.random.generalized_negative_binomial(
        mu=2.0, alpha=0.0, shape=(N,), ctx=CPU).asnumpy()
    _moments_ok(got, 2.0, 2.0, "port")
    with pytest.raises(ZeroDivisionError):
        mx.nd.random.generalized_negative_binomial(mu=2.0, alpha=0.0,
                                                   shape=(4,))
