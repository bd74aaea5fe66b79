"""Every op the two packages' registries share whose inputs are ``data``
or ``lhs, rhs`` and that draws no random numbers, run at its default
attributes through the JAX package and the PyTorch port on the same
numpy inputs: float32 arrays holding NaN, +-inf, +-0 and a tiny value,
and int32 arrays.  A case compares values and dtypes exactly: NaN equal
to NaN, and the sign of a zero compared.

Where the outputs differ on purpose, ``DIVERGES`` records the op, what
differs and why, and the case checks that the difference is exactly
that one.  It is a record of divergences, not a way to skip one.  Then
the four faults of the port this file was written for, each with the
JAX package's answer: ``sign`` of NaN and -0.0, ``cbrt`` / ``rcbrt`` at
-0.0 (and ``cbrt``'s gradient), ``squeeze`` of an axis whose length is
not 1; and one fault of the reference that the port does not copy
(integer ``_power`` with a negative exponent)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu  # noqa: F401  (turns on x64, as the JAX package's tests run)
import mxnet_tpu.ops  # noqa: F401  registers the JAX ops
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch  # noqa: F401
from mxnet_tpu_torch.ops import registry as treg

J, T = jreg._OP_REGISTRY, treg._OP_REGISTRY
NAMES = sorted(n for n in set(J) & set(T)
               if J[n].arg_names in (["data"], ["lhs", "rhs"])
               and not J[n].needs_rng and not T[n].needs_rng)

F32 = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5, -2.5, 0.5,
                -1.0, 3.0, 1e-30, -8.0], np.float32).reshape(3, 4)
I32 = np.array([0, 1, -1, 7, -7, 2, 3, -2, 5, 100, -100, 9],
               np.int32).reshape(3, 4)
# the int32 right-hand side: negative exponents and zero divisors
I32_RHS = np.array([2, -2, 0, -2, 1, 3, 0, -1, 2, 1, 0, 1],
                   np.int32).reshape(3, 4)

# Ops with no useful default attributes run with these, on (1, 1, 3, 4).
ATTRS = {"Pad": {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)},
         "pad": {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 1, 1, 1)},
         "Pooling": {"kernel": (2, 2), "pool_type": "max"},
         "Pooling_v1": {"kernel": (2, 2), "pool_type": "max"}}

# float32 rounding of transcendental functions: XLA's CPU kernels and
# torch's (SLEEF / libm) differ by a few ulp; XLA also flushes float32
# subnormal results to zero (exp(-100) is 3.8e-44 in torch).  rtol 1e-6
# is about 8 ulp; gammaln's lgamma near its zeros (x = 1.5, 2.5 here)
# differs by 3.3e-7 absolutely, 2.7e-6 relatively, hence 1e-5 absolute.
ROUND = ("rounding", 1e-6, 1e-37)
# The JAX package runs with x64 on: a float scalar meeting an int32 array
# gives float64, integer sums int64.  The port keeps MXNet's 32-bit types
# (ROADMAP §3, "Integer dtypes"); the values agree within float32
# rounding.
X64 = ("x64", 1e-6, 0.0)
DIVERGES = {
    **{n: ("float32 rounding",) + ROUND[1:] for n in (
        "arccosh", "arcsinh", "cbrt", "cos", "cosh", "erf", "exp", "expm1",
        "gamma", "log", "log10", "mean", "norm", "rcbrt", "rsqrt", "sinh",
        "log_softmax", "softmax", "SoftmaxActivation", "tan", "tanh")},
    "gammaln": ("float32 rounding of lgamma near its zeros", 0.0, 1e-5),
    **{n: ("x64: 64-bit result in the JAX package",) + X64[1:] for n in (
        "L2Normalization", "_div_scalar", "_maximum_scalar",
        "_minimum_scalar", "_minus_scalar", "_mod_scalar", "_mul_scalar",
        "_plus_scalar", "_power_scalar", "_rdiv_scalar", "_rminus_scalar",
        "_rmod_scalar", "_rpower_scalar",
        "_scatter_minus_scalar", "_scatter_plus_scalar", "clip", "norm",
        "prod", "rint", "smooth_l1", "sum", "sum_axis")},
}
# -0.0 through max(x, 0): XLA returns +0.0, torch's relu and clamp keep
# -0.0.  The two compare equal; only a division by the result tells them
# apart.  Kept: making torch return +0.0 costs a second pass over every
# activation of the conv nets.
SIGN_OF_ZERO = {"Activation", "relu", "clip"}
# int32 input the JAX package refuses (lax's type check: erf, lgamma,
# rsqrt, logistic take floats only; max pooling's init value is int64
# under x64); the port computes, as MXNet does, and its answer equals
# its answer on the float32 copy.
JAX_REFUSES_INT = {"erf", "gamma", "gammaln", "rsqrt", "sigmoid", "Pooling",
                   "Pooling_v1"}
# integer remainder by zero: MXNet leaves it undefined; the JAX package
# returns a value, torch's CPU kernel raises ZeroDivisionError.  The
# cases without a zero divisor agree.
INT_MOD_BY_ZERO = {"_mod", "broadcast_mod", "elemwise_mod", "_rmod_scalar"}
# int32 power with a negative exponent: a fault of the reference (see
# test_integer_power_with_a_negative_exponent_is_a_reference_fault).
INT_POWER = {"_power", "broadcast_power"}


def _inputs(name, kind):
    if kind == "f32":
        ins = [F32, F32[::-1, ::-1].copy()]
    else:
        ins = [I32, I32_RHS]
    ins = ins[:len(J[name].arg_names)]
    if name in ATTRS:
        ins = [a.reshape(1, 1, 3, 4) for a in ins]
    return ins


def _run(reg, name, ins, conv):
    out = reg[name].fn(*[conv(a) for a in ins], **ATTRS.get(name, {}))
    return out[0] if isinstance(out, (tuple, list)) else out


def _jax(name, ins):
    return np.asarray(_run(J, name, ins, jnp.asarray))


def _port(name, ins):
    return _run(T, name, ins, lambda a: torch.from_numpy(a.copy())) \
        .detach().numpy()


def _same(got, want, rtol=0.0, atol=0.0, sign=True):
    assert got.shape == want.shape, (got.shape, want.shape)
    g, w = got.astype(np.float64), want.astype(np.float64)
    nan = np.isnan(w)
    assert (np.isnan(g) == nan).all(), (g, w)
    fin = np.isfinite(w)
    assert (g[~nan & ~fin] == w[~nan & ~fin]).all(), (g, w)
    np.testing.assert_allclose(g[fin], w[fin], rtol=rtol, atol=atol)
    if sign and not rtol and not atol:
        zero = w == 0
        assert (np.signbit(g[zero]) == np.signbit(w[zero])).all(), (g, w)


def _32(dt):
    return {np.dtype(np.float64): np.dtype(np.float32),
            np.dtype(np.int64): np.dtype(np.int32)}.get(np.dtype(dt),
                                                        np.dtype(dt))


@pytest.mark.parametrize("name", NAMES)
def test_shared_op_matches_jax_on_special_values(name):
    div = DIVERGES.get(name)
    for kind in ("f32", "i32"):
        ins = _inputs(name, kind)
        if kind == "i32" and name in JAX_REFUSES_INT:
            with pytest.raises(TypeError):
                _jax(name, ins)
            got = _port(name, ins)
            ref = _port(name, [a.astype(np.float32) for a in ins])
            _same(got.astype(np.float32), ref)
            continue
        if kind == "i32" and name in INT_MOD_BY_ZERO:
            with pytest.raises(RuntimeError, match="ZeroDivision"):
                _port(name, ins)
            # the same op without zero divisors agrees
            ins = [np.where(a == 0, 3, a).astype(a.dtype) for a in ins]
        try:
            want = _jax(name, ins)
        except Exception:
            # refused at these attributes (GridGenerator's empty
            # target_shape, ...): the port refuses too
            with pytest.raises(Exception):
                _port(name, ins)
            continue
        got = _port(name, ins)
        if kind == "i32" and name in INT_POWER:
            neg = np.broadcast_to(ins[1] < 0, want.shape)
            # 7 ** -2: the port truncates 1/49 to 0 and 1 ** -2 is 1
            assert (got[neg] == (np.abs(ins[0]) == 1)[neg] * ins[0][neg]
                    ** 2).all(), got[neg]
            got, want = got[~neg], want[~neg]
        if div is not None and div[0].startswith("x64"):
            assert got.dtype == _32(want.dtype) or (
                got.dtype == np.int32 and want.dtype == np.float64), \
                (got.dtype, want.dtype)
        else:
            assert got.dtype == want.dtype, (got.dtype, want.dtype)
        if div is not None:
            _same(got, want, div[1], div[2])
        else:
            _same(got, want, sign=not (kind == "f32"
                                       and name in SIGN_OF_ZERO))
            if kind == "f32" and name in SIGN_OF_ZERO:
                zero = want == 0
                assert np.signbit(got[zero]).any(), \
                    f"{name}: -0.0 now gives +0.0; drop it from SIGN_OF_ZERO"


def test_every_recorded_divergence_names_a_shared_op():
    recorded = (set(DIVERGES) | SIGN_OF_ZERO | JAX_REFUSES_INT
                | INT_MOD_BY_ZERO | INT_POWER | set(ATTRS))
    assert recorded <= set(NAMES), recorded - set(NAMES)


SPECIAL = np.array([np.nan, -0.0, 0.0, 8.0, -8.0, -1e-30, np.inf,
                    -np.inf], np.float32)


@pytest.mark.parametrize("name", ["sign", "cbrt", "rcbrt"])
def test_sign_of_nan_and_signed_zero_matches_jax(name):
    """``sign`` keeps NaN and -0.0 (``torch.sign`` gave 0.0 for both);
    ``cbrt`` keeps the sign bit, so ``rcbrt(-0.0)`` is -inf (was +inf)."""
    want, got = _jax(name, [SPECIAL]), _port(name, [SPECIAL])
    assert got.dtype == want.dtype
    _same(got, want, 1e-6 if name != "sign" else 0.0)
    zero = want == 0
    assert (np.signbit(got[zero]) == np.signbit(want[zero])).all()
    inf = np.isinf(want)
    assert (got[inf] == want[inf]).all(), (got, want)


@pytest.mark.parametrize("name", ["sign", "cbrt", "rcbrt"])
def test_gradient_at_zero_and_eight_matches_jax_vjp(name):
    """The gradient at 0, +-0, +-8 and -1e-30 against ``jax.vjp`` of the
    JAX op: cbrt's is ``1/(3 cbrt(x)^2)`` (inf at zero, where the chain
    through ``abs`` gave NaN), sign's is 0 everywhere."""
    x = np.array([0.0, -0.0, 8.0, -8.0, -1e-30], np.float32)
    g = np.array([1.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    _, vjp = jax.vjp(J[name].fn, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x.copy()).requires_grad_()
    T[name].fn(xt).backward(torch.from_numpy(g))
    got = xt.grad.numpy()
    # 3.3e19 at -1e-30: the JAX package's float32 cbrt(-1e-30) is 6.8e-7
    # from the exact value, and y**-2 doubles that (1.45e-6 measured)
    _same(got, want, 2e-6)


def test_squeeze_of_an_axis_not_of_length_one_raises():
    x = np.zeros((2, 3, 4), np.float32)
    with pytest.raises(ValueError):
        J["squeeze"].fn(jnp.asarray(x), axis=0)
    with pytest.raises(ValueError, match="not of length 1"):
        T["squeeze"].fn(torch.from_numpy(x), axis=0)
    with pytest.raises(ValueError, match="not of length 1"):
        T["squeeze"].fn(torch.from_numpy(x), axis=(0, 1))
    y = np.zeros((2, 1, 4, 1), np.float32)
    for axis in (1, (1, 3), -1, None):
        want = np.asarray(J["squeeze"].fn(jnp.asarray(y), axis=axis))
        got = T["squeeze"].fn(torch.from_numpy(y), axis=axis).numpy()
        assert got.shape == want.shape, axis


def test_integer_power_with_a_negative_exponent_is_a_reference_fault():
    """7 ** -2 in int32: the JAX package returns overflow garbage
    (767209169), the port 0, the integer truncation of 1/49 (ROADMAP
    §3).  1 ** -2 and (-1) ** -2 are 1 in both."""
    lhs = np.array([7, 1, -1, 2], np.int32)
    rhs = np.array([-2, -2, -2, 3], np.int32)
    for name in sorted(INT_POWER):
        want = _jax(name, [lhs, rhs])
        got = _port(name, [lhs, rhs])
        assert want[0] == 767209169, want
        assert got.tolist() == [0, 1, 1, 8], got
        assert want[1:].tolist() == [1, 1, 8]
