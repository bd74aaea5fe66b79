"""The gradient of every op that ``test_torch_op_sweep.py`` sweeps forward
(the ops both registries share whose inputs are ``data`` or ``lhs,
rhs``), at that file's float32 special values (NaN, +-inf, +-0, a tiny
value): ``jax.vjp`` of the JAX op against the port's autograd, with a
cotangent of ones.  A case compares exactly: NaN equal to NaN, the sign
of a zero compared.

Where a user's loss meets the case the port gives the JAX package's
answer (each shown below with its numbers): ``abs`` at +-0 (1) and at
NaN (-1), and so Gluon ``L1Loss`` where the prediction equals the label;
``clip`` at a bound (0.5); ``_maximum`` / ``_minimum`` and their
broadcast and scalar forms with a NaN input (0 to both sides); ``relu``
and ``Activation`` at NaN (0).

Where the gradients differ on purpose, ``DIVERGES`` records the op, the
elements that differ, each package's answer there and why; the case
checks that the difference is exactly that one and that the rest agrees
within the entry's tolerance.  It is a record, not a way to skip."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from test_torch_op_sweep import ATTRS, F32, J, NAMES, T, _inputs, _same
import torch_threads  # noqa: F401,E402  a worker's share of the cores

NAN, INF = np.nan, np.inf


def _x(ins):
    return ins[0]


def _y(ins):
    return ins[1]


# name: (why, rtol, atol, {input k: (where(ins) -> mask, port, jax)}).
# `where` marks the elements of input k's gradient that differ beyond the
# tolerance; there the port must give `port` and the JAX package `jax`
# (a value, or a predicate such as np.isinf; None: any value).
# float32 rounding of the derivative's formula (a few ulp): 1e-6 is about
# 8 ulp, as in the forward sweep.
ROUND = 1e-6
_HYPOT = ("x / hypot(x, y) where the other input is infinite: the port "
          "gives 0, the true value; jnp.hypot computes max * sqrt(1 + "
          "(min / max)^2), whose chain through min / max is NaN at inf",
          ROUND, 0.0,
          {0: (lambda i: np.isinf(_y(i)) & np.isfinite(_x(i)), 0.0, NAN),
           1: (lambda i: np.isinf(_x(i)) & np.isfinite(_y(i)), 0.0, NAN)})
_MOD = ("the divisor's gradient, -floor(x / y), where the dividend is "
        "infinite (x mod y is NaN there): JAX +-inf, torch's remainder "
        "NaN", 0.0, 0.0,
        {1: (lambda i: np.isinf(_x(i)), NAN, np.isinf)})
_POWER = ("the exponent's gradient x^y log x at 0^-1: torch inf * -inf "
          "= -inf, jnp.power's rule NaN", 0.0, 0.0,
          {1: (lambda i: (_x(i) == 0) & (_y(i) < 0), -INF, NAN)})
_GAMMA = ("at +-0, a pole: torch's digamma gives -+inf, XLA's NaN; "
          "elsewhere digamma's float32 rounding differs by up to 5e-6 "
          "relatively", 1e-5, 0.0,
          {0: (lambda i: _x(i) == 0, np.isinf, NAN)})
# the gradient of a softmax against a cotangent of ones is 0 up to
# rounding: both packages leave float32 noise of up to 6e-8
_ZERO_NOISE = ("0 up to float32 rounding noise", 0.0, 1e-7, {})
DIVERGES = {
    "Pooling": ("max pooling with NaN and inf in one window: XLA's "
                "select-and-scatter compares with >=, so NaN never wins "
                "and the inf element takes both windows' cotangents; "
                "torch's max routes to the NaN. Each window routes its "
                "cotangent to one element in both (checked by the sums)",
                0.0, 0.0,
                {0: (lambda i: ~np.isfinite(_x(i)), None, None)}),
    "_hypot": _HYPOT, "broadcast_hypot": _HYPOT,
    "_mod": _MOD, "broadcast_mod": _MOD, "elemwise_mod": _MOD,
    "_power": _POWER, "broadcast_power": _POWER,
    "gamma": _GAMMA, "gammaln": _GAMMA,
    "rsqrt": ("at -0.0: torch -0.5 * rsqrt(x)^3 = +inf, XLA -inf; "
              "elsewhere float32 rounding", ROUND, 0.0,
              {0: (lambda i: (_x(i) == 0) & np.signbit(_x(i)), INF, -INF)}),
    "tanh": ("1 - tanh^2 loses relative precision as tanh nears +-1: "
             "XLA's and torch's tanh differ by an ulp there, which moves "
             "the gradient by up to 4.8e-7 absolutely (at -8 XLA rounds "
             "tanh to -1 and the gradient to 0; torch gives 4.77e-7, the "
             "true value)", 0.0, 5e-7, {}),
    "cbrt": ("float32 rounding: at -1e-30 JAX's cbrt is 6.8e-7 from the "
             "exact value and y^-2 doubles that", 2e-6, 0.0, {}),
    "softmax": _ZERO_NOISE, "SoftmaxActivation": _ZERO_NOISE,
    "log_softmax": ("float32 rounding", ROUND, 1e-7, {}),
    **{n: ("float32 rounding", ROUND, 0.0, {}) for n in (
        "_div", "broadcast_div", "elemwise_div", "_scatter_elemwise_div",
        "_rdiv_scalar", "reciprocal", "_hypot_scalar", "arccosh",
        "arcsinh", "cosh", "log10", "log2", "rcbrt", "sin", "softsign",
        "tan")},
}
DIVERGES["Pooling_v1"] = DIVERGES["Pooling"]
# A zero gradient of the other sign: -floor(x / y) * g of a remainder and
# x^y log x * g of a power at x = 1 give -0.0 in one package and +0.0 in
# the other.  No update can see it (w - lr * -0.0 is w); the values
# compare equal.
SIGN_OF_ZERO = {"_mod", "broadcast_mod", "elemwise_mod", "_rmod_scalar",
                "_power", "broadcast_power"}


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _jax_grads(name, ins):
    attrs = ATTRS.get(name, {})
    out, vjp = jax.vjp(lambda *a: _first(J[name].fn(*a, **attrs)),
                       *[jnp.asarray(a) for a in ins])
    if not jnp.issubdtype(out.dtype, jnp.floating):
        return None
    return [np.asarray(g) for g in vjp(jnp.ones_like(out))]


def _port_grads(name, ins):
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in ins]
    out = _first(T[name].fn(*xs, **ATTRS.get(name, {})))
    if not out.is_floating_point():
        assert not out.requires_grad
        return None
    if out.requires_grad:
        out.backward(torch.ones_like(out))
    return [np.zeros_like(a) if x.grad is None else x.grad.numpy()
            for x, a in zip(xs, ins)]


@pytest.mark.parametrize("name", NAMES)
def test_shared_op_gradient_matches_jax_vjp_on_special_values(name):
    ins = _inputs(name, "f32")
    try:
        want = _jax_grads(name, ins)
    except Exception:
        # the forward sweep holds the port to refusing these too
        with pytest.raises(Exception):
            T[name].fn(*[torch.from_numpy(a.copy()) for a in ins],
                       **ATTRS.get(name, {}))
        return
    got = _port_grads(name, ins)
    assert (got is None) == (want is None), name
    if want is None:
        return
    why, rtol, atol, at = DIVERGES.get(name, ("", 0.0, 0.0, {}))
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype, (name, k, g.dtype, w.dtype)
        if k in at:
            where, port, jx = at[k]
            mask = np.broadcast_to(where(ins), g.shape)
            assert mask.any(), f"{name}: the recorded case is not swept"
            for vals, ans in ((g[mask], port), (w[mask], jx)):
                if callable(ans):
                    assert ans(vals).all(), (name, k, vals)
                elif ans is not None:
                    _same(vals, np.full_like(vals, ans))
            if name.startswith("Pooling"):
                assert g.sum() == w.sum(), (g, w)
            g, w = g[~mask], w[~mask]
        _same(g, w, rtol, atol, sign=name not in SIGN_OF_ZERO)


def test_every_recorded_gradient_divergence_still_differs():
    """An entry whose difference has gone (its op now agrees exactly)
    must leave the table."""
    for name in set(DIVERGES) | SIGN_OF_ZERO:
        ins = _inputs(name, "f32")
        got, want = _port_grads(name, ins), _jax_grads(name, ins)
        with pytest.raises(AssertionError):
            for g, w in zip(got, want):
                _same(g, w)
        assert set(DIVERGES.get(name, (0, 0, 0, {}))[3]) <= set(
            range(len(ins))), name
    assert (set(DIVERGES) | SIGN_OF_ZERO) <= set(NAMES)


SPECIAL = np.array([0.0, -0.0, NAN, 1.0, -2.0, 0.5], np.float32)


def _vjp_pair(jfn, tfn, *arrays):
    """The gradients of ``sum(f(*arrays))`` in both packages."""
    want = jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=tuple(
        range(len(arrays))))(*[jnp.asarray(a) for a in arrays])
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    tfn(*xs).sum().backward()
    return [x.grad.numpy() for x in xs], [np.asarray(w) for w in want]


@pytest.mark.parametrize("name,attrs,want", [
    ("abs", {}, [1, 1, -1, 1, -1, 1]),
    ("clip", {"a_min": 0.0, "a_max": 1.0}, [0.5, 0.5, 0, 0.5, 0, 1]),
    ("relu", {}, [0, 0, 0, 1, 0, 1]),
    ("Activation", {"act_type": "relu"}, [0, 0, 0, 1, 0, 1]),
    ("_maximum_scalar", {"scalar": 0.5}, [0, 0, 0, 1, 0, 0.5]),
    ("_minimum_scalar", {"scalar": 0.5}, [1, 1, 0, 0, 1, 0.5]),
], ids=["abs", "clip", "relu", "Activation", "max_scalar", "min_scalar"])
def test_gradient_where_a_loss_meets_a_special_value(name, attrs, want):
    """At 0, -0, NaN, 1, -2 and 0.5: ``abs`` is ``jnp.abs``'s
    ``select(x >= 0, g, -g)``; ``clip`` is ``jnp.clip``'s maximum then
    minimum, 0.5 at a tie with a bound; ``relu`` gives 0 at NaN;
    ``_maximum`` / ``_minimum`` give 0 where the result is NaN.  Exact."""
    got, jx = _vjp_pair(lambda x: J[name].fn(x, **attrs),
                        lambda x: T[name].fn(x, **attrs), SPECIAL)
    np.testing.assert_array_equal(jx[0], np.float32(want))
    np.testing.assert_array_equal(got[0], jx[0])


@pytest.mark.parametrize("name", ["_maximum", "_minimum", "broadcast_maximum",
                                  "broadcast_minimum"])
def test_extremum_gradient_with_a_nan_input_is_zero_to_both(name):
    """A NaN on either side: 0 to both (torch's ``maximum`` gives 1 to
    both); a tie: 0.5 to each.  The broadcast forms sum over the
    broadcast axis."""
    lhs = np.array([[NAN, 1.0, 2.0, 3.0], [0.0, NAN, -1.0, 4.0]],
                   np.float32)
    rhs = np.array([[1.0, NAN, 2.0, 0.0]], np.float32)
    if not name.startswith("broadcast"):
        rhs = np.repeat(rhs, 2, axis=0)
    got, want = _vjp_pair(J[name].fn, T[name].fn, lhs, rhs)
    assert want[0][0, 0] == 0 and want[0][0, 2] == 0.5
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_l1_loss_gradient_where_the_prediction_equals_the_label():
    """Gluon ``L1Loss`` where the prediction equals the label: the JAX
    package's gradient is +1/n (``jnp.abs``'s at 0), the port's was 0.
    Batch 3 of 2 features: exact, 1/2 per matching element."""
    pred = np.array([[0.5, 1.0], [2.0, -1.0], [3.0, 3.0]], np.float32)
    label = np.array([[0.5, 0.0], [2.0, -1.0], [4.0, 3.0]], np.float32)
    jp = mx.nd.array(pred)
    jp.attach_grad()
    with mx.autograd.record():
        jl = mx.gluon.loss.L1Loss()(jp, mx.nd.array(label))
    jl.backward()
    with mt.cpu():
        tp = mt.nd.array(pred)
        tp.attach_grad()
        with mt.autograd.record():
            tl = mt.gluon.loss.L1Loss()(tp, mt.nd.array(label))
        tl.backward()
    want = jp.grad.asnumpy()
    np.testing.assert_array_equal(want, np.float32(
        [[0.5, 0.5], [0.5, 0.5], [-0.5, 0.5]]))
    np.testing.assert_array_equal(tp.grad.asnumpy(), want)
    np.testing.assert_array_equal(tl.asnumpy(), jl.asnumpy())



def _gradient_penalty(p, act, x, w1, w2):
    """A relu net's gradient penalty: ``gx = d sum(y * y) / dx`` taken
    with ``create_graph``, then ``sum(gx * gx)`` back to ``x``.  Every
    path from ``x`` to ``gx`` but the relu's mask runs through the
    relu's gradient, so a relu backward that is not itself
    differentiable cuts it.  (The JAX package records the gradient as
    a function of the ``grad`` variables alone, so only ``x`` is
    compared.)  Returns ``gx`` and ``x``'s gradient."""
    xs = p.nd.array(x)
    xs.attach_grad()
    with p.autograd.record():
        h = p.nd.FullyConnected(xs, p.nd.array(w1), no_bias=True,
                                num_hidden=6)
        h = p.nd.relu(h) if act == "relu" else p.nd.Activation(
            h, act_type="relu")
        y = p.nd.FullyConnected(h, p.nd.array(w2), no_bias=True,
                                num_hidden=3)
        gx, = p.autograd.grad((y * y).sum(), [xs], create_graph=True)
        pen = (gx * gx).sum()
    pen.backward()
    return [gx.asnumpy(), xs.grad.asnumpy()]


@pytest.mark.parametrize("act", ["relu", "Activation"])
def test_second_order_through_relu_matches_jax(act):
    """``autograd.grad(create_graph=True)`` through ``relu`` and
    ``Activation(act_type='relu')``, then a backward of the penalty,
    against the JAX package: float32 sums of a few terms, rtol 1e-5.
    The second-order gradient is not zero (it would be, were the
    relu's gradient cut from the graph)."""
    rng = np.random.default_rng(16)
    x, w1, w2 = (rng.uniform(-1, 1, s).astype(np.float32)
                 for s in ((4, 5), (6, 5), (3, 6)))
    want = _gradient_penalty(mx, act, x, w1, w2)
    with mt.cpu():
        got = _gradient_penalty(mt, act, x, w1, w2)
    assert np.abs(want[1]).max() > 0.1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
