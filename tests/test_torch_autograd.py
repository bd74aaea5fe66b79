"""Imperative autograd of the PyTorch port against the JAX package.

The fifteen cases of ``tests/test_autograd.py`` run in both packages on
the same numpy inputs and must give the same gradients: MXNet's
semantics (only ops inside ``record()`` are differentiable, ``x.grad`` is
one object rebound by each backward, ``grad_req="add"`` accumulates,
``retain_graph``, second order through ``grad(create_graph=True)``,
``Function``, the training flag, and a variable mutated after recording
keeps the gradient of its recorded value) on top of torch autograd.  Then
the errors: a backward after the graph was freed, or on a head no
recorded op produced, raises ``MXNetError``.  Last, the flash-attention
op under ``record()`` (``nd.contrib.FlashAttention`` -> its autograd
Function -> the plain backward on the CPU) against the JAX package's
gradients (the Pallas kernels in interpret mode).

Tolerances: 1e-6 relative where both packages compute the same few f32
products exactly; 1e-4 relative and 1e-5 absolute where they sum in
another order (FullyConnected, exp/log chains); 2e-5 for attention
(f32, the order of the online softmax; measured about 2e-6 in
``tests/test_torch_attention_bwd.py``)."""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

RNG_SEED = 7


class _Pkg:
    """One package's ``nd`` and ``autograd``, with the port's arrays on
    the CPU."""

    def __init__(self, mod):
        self.mod = mod
        self.nd = mod.nd
        self.autograd = mod.autograd
        self.Error = mod.base.MXNetError

    def scope(self):
        return mt.cpu() if self.mod is mt else contextlib.nullcontext()


PKGS = (_Pkg(mx), _Pkg(mt))


def _run_both(case):
    outs = []
    for p in PKGS:
        with p.scope():
            res = case(p, np.random.RandomState(RNG_SEED))
        outs.append([np.asarray(r.asnumpy() if hasattr(r, "asnumpy") else r)
                     for r in res])
    return outs


def case_basic_backward(p, rng):
    x = p.nd.array([1.0, 2.0, 3.0])
    x.attach_grad()
    with p.autograd.record():
        y = (x * x).sum()
    y.backward()
    return [x.grad]


def case_chain_rule(p, rng):
    x = p.nd.array(rng.uniform(0.5, 2, (3, 4)).astype('f'))
    x.attach_grad()
    with p.autograd.record():
        z = p.nd.exp(p.nd.log(x) * 2.0).sum()
    z.backward()
    return [x.grad]


def case_out_grad(p, rng):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * 3.0
    y.backward(out_grad=p.nd.array([10.0, 100.0]))
    return [x.grad]


def case_grad_req_add(p, rng):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad(grad_req='add')
    buf = x.grad
    for _ in range(3):
        with p.autograd.record():
            y = (x * 2.0).sum()
        y.backward()
    assert x.grad is buf      # one buffer for the life of the variable
    return [x.grad]


def case_recording_scopes(p, rng):
    ag = p.autograd
    flags = [ag.is_recording()]
    with ag.record():
        flags += [ag.is_recording(), ag.is_training()]
        with ag.pause():
            flags += [ag.is_recording(), ag.is_training()]
        with ag.predict_mode():
            flags.append(ag.is_training())
    with ag.record(train_mode=False):
        flags += [ag.is_recording(), ag.is_training()]
    with ag.train_mode():
        flags.append(ag.is_training())
    prev = ag.set_recording(True)
    flags += [prev, ag.is_recording(), ag.set_recording(False)]
    prev = ag.set_training(True)
    flags += [prev, ag.set_training(False)]
    return [np.array(flags)]


def case_pause_stops_taping(p, rng):
    x = p.nd.array([1.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * 2
        with p.autograd.pause():
            z = y * 5  # not recorded
        w = y + 1
    w.backward()
    return [x.grad, z]


def case_detach(p, rng):
    x = p.nd.array([2.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * x
        z = y.detach() * x
    z.backward()
    return [x.grad]


def case_mark_variables(p, rng):
    x = p.nd.array([1.0, 2.0])
    g = p.nd.zeros((2,))
    p.autograd.mark_variables([x], [g])
    with p.autograd.record():
        y = (x * 5.0).sum()
    y.backward()
    return [g]


def case_grad_function(p, rng):
    x = p.nd.array([3.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * x * x
    grads = p.autograd.grad(y, [x])
    return [grads[0]]


def case_grad_create_graph_second_order(p, rng):
    x = p.nd.array([2.0])
    x.attach_grad()
    with p.autograd.record():
        y = x * x * x
        (gx,) = p.autograd.grad(y, [x], create_graph=True)
        z = gx * x  # 3x^3
    z.backward()
    return [x.grad, gx]


def case_training_flag_changes_dropout(p, rng):
    x = p.nd.ones((200, 200))
    with p.autograd.record(train_mode=False):
        y_eval = p.nd.Dropout(x, p=0.5)
    with p.autograd.record(train_mode=True):
        y_train = p.nd.Dropout(x, p=0.5)
    yt = y_train.asnumpy()
    # the draws differ between packages: compare statistics (40000
    # draws at p = 0.5: the share of zeros has a standard error of
    # 0.0025; kept values are 1 / (1 - p) = 2)
    return [y_eval, np.array([abs((yt == 0).mean() - 0.5) < 0.02,
                              set(np.unique(yt)) <= {0.0, 2.0}])]


def case_backward_through_module_ops(p, rng):
    x = p.nd.array(rng.uniform(-1, 1, (4, 5)).astype('f'))
    w = p.nd.array(rng.uniform(-1, 1, (3, 5)).astype('f'))
    b = p.nd.zeros((3,))
    for arr in (x, w, b):
        arr.attach_grad()
    with p.autograd.record():
        y = p.nd.FullyConnected(x, w, b, num_hidden=3)
        loss = (y * y).sum()
    loss.backward()
    return [x.grad, w.grad, b.grad]


def case_custom_function(p, rng):
    nd = p.nd

    class Sigmoid(p.autograd.Function):
        def forward(self, x):
            y = nd.array(1 / (1 + np.exp(-x.asnumpy())))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)

    x = nd.array(rng.uniform(-2, 2, (5,)).astype('f'))
    x.attach_grad()
    with p.autograd.record():
        y = Sigmoid()(x)
        z = y.sum()
    z.backward()
    return [x.grad, y]


def case_retain_graph(p, rng):
    x = p.nd.array([2.0])
    x.attach_grad()
    with p.autograd.record():
        y = (x * x).sum()
    y.backward(retain_graph=True)
    g1 = x.grad.asnumpy().copy()
    y.backward()
    return [g1, x.grad]


def case_inplace_mutation_versioning(p, rng):
    x = p.nd.array([1.0, 2.0])
    x.attach_grad()
    with p.autograd.record():
        y = (x * x).sum()
    x += 1.0  # mutate AFTER recording
    y.backward()
    # the gradient of the recorded value [1, 2], not of [2, 3]
    return [x.grad, x]


CASES = {name[len("case_"):]: fn for name, fn in globals().items()
         if name.startswith("case_")}
# the cases whose sums the two packages take in another order
LOOSE = {"chain_rule", "backward_through_module_ops", "custom_function"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_autograd_case_against_jax(name):
    jres, tres = _run_both(CASES[name])
    assert len(jres) == len(tres)
    tol = dict(rtol=1e-4, atol=1e-5) if name in LOOSE else dict(rtol=1e-6)
    for i, (j, t) in enumerate(zip(jres, tres)):
        assert j.shape == t.shape, (i, j.shape, t.shape)
        np.testing.assert_allclose(t, j, err_msg=f"result {i}", **tol)
    if name == "training_flag_changes_dropout":
        assert tres[1].all()


def test_there_are_fifteen_cases():
    assert len(CASES) == 15


@pytest.mark.parametrize("p", PKGS, ids=["jax", "torch"])
def test_backward_after_the_graph_is_freed_raises(p):
    with p.scope():
        x = p.nd.array([2.0])
        x.attach_grad()
        with p.autograd.record():
            y = (x * x).sum()
        y.backward()
        with pytest.raises(p.Error):
            y.backward()


@pytest.mark.parametrize("p", PKGS, ids=["jax", "torch"])
def test_backward_of_an_unrecorded_head_raises(p):
    with p.scope():
        x = p.nd.array([2.0])
        x.attach_grad()
        y = (x * x).sum()      # outside record(): not differentiable
        with pytest.raises(p.Error):
            y.backward()


def test_ops_outside_record_build_no_torch_graph():
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0])
        x.attach_grad()
        with mt.autograd.record():
            y = x * 2
        z = y * 3 + x
        assert not z.as_torch().requires_grad
        assert y.as_torch().requires_grad


def test_get_symbol_raises():
    with pytest.raises(mt.MXNetError, match="HybridBlock"):
        mt.autograd.get_symbol(None)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_under_record_against_jax(causal):
    """q, k, v marked; ``nd.contrib.FlashAttention`` under ``record()``;
    ``backward`` with a seeded out_grad.  The port's CPU path is its
    autograd Function over the plain forward and backward; the JAX
    package's is its custom_vjp over the Pallas kernels (interpret
    mode)."""
    rng = np.random.RandomState(3)
    B, H, Hk, S, D = 1, 4, 2, 40, 32
    q = rng.randn(B, H, S, D).astype(np.float32)
    k = rng.randn(B, Hk, S, D).astype(np.float32)
    v = rng.randn(B, Hk, S, D).astype(np.float32)
    g = rng.randn(B, H, S, D).astype(np.float32)
    res = []
    for p in PKGS:
        with p.scope():
            arrs = [p.nd.array(a) for a in (q, k, v)]
            for a in arrs:
                a.attach_grad()
            with p.autograd.record():
                out = p.nd.contrib.FlashAttention(*arrs, causal=causal)
            out.backward(out_grad=p.nd.array(g))
            res.append([out.asnumpy()] + [a.grad.asnumpy() for a in arrs])
    for i, (j, t) in enumerate(zip(*res)):
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5,
                                   err_msg=["out", "dq", "dk", "dv"][i])
