"""ResNet training through ``Module`` in the PyTorch port against the
JAX package: SGD-momentum steps with weight decay through both Modules
from the same parameters (parameters, BatchNorm moving statistics and
momentum compared), and the JAX package's ResNet-20 golden loss curve
(``tests/golden/resnet20_loss_curve.json``) trained by the port from the
JAX Module's own initial parameters.

Tolerances:
* Module steps: each parameter's change, each momentum and each moving
  statistic within 1e-4 of the network's largest value of that kind.
  Both compute in f32 and differ in summation order; BatchNorm's
  backward subtracts sums of similar size, so a parameter whose
  gradient cancels to near 0 carries the rounding of the largest terms.
  The JAX package's reductions on the CPU lose more as they grow: at
  batch 8 of this net its f32 gradients are up to 1.6e-3 of the largest
  away from a float64 run (the port's: 6e-7;
  ``tests/torch_numerics.py resnet``), so the steps run at batch 2;
* the golden curve: ``rtol=2e-3, atol=2e-3``, the golden's own
  (``tests/test_convergence.py``), on its first two steps.  Beyond them
  the curve is f32 rounding amplified: the JAX package misses its own
  golden by 0.082 when its initial parameters move by one ulp
  (``tests/torch_numerics.py resnet``), and so
  does any arithmetic other than XLA-CPU's (the last test shows the
  amplification in the port)."""
import json
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models.resnet import resnet as j_resnet

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.resnet import resnet as t_resnet
import torch_threads  # noqa: F401,E402  a worker's share of the cores

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden", "resnet20_loss_curve.json")
GOLDEN_BATCH = 50
RTOL = 1e-4
INPUTS = ("data", "softmax_label")


def _small_params(net, B, shape, seed=0):
    """He-scaled weights, gamma near 1, small beta; moving statistics
    near (0, 1); as numpy."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + shape,
                                                softmax_label=(B,))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in INPUTS:
            continue
        if n.endswith("_weight"):
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        args[n] = v.astype(np.float32)
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _within(got, want, what):
    scale = max(float(np.abs(v).max()) for v in want.values())
    for n in want:
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= RTOL * scale, (what, n, err, scale)


def test_module_sgd_steps_match_jax():
    """3 steps of SGD (lr 0.1, momentum 0.9, wd 1e-4, rescale 1/batch)
    through the JAX Module and the port's, on a small cifar-stem ResNet
    from the same parameters and random batches: the parameters' changes,
    the momenta and the moving statistics agree."""
    B, shape = 2, (3, 28, 28)
    kw = dict(units=[1, 1, 1], num_stages=3, filter_list=[8, 8, 16, 32],
              num_classes=10, image_shape=shape, bottle_neck=False)
    args, aux = _small_params(j_resnet(**kw), B, shape)
    rng = np.random.RandomState(1)
    batches = [(rng.uniform(-1, 1, (B,) + shape).astype(np.float32),
                rng.randint(0, 10, (B,)).astype(np.float32))
               for _ in range(3)]
    got = {}
    for pkg, net, ctx in ((mx, j_resnet(**kw), mx.cpu()),
                          (mt, t_resnet(**kw), mt.cpu())):
        mod = pkg.mod.Module(net, context=ctx)
        mod.bind(data_shapes=[("data", (B,) + shape)],
                 label_shapes=[("softmax_label", (B,))])
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in args.items()},
                        aux_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in aux.items()})
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9, "wd": 1e-4})
        for x, y in batches:
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                         [pkg.nd.array(y, ctx=ctx)]),
                        is_train=True)
            mod.backward()
            mod.update()
        a, x = mod.get_params()
        states = (mod._opt_states if pkg is mx else mod._updater.states)
        got[pkg] = ({n: v.asnumpy() - args[n] for n, v in a.items()},
                    {n: v.asnumpy() for n, v in x.items()},
                    {n: st[0].asnumpy() for n, st in states.items()})
    for what, j, t in zip(("parameter change", "moving statistic",
                           "momentum"), got[mx], got[mt]):
        assert set(j) == set(t)
        _within(t, j, what)


def _digits_batches(batch=50, steps=24):
    """``tests/test_convergence.py``'s batches, copied."""
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    x = x.repeat(3, axis=1).repeat(3, axis=2)
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))
    x = np.stack([x, x, x], axis=1)
    rs = np.random.RandomState(0)
    order = rs.permutation(len(x))
    x, y = x[order], y[order]
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch])
            for i in range(steps)]


@pytest.fixture(scope="module")
def resnet20_jax_init():
    """ResNet-20's parameters as the JAX Module initialises them in
    ``tests/test_convergence.py`` (seed 7; only ``init_params`` runs on
    the JAX side), as numpy."""
    jnet = jmodels.resnet(num_classes=10, num_layers=20,
                          image_shape=(3, 28, 28))
    jmod = mx.mod.Module(jnet, context=mx.cpu())
    jmod.bind(data_shapes=[("data", (GOLDEN_BATCH, 3, 28, 28))],
              label_shapes=[("softmax_label", (GOLDEN_BATCH,))])
    mx.random.seed(7)
    np.random.seed(7)
    jmod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                           magnitude=2.0))
    jargs, jaux = jmod.get_params()
    return ({n: v.asnumpy().copy() for n, v in jargs.items()},
            {n: v.asnumpy().copy() for n, v in jaux.items()})


def _golden_losses(args, aux, steps=24):
    """The port's Module, on the CPU, trains ``args``/``aux`` for the
    first ``steps`` of ``tests/test_convergence.py``'s 24 SGD-momentum
    steps on its digits batches; the loss of each step, as that test
    takes it."""
    net = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 28, 28))
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (GOLDEN_BATCH, 3, 28, 28))],
             label_shapes=[("softmax_label", (GOLDEN_BATCH,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 1e-4})
    losses = []
    for bx, by in _digits_batches(GOLDEN_BATCH, steps):
        db = mt.io.DataBatch(data=[mt.nd.array(bx, ctx=mt.cpu())],
                             label=[mt.nd.array(by, ctx=mt.cpu())])
        mod.forward(db, is_train=True)
        prob = mod.get_outputs()[0].asnumpy()
        nll = -np.mean(np.log(np.maximum(
            prob[np.arange(len(by)), by.astype(int)], 1e-8)))
        losses.append(float(nll))
        mod.backward()
        mod.update()
    return np.array(losses)


def test_resnet20_golden_curve_from_jax_init(resnet20_jax_init):
    """The port trains the JAX package's initial ResNet-20 parameters on
    the golden's batches: the first two losses (the initial forward and
    one SGD-momentum update through BatchNorm) follow
    ``tests/golden/resnet20_loss_curve.json`` within the golden's own
    tolerance, and the curve learns as the golden test requires (the
    least of the last 3 losses under 0.6 of the first).  Past step 2 the
    curve is f32 rounding amplified (next test), so no other arithmetic
    than XLA-CPU's own can follow the golden there."""
    losses = _golden_losses(*resnet20_jax_init)
    with open(GOLDEN) as f:
        want = json.load(f)["losses"]
    np.testing.assert_allclose(losses[:2], want[:2], rtol=2e-3, atol=2e-3)
    assert min(losses[-3:]) < 0.6 * losses[0], losses


def test_resnet20_golden_curve_amplifies_one_ulp(resnet20_jax_init):
    """Why the golden holds only two steps across packages: moving every
    initial parameter by one f32 ulp (a relative 2**-23) moves the port's
    own curve by more than the golden's tolerance within 4 steps, while
    the first two losses stay within it.  (The JAX package's own curve,
    perturbed the same way, leaves its golden by 0.082 within 24.)"""
    args, aux = resnet20_jax_init
    base = _golden_losses(args, aux, steps=4)
    nudged = _golden_losses(
        {n: v * np.float32(1 + 2 ** -23) for n, v in args.items()}, aux,
        steps=4)
    np.testing.assert_allclose(nudged[:2], base[:2], rtol=2e-3, atol=2e-3)
    assert np.abs(nudged - base).max() > 2e-3 + 2e-3 * base.max()
