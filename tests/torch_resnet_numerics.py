"""How f32 rounding moves ResNet results in the two packages, on the CPU.

Run from the root of a checkout (about two minutes):

    JAX_PLATFORMS=cpu python tests/torch_resnet_numerics.py

It prints one JSON line per measurement, the numbers behind the
tolerances of ``tests/test_torch_resnet_train.py`` and of the fp32
ResNet check in ``chip_smoke.py``:

* ``golden_curve``: the ResNet-20 golden loss curve
  (``tests/golden/resnet20_loss_curve.json``) against the JAX Module's
  own run, the JAX Module's run with every initial parameter moved by one
  f32 ulp, and the port's runs from the JAX initial parameters, plain and
  moved by one ulp (largest distance over the 24 losses);
* ``digits_gradients``: the first digits batch through ResNet-20 in both
  packages, forward and gradients, each against a float64 run of the
  port (relative to the largest value);
* ``small_batch8_gradients``: the same for a small cifar-stem ResNet at
  batch 8 of random images;
* ``resnet50_fp32_vs_float64``: ``chip_smoke.py``'s fp32 check (ResNet-50,
  batch 4 of 128x128, the same seeded weights) in fp32 against float64:
  the gradient's relative distance in norm and the worst single
  parameter's, relative to its largest element.

Not a test (pytest does not collect it); it imports both packages, as
the tests do.
"""
import json
import os
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import models as jmodels  # noqa: E402
from mxnet_tpu.executor import build_interpreter as jbuild  # noqa: E402
from mxnet_tpu.models.resnet import resnet as j_resnet  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.executor import build_interpreter as tbuild  # noqa
from mxnet_tpu_torch.models.resnet import resnet as t_resnet  # noqa: E402

import chip_smoke  # noqa: E402

INPUTS = ("data", "softmax_label")
ULP = np.float32(1 + 2 ** -23)
BATCH = 50
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}


def digits_batches(steps):
    """``tests/test_convergence.py``'s batches."""
    from sklearn.datasets import load_digits
    d = load_digits()
    x = (d.images / 16.0).astype(np.float32)
    y = d.target.astype(np.float32)
    x = x.repeat(3, axis=1).repeat(3, axis=2)
    x = np.pad(x, ((0, 0), (2, 2), (2, 2)))
    x = np.stack([x, x, x], axis=1)
    order = np.random.RandomState(0).permutation(len(x))
    x, y = x[order], y[order]
    return [(x[i * BATCH:(i + 1) * BATCH], y[i * BATCH:(i + 1) * BATCH])
            for i in range(steps)]


def nll(prob, y):
    return float(-np.mean(np.log(np.maximum(
        prob[np.arange(len(y)), y.astype(int)], 1e-8))))


def jax_curve(batches, nudge):
    net = jmodels.resnet(num_classes=10, num_layers=20,
                         image_shape=(3, 28, 28))
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 28, 28))],
             label_shapes=[("softmax_label", (BATCH,))])
    mx.random.seed(7)
    np.random.seed(7)
    mod.init_params(mx.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2.0))
    args, aux = mod.get_params()
    init = ({n: v.asnumpy().copy() for n, v in args.items()},
            {n: v.asnumpy().copy() for n, v in aux.items()})
    if nudge:
        mod.set_params({n: mx.nd.array(v.asnumpy() * ULP)
                        for n, v in args.items()}, aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    losses = []
    for x, y in batches:
        mod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                    is_train=True)
        losses.append(nll(mod.get_outputs()[0].asnumpy(), y))
        mod.backward()
        mod.update()
    return np.array(losses), init


def port_curve(batches, args, aux):
    net = mt.models.resnet(num_classes=10, num_layers=20,
                           image_shape=(3, 28, 28))
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (BATCH, 3, 28, 28))],
             label_shapes=[("softmax_label", (BATCH,))])
    mod.init_params(arg_params=args, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=SGD)
    losses = []
    for x, y in batches:
        mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                    [mt.nd.array(y, ctx=mt.cpu())]),
                    is_train=True)
        losses.append(nll(mod.get_outputs()[0].asnumpy(), y))
        mod.backward()
        mod.update()
    return np.array(losses)


def jax_step(net, args, aux, x, y):
    run, names, aux_names = jbuild(net)
    pnames = [n for n in names if n not in INPUTS]

    def f(*pv):
        env = dict(zip(pnames, pv), data=jnp.asarray(x),
                   softmax_label=jnp.asarray(y))
        return run([env[n] for n in names],
                   [jnp.asarray(aux[n]) for n in aux_names],
                   jax.random.PRNGKey(0), True)[0][0]

    def step(pv):
        out, vjp = jax.vjp(f, *pv)
        return out, vjp(jnp.ones_like(out))
    out, grads = jax.jit(step)(tuple(jnp.asarray(args[n]) for n in pnames))
    return np.asarray(out, np.float64), {
        n: np.asarray(g, np.float64) for n, g in zip(pnames, grads)}


def port_step(net, args, aux, x, y, dtype):
    run, names, aux_names = tbuild(net)
    vals = [torch.from_numpy(x if n == "data" else y if n == "softmax_label"
                             else args[n]).to(dtype) for n in names]
    pnames = [n for n in names if n not in INPUTS]
    leaves = [v.requires_grad_() for n, v in zip(names, vals)
              if n in pnames]
    outs, _ = run(vals, [torch.from_numpy(aux[n]).to(dtype)
                         for n in aux_names], is_train=True)
    grads = torch.autograd.grad(outs[0], leaves, torch.ones_like(outs[0]),
                                allow_unused=True)
    return outs[0].detach().double().numpy(), {
        n: g.double().numpy() for n, g in zip(pnames, grads)
        if g is not None}


def against(truth_out, truth_grads, out, grads):
    scale = max(np.abs(g).max() for g in truth_grads.values())
    return {"forward": float(np.abs(out - truth_out).max()
                             / np.abs(truth_out).max()),
            "gradient": float(max(np.abs(grads[n] - truth_grads[n]).max()
                                  for n in truth_grads) / scale)}


def compare(jnet, tnet, args, aux, x, y):
    o64, g64 = port_step(tnet, args, aux, x, y, torch.float64)
    o32, g32 = port_step(tnet, args, aux, x, y, torch.float32)
    jo, jg = jax_step(jnet, args, aux, x, y)
    return {"jax_f32": against(o64, g64, jo, jg),
            "port_f32": against(o64, g64, o32, g32)}


def small_params(net, B, shape):
    arg_shapes, _, aux_shapes = net.infer_shape(data=(B,) + shape,
                                                softmax_label=(B,))
    rng = np.random.RandomState(0)
    args = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
                if n.endswith("_weight") else rng.uniform(0.5, 1.5, s)
                if n.endswith("_gamma") else rng.randn(*s) * 0.1)
            .astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in INPUTS}
    aux = {n: (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
               else rng.randn(*s) * 0.1).astype(np.float32)
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def main():
    batches = digits_batches(24)
    with open(os.path.join(ROOT, "tests", "golden",
                           "resnet20_loss_curve.json")) as f:
        golden = np.array(json.load(f)["losses"])
    jplain, (args, aux) = jax_curve(batches, nudge=False)
    jnudged, _ = jax_curve(batches, nudge=True)
    tplain = port_curve(batches, args, aux)
    tnudged = port_curve(batches, {n: v * ULP for n, v in args.items()},
                         aux)
    print(json.dumps({"golden_curve": {
        name: float(np.abs(c - golden).max()) for name, c in (
            ("jax", jplain), ("jax_one_ulp", jnudged), ("port", tplain),
            ("port_one_ulp", tnudged))}}))

    jnet = jmodels.resnet(num_classes=10, num_layers=20,
                          image_shape=(3, 28, 28))
    x, y = batches[0]
    print(json.dumps({"digits_gradients": compare(
        jnet, mt.models.resnet(num_classes=10, num_layers=20,
                               image_shape=(3, 28, 28)), args, aux, x, y)}))

    kw = dict(units=[1, 1, 1], num_stages=3, filter_list=[8, 8, 16, 32],
              num_classes=10, image_shape=(3, 28, 28), bottle_neck=False)
    sargs, saux = small_params(j_resnet(**kw), 8, (3, 28, 28))
    rng = np.random.RandomState(1)
    sx = rng.uniform(-1, 1, (8, 3, 28, 28)).astype(np.float32)
    sy = rng.randint(0, 10, (8,)).astype(np.float32)
    print(json.dumps({"small_batch8_gradients": compare(
        j_resnet(**kw), t_resnet(**kw), sargs, saux, sx, sy)}))

    B, shape = chip_smoke.RESNET_FP32_BATCH, chip_smoke.RESNET_FP32_IMAGE
    sym, rargs, raux = chip_smoke.resnet_numpy_params(
        mt, B, shape, chip_smoke.SEED + 7)
    rng = np.random.default_rng(chip_smoke.SEED + 8)
    rx = rng.uniform(-1, 1, (B,) + shape).astype(np.float32)
    ry = rng.integers(0, 1000, B).astype(np.float32)
    _, g64 = port_step(sym, rargs, raux, rx, ry, torch.float64)
    _, g32 = port_step(sym, rargs, raux, rx, ry, torch.float32)
    per = {n: float(np.abs(g32[n] - g64[n]).max() / np.abs(g64[n]).max())
           for n in g64}
    worst = max(per, key=per.get)
    norm = float(np.sqrt(sum(((g32[n] - g64[n]) ** 2).sum() for n in g64)
                         / sum((g ** 2).sum() for g in g64.values())))
    print(json.dumps({"resnet50_fp32_vs_float64": {
        "gradient_norm_rel": norm, "worst_param": worst,
        "worst_param_rel": per[worst]}}))


if __name__ == "__main__":
    main()
