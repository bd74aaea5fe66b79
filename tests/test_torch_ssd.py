"""SSD in the PyTorch port against the JAX package: the ``ssd_toy`` and
``ssd_vgg16`` graphs (names, shapes, 8108 anchors at 300x300), two SGD
steps of ``ssd_toy`` through both Modules (momentum, weight decay,
gradient clipping) from the same parameters and batches, the detect
graph's ``predict``, the targets under a bf16 compute dtype, JAX
parameters carried into the port, and one ``ssd_vgg16`` forward at a
small input.

Tolerances, each with its reason:

* Targets, class labels and detection ids are exact: the choices are
  made on the same numbers (see tests/test_torch_detection.py).
* Losses and class probabilities within 1e-5, parameters' changes
  within 1e-4 of the largest change: both packages compute in f32 and
  differ in the summation order of the convolutions (up to 576 products
  here), which the backward carries into every gradient; the SGD step
  (lr 0.01) then takes a fraction of that.
* Detection rows' scores and boxes within 1e-5: the softmax and the
  decode of f32 convolution outputs that differ in their last bits.  For
  the same reason two scores equal to that rounding may sort either way
  (the op-level tests hold the order exactly on equal inputs), so the
  detect graph's kept detections are compared as sets.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu import models as jmodels
from mxnet_tpu.executor import build_interpreter as jbuild

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_interpreter as tbuild

VAL = dict(rtol=1e-5, atol=1e-5)
RTOL = 1e-4
OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4,
       "clip_gradient": 4.0}


def ssd_batch(rng, batch, classes, size, max_objects):
    """train_ssd.py's synthetic images scaled to ``classes``: 1-4 filled
    rectangles an image, each in the intensity of its class, on a noise
    background; labels (batch, max_objects, 5) [class, x0, y0, x1, y1]
    in normalised corners, padded with -1."""
    x = rng.uniform(0, 0.25, (batch, 3, size, size)).astype(np.float32)
    y = np.full((batch, max_objects, 5), -1.0, np.float32)
    for b in range(batch):
        for k in range(rng.randint(1, min(4, max_objects) + 1)):
            c = rng.randint(0, classes)
            w, h = rng.randint(size // 6, size // 2, 2)
            x0, y0 = rng.randint(0, size - w), rng.randint(0, size - h)
            x[b, :, y0:y0 + h, x0:x0 + w] = 0.3 + 0.7 * c / max(classes - 1, 1)
            y[b, k] = [c, x0 / size, y0 / size, (x0 + w) / size,
                       (y0 + h) / size]
    return x, y


def _jax_params(net, shapes, seed):
    """Xavier parameters of the JAX Module, as numpy."""
    mod = mx.mod.Module(net, context=mx.cpu(), data_names=("data",),
                        label_names=("label",) if "label" in shapes else None)
    mod.bind(data_shapes=[("data", shapes["data"])],
             label_shapes=[("label", shapes["label"])]
             if "label" in shapes else None)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier())
    return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}


def _run(pkg, run, args):
    """An inference run of either package's interpreter: the outputs."""
    if pkg is mx:
        return run(args, [], None, False)[0]
    return run(args, [])[0]


def test_graphs_equal_the_jax_package():
    for mode in ("train", "detect"):
        for name, shape, lab in (("ssd_toy", (2, 3, 64, 64), (2, 4, 5)),
                                 ("ssd_vgg16", (2, 3, 300, 300),
                                  (2, 16, 5))):
            j = getattr(jmodels, name)(mode=mode)
            t = getattr(mt.models, name)(mode=mode)
            assert t.list_arguments() == j.list_arguments()
            assert t.list_outputs() == j.list_outputs()
            kw = dict(data=shape, label=lab) if mode == "train" \
                else dict(data=shape)
            assert t.infer_shape(**kw) == j.infer_shape(**kw)
    out = mt.models.ssd_vgg16().infer_shape(data=(2, 3, 300, 300),
                                            label=(2, 16, 5))[1]
    assert out == [(2, 21, 8108), (2, 4 * 8108), (2, 8108)]
    args = mt.models.ssd_vgg16().infer_shape(data=(1, 3, 300, 300),
                                             label=(1, 16, 5))[0]
    assert sum(int(np.prod(s)) for s in args) - 3 * 300 * 300 - 80 \
        == 26284974
    with pytest.raises(ValueError, match="unknown network"):
        mt.models.get_symbol("ssd")


def _module_steps(pkg, ctx, net, params, batches, B, G):
    mod = pkg.mod.Module(net, context=ctx, data_names=("data",),
                         label_names=("label",))
    mod.bind(data_shapes=[("data", (B, 3, 64, 64))],
             label_shapes=[("label", (B, G, 5))])
    mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                for n, v in params.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(OPT))
    outs = []
    for x, y in batches:
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                     [pkg.nd.array(y, ctx=ctx)]),
                    is_train=True)
        outs.append([o.asnumpy() for o in mod.get_outputs()])
        mod.backward()
        mod.update()
    new = {n: v.asnumpy() for n, v in mod.get_params()[0].items()}
    return outs, {n: new[n] - params[n] for n in params}


def test_ssd_toy_module_sgd_steps_match_jax():
    """Two steps of train_ssd.py's optimizer (SGD, momentum, wd, clip 4)
    through both Modules at batch 2: the three heads' outputs at each
    step and the parameters' changes agree; the loss heads' gradients
    (SoftmaxOutput multi_output + use_ignore + valid over (N, 3, A), the
    smooth-L1 MakeLoss with valid normalisation, cls_label through
    BlockGrad and MakeLoss(grad_scale=0)) are the JAX package's."""
    B, G = 2, 4
    rng = np.random.RandomState(0)
    batches = [ssd_batch(rng, B, 2, 64, G) for _ in range(2)]
    net_j = jmodels.ssd_toy(num_classes=2)
    params = _jax_params(net_j, dict(data=(B, 3, 64, 64),
                                     label=(B, G, 5)), 3)
    jo, ju = _module_steps(mx, mx.cpu(), net_j, params, batches, B, G)
    to, tu = _module_steps(mt, mt.cpu(), mt.models.ssd_toy(num_classes=2),
                           params, batches, B, G)
    for js, ts in zip(jo, to):
        np.testing.assert_allclose(ts[0], js[0], **VAL)        # cls_prob
        np.testing.assert_allclose(ts[1], js[1], **VAL)        # loc_loss
        np.testing.assert_array_equal(ts[2], js[2])            # cls_label
        assert (js[2] > 0).any() and (js[2] == 0).any()
    scale = max(float(np.abs(v).max()) for v in ju.values())
    for n in ju:
        err = float(np.abs(tu[n] - ju[n]).max())
        assert err <= RTOL * scale, (n, err, scale)


def test_detect_predict_matches_jax():
    """The detect graph through Module.predict (NDArrayIter, no label)
    in both packages from the same parameters."""
    B = 2
    net_j = jmodels.ssd_toy(num_classes=2, mode="detect")
    params = _jax_params(net_j, dict(data=(B, 3, 64, 64)), 5)
    x, _ = ssd_batch(np.random.RandomState(1), 4, 2, 64, 4)
    got = []
    for pkg, net, ctx in ((mx, net_j, mx.cpu()),
                          (mt, mt.models.ssd_toy(num_classes=2,
                                                 mode="detect"), mt.cpu())):
        mod = pkg.mod.Module(net, context=ctx, data_names=("data",),
                             label_names=None)
        mod.bind(data_shapes=[("data", (B, 3, 64, 64))], for_training=False)
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        it = pkg.io.NDArrayIter(data=x, batch_size=B)
        got.append(mod.predict(it).asnumpy())
    j, t = got
    assert t.shape == j.shape == (4, 1280, 6)
    # the scores come sorted, so every row's score agrees
    np.testing.assert_allclose(t[..., 1], j[..., 1], **VAL)
    # two boxes whose scores agree to the f32 rounding of the two
    # packages' convolutions may come in either order, so the kept
    # detections are held as sets: the same class, score and box
    for n in range(t.shape[0]):
        jk, tk = j[n][j[n, :, 0] >= 0], t[n][t[n, :, 0] >= 0]
        assert len(tk) == len(jk) > 0
        free = np.ones(len(jk), bool)
        for row in tk:
            hit = free & (jk[:, 0] == row[0]) & \
                (np.abs(jk[:, 1:] - row[1:]).max(1) <= 1e-5)
            assert hit.any(), row
            free[np.argmax(hit)] = False


def test_targets_under_bf16_equal_the_jax_package():
    """Under compute_dtype=bfloat16 both executors hand MultiBoxTarget
    bf16 anchors, labels and class scores (it is not among the float32
    ops of either package), so 0.337 arrives as 0.3359 and the IoUs, the
    mining softmax and the encoding run in bf16: the two packages give the
    same targets."""
    rng = np.random.RandomState(2)
    B, G, C = 4, 16, 21
    feat = mx.sym.Variable("feat")
    _, y = ssd_batch(rng, B, C - 1, 300, G)
    cls_pred = (rng.randn(B, C, 9 * 9 * 6) * 2).astype(np.float32)
    vals = dict(feat=np.zeros((B, 8, 9, 9), np.float32), label=y,
                cls_pred=cls_pred)
    outs = []
    for pkg, build, wrap in (
            (mx, jbuild, jnp.asarray),
            (mt, tbuild, lambda v: torch.from_numpy(v))):
        feat = pkg.sym.Variable("feat")
        anchors = pkg.sym.MultiBoxPrior(feat, sizes=(0.37, 0.447),
                                        ratios=(1, 2, 0.5, 3, 1.0 / 3),
                                        clip=True)
        tgt = pkg.sym.MultiBoxTarget(anchors, pkg.sym.Variable("label"),
                                     pkg.sym.Variable("cls_pred"),
                                     negative_mining_ratio=3.0)
        run, names, _ = build(tgt, compute_dtype="bfloat16")
        res = _run(pkg, run, [wrap(vals[n]) for n in names])
        outs.append([np.asarray(jnp.asarray(o).astype(jnp.float32))
                     if pkg is mx else o.float().numpy() for o in res])
    for j, t in zip(*outs):
        np.testing.assert_array_equal(t, j)
    assert (outs[1][2] > 0).sum() > 0


def test_jax_params_into_the_port_give_the_same_forward():
    """convert.params_from_numpy takes the JAX ssd_toy Module's
    parameters by name; the port's forward from them equals the JAX
    one."""
    B, G = 2, 4
    net_j = jmodels.ssd_toy(num_classes=3)
    shapes = dict(data=(B, 3, 64, 64), label=(B, G, 5))
    params = _jax_params(net_j, shapes, 7)
    net_t = mt.models.ssd_toy(num_classes=3)
    args, aux = mt.convert.params_from_numpy(params, {}, mt.cpu(), net_t,
                                             shapes)
    x, y = ssd_batch(np.random.RandomState(4), B, 3, 64, G)
    jmod = mx.mod.Module(net_j, context=mx.cpu(), label_names=("label",))
    jmod.bind(data_shapes=[("data", shapes["data"])],
              label_shapes=[("label", shapes["label"])], for_training=False)
    jmod.init_params(arg_params={n: mx.nd.array(v)
                                 for n, v in params.items()})
    jmod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.array(y)]),
                 is_train=False)
    tmod = mt.mod.Module(net_t, context=mt.cpu(), label_names=("label",))
    tmod.bind(data_shapes=[("data", shapes["data"])],
              label_shapes=[("label", shapes["label"])], for_training=False)
    tmod.init_params(arg_params={n: mt.nd.NDArray(v)
                                 for n, v in args.items()})
    tmod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                 [mt.nd.array(y, ctx=mt.cpu())]),
                 is_train=False)
    for j, t in zip(jmod.get_outputs(), tmod.get_outputs()):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **VAL)
    with pytest.raises(mt.base.MXNetError):
        mt.convert.params_from_numpy(
            {k: v for k, v in params.items() if k != "loc_pred0_bias"},
            {}, mt.cpu(), net_t, shapes)


def test_ssd_vgg16_forward_at_a_small_input_matches_jax():
    """ssd_vgg16 (VGG16-reduced, six scales) at 3x96x96, batch 1, from
    the same small random parameters: the three heads agree."""
    shapes = dict(data=(1, 3, 96, 96), label=(1, 3, 5))
    net_j = jmodels.ssd_vgg16(num_classes=4)
    arg_shapes = net_j.infer_shape(**shapes)[0]
    rng = np.random.RandomState(8)
    params = {n: (rng.randn(*s) * np.sqrt(1.0 / np.prod(s[1:]))
                  ).astype(np.float32)
              for n, s in zip(net_j.list_arguments(), arg_shapes)
              if n not in shapes}
    x, y = ssd_batch(rng, 1, 4, 96, 3)
    outs = []
    for pkg, net, build, wrap in (
            (mx, net_j, jbuild, jnp.asarray),
            (mt, mt.models.ssd_vgg16(num_classes=4), tbuild,
             torch.from_numpy)):
        run, names, _ = build(net)
        vals = dict(params, data=x, label=y)
        res = _run(pkg, run, [wrap(vals[n]) for n in names])
        outs.append([np.asarray(o) if pkg is mx else o.numpy()
                     for o in res])
    for j, t in zip(*outs):
        np.testing.assert_allclose(t, j, **VAL)


# the slice's modules, held to the port's hermetic rule
SSD_MODULES = ["ops.detection", "ops.contrib_ops", "ops.spatial",
               "models.ssd"]


def test_ssd_trains_and_detects_hermetically():
    """An ssd_toy training step through Module and a detect-graph
    predict on the CPU, in a fresh process, load no jax and no
    mxnet_tpu, start no CUDA context and build no kernel; the slice's
    modules are loaded; Module defaults to gpu(0)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import json, sys, numpy as np, torch\n"
        "import mxnet_tpu_torch as mt\n"
        "assert mt.mod.Module(mt.models.ssd_toy())._context == mt.gpu(0)\n"
        "x = np.random.RandomState(0).rand(2, 3, 64, 64).astype('f')\n"
        "y = np.full((2, 2, 5), -1.0, 'f')\n"
        "y[:, 0] = [0, 0.2, 0.2, 0.7, 0.7]\n"
        "mod = mt.mod.Module(mt.models.ssd_toy(), context=mt.cpu(),\n"
        "                    label_names=('label',))\n"
        "mod.bind([('data', x.shape)], [('label', y.shape)])\n"
        "mod.init_params(mt.init.Xavier())\n"
        "mod.init_optimizer(optimizer_params={'clip_gradient': 4.0})\n"
        "mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],\n"
        "                            [mt.nd.array(y, ctx=mt.cpu())]))\n"
        "mod.update()\n"
        "det = mt.mod.Module(mt.models.ssd_toy(mode='detect'),\n"
        "                    context=mt.cpu(), label_names=None)\n"
        "det.bind([('data', x.shape)], for_training=False)\n"
        "det.init_params(arg_params=mod.get_params()[0])\n"
        "out = det.predict(mt.io.NDArrayIter(x, batch_size=2))\n"
        "assert out.shape == (2, 1280, 6)\n"
        "print(json.dumps({'mods': sorted(sys.modules),\n"
        "  'cuda_init': torch.cuda.is_initialized(),\n"
        "  'libs': sorted(mt.cuda_lib._libs)}))\n")
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    bad = [m for m in out["mods"]
           if any(m == f or m.startswith(f + ".")
                  for f in ("jax", "jaxlib", "mxnet_tpu"))]
    assert bad == []
    assert out["cuda_init"] is False
    assert out["libs"] == []
    for mod in SSD_MODULES:
        assert "mxnet_tpu_torch." + mod in out["mods"], mod
