"""The symbolic model zoo in the PyTorch port against the JAX package, and
the ops it adds (the reduce family, ``LRN``).

Every registered network is built by both packages: argument, auxiliary
and output names and shapes must be equal at the JAX package's own test
sizes (``tests/test_models.py:11-30``).  Then each runs, at a small
size and batch 2, from the same numpy weights (the port's carried over
by ``convert.params_from_numpy``, BatchNorm moving statistics
included), one inference forward that reads the moving statistics and
one training forward and backward.  Dropout draws other bits in each
package, so the networks that hold Dropout (alexnet, vgg, squeezenet)
train here with every Dropout's p set to 0 in both graphs; Dropout
itself is checked by statistics in ``tests/test_torch_predict.py``.
ViT runs its flash attention non-causal through the plain version here
(Pallas in interpret mode on the JAX side).

Tolerances (float32):
* ops, forward and ``jax.vjp`` against autograd: 1e-5 relative, 1e-6
  absolute;
* network outputs (softmax probabilities): 1e-5 absolute, summation
  order only;
* gradients: within 1e-4 of the network's largest gradient element, and
  moving statistics within 1e-4 of each one's largest element, as in
  ``tests/test_torch_resnet.py`` (BatchNorm's backward subtracts two sums
  of similar size, so f32 rounding leaves an error of the size of the
  largest terms' rounding); the deepest BatchNorm networks amplify that
  past any f32 bound, so their gradients are compared on the moving
  statistics, within 3e-3 of the largest, and their training forward
  within 5e-5 (``DEEP_BN`` below gives the measurements);
* ViT trains a separable toy task above 0.7 accuracy, the JAX package's
  own bound (its test_models.py:113).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.executor import build_interpreter as jbuild
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.executor import build_interpreter as tbuild
from mxnet_tpu_torch.ops import registry as treg

OP_TOL = dict(rtol=1e-5, atol=1e-6)
FWD_TOL = 1e-5
GRAD_RTOL = 1e-4
INPUTS = ("data", "softmax_label")


def _op_pair(name, args, attrs, grad=True):
    """Forward of op ``name`` in both packages and, with ``grad``, the
    gradient of sum(out * w) for a fixed random w (``jax.vjp`` against
    autograd)."""
    jfn, tfn = jreg.get(name).fn, treg.get(name).fn
    jout = np.asarray(jfn(*[jnp.asarray(a) for a in args], **attrs))
    tins = [torch.tensor(a, requires_grad=grad) for a in args]
    tout = tfn(*tins, **attrs)
    assert tout.shape == jout.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.detach().numpy(), jout, **OP_TOL)
    if not grad:
        return
    w = np.asarray(np.random.RandomState(9).randn(*jout.shape), np.float32)
    _, vjp = jax.vjp(lambda *xs: jfn(*xs, **attrs),
                     *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(w))
    tgrads = torch.autograd.grad(tout, tins, torch.from_numpy(w))
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **OP_TOL)


REDUCE_ATTRS = [dict(), dict(axis=1), dict(axis=(0, 2), keepdims=True),
                dict(axis=-1), dict(axis=1, exclude=True),
                dict(axis=(0, 1), exclude=True, keepdims=True)]


@pytest.mark.parametrize("attrs", REDUCE_ATTRS,
                         ids=lambda a: "-".join(f"{k}{v}" for k, v in
                                                a.items()) or "all")
@pytest.mark.parametrize("name", ["sum", "mean", "prod", "max", "min",
                                  "sum_axis", "max_axis", "min_axis"])
def test_reduce_matches_jax(name, attrs):
    # values in [0.5, 1.5) keep prod of order 1 and make ties unlikely
    x = np.random.RandomState(0).uniform(0.5, 1.5, (3, 4, 5)).astype(
        np.float32)
    _op_pair(name, [x], attrs)


@pytest.mark.parametrize("name", ["nansum", "nanprod"])
def test_nan_reduce_matches_jax(name):
    x = np.random.RandomState(1).uniform(0.5, 1.5, (3, 4, 5)).astype(
        np.float32)
    x[0, 1, 2] = x[2, 3, 0] = np.nan
    for attrs in REDUCE_ATTRS:
        _op_pair(name, [x], attrs, grad=False)
    assert treg.get("sum_axis") is treg.get("sum")


@pytest.mark.parametrize("nsize", [5, 3])
def test_lrn_matches_jax(nsize):
    x = np.random.RandomState(2).randn(2, 7, 4, 3).astype(np.float32)
    _op_pair("LRN", [x], dict(alpha=1e-2, beta=0.75, knorm=2.0,
                              nsize=nsize))


@pytest.mark.parametrize("name", [
    "sum", "sum_axis", "mean", "prod", "nansum", "nanprod", "max",
    "max_axis", "min", "min_axis", "LRN", "Dropout", "batch_dot", "repeat",
    "SwapAxis", "swapaxes", "take"])
def test_new_op_metadata_matches_jax(name):
    j, t = jreg.get(name), treg.get(name)
    for f in ("name", "num_outputs", "num_visible", "needs_rng",
              "takes_is_train", "num_aux", "arg_names", "variadic",
              "differentiable"):
        assert getattr(t, f) == getattr(j, f), (name, f)
    assert t.attr_defaults == j.attr_defaults, name


def test_lrn_stays_fp32_under_amp():
    assert "LRN" in mt.executor.AMP_FP32_OPS


# --------------------------------------------------------------------------
# the networks
# --------------------------------------------------------------------------
VIT_SMALL = dict(num_classes=10, image_shape="3,32,32", patch_size=8,
                 num_layers=2, d_model=32, num_heads=4, num_kv_heads=2)

# tests/test_models.py:11-30's SMALL and LARGE sizes (resnet-50 and
# resnext there are its slow tier), and a small ViT
NAME_CASES = [
    ("mlp", dict(num_classes=10), (2, 1, 28, 28)),
    ("lenet", dict(num_classes=10), (2, 1, 28, 28)),
    ("resnet", dict(num_layers=18, num_classes=10, image_shape="3,32,32"),
     (2, 3, 32, 32)),
    ("resnet", dict(num_layers=50, num_classes=10, image_shape="3,64,64"),
     (1, 3, 64, 64)),
    ("resnext", dict(num_layers=50, num_classes=10, image_shape="3,64,64",
                     num_group=4), (1, 3, 64, 64)),
    ("mobilenet", dict(num_classes=10, multiplier=0.25), (1, 3, 64, 64)),
    ("squeezenet", dict(num_classes=10), (1, 3, 64, 64)),
    ("alexnet", dict(num_classes=1000), (1, 3, 224, 224)),
    ("densenet", dict(num_layers=121, num_classes=1000), (1, 3, 224, 224)),
    ("vgg", dict(num_layers=11, num_classes=1000), (1, 3, 224, 224)),
    ("inception-bn", dict(num_classes=1000), (1, 3, 224, 224)),
    ("inception-v3", dict(num_classes=1000), (1, 3, 299, 299)),
    ("vit", VIT_SMALL, (2, 3, 32, 32)),
]


def _build(pkg, net, kwargs):
    with pkg.name.NameManager():
        return pkg.models.get_symbol(net, **kwargs)


@pytest.mark.parametrize("net,kwargs,dshape", NAME_CASES,
                         ids=[f"{c[0]}{c[2][-1]}" for c in NAME_CASES])
def test_names_and_shapes_match_jax(net, kwargs, dshape):
    j, t = _build(mx, net, kwargs), _build(mt, net, kwargs)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.list_outputs() == j.list_outputs()
    shapes = dict(data=dshape, softmax_label=(dshape[0],))
    for a, b in zip(t.infer_shape(**shapes), j.infer_shape(**shapes)):
        assert [tuple(s) for s in a] == [tuple(s) for s in b]
    assert t.infer_shape(**shapes)[1] == [(dshape[0],
                                           kwargs["num_classes"])]


def test_every_registered_name_builds():
    """The port registers the JAX package's names and aliases."""
    assert sorted(mt.models._REGISTRY) == sorted(mx.models._REGISTRY)
    for alias, name in (("inception_bn", "inception-bn"),
                        ("inception_v3", "inception-v3")):
        assert mt.models._REGISTRY[alias] is mt.models._REGISTRY[name]
    with pytest.raises(ValueError, match="unknown network"):
        mt.models.get_symbol("ssd")


# small sizes, batch 2: the SMALL list's networks at its sizes, the
# others at the least images their strides allow
RUN_CASES = [
    ("mlp", dict(num_classes=10), (2, 1, 28, 28)),
    ("lenet", dict(num_classes=10), (2, 1, 28, 28)),
    ("resnet", dict(num_layers=18, num_classes=10, image_shape="3,32,32"),
     (2, 3, 32, 32)),
    ("mobilenet", dict(num_classes=10, multiplier=0.25), (2, 3, 128, 128)),
    ("squeezenet", dict(num_classes=10), (2, 3, 64, 64)),
    ("resnext", dict(num_layers=50, num_classes=10,
                     image_shape="3,128,128", num_group=4),
     (2, 3, 128, 128)),
    ("alexnet", dict(num_classes=10), (2, 3, 112, 112)),
    ("vgg", dict(num_layers=11, num_classes=10), (2, 3, 32, 32)),
    ("densenet", dict(num_layers=121, num_classes=10), (2, 3, 128, 128)),
    ("inception-bn", dict(num_classes=10), (2, 3, 128, 128)),
    ("inception-v3", dict(num_classes=10), (2, 3, 200, 200)),
    ("vit", VIT_SMALL, (2, 3, 32, 32)),
]


def _params(net, dshape, seed=0):
    """He-scaled weights, gamma near 1, small biases and moving
    statistics near (0, 1), as numpy."""
    arg_shapes, _, aux_shapes = net.infer_shape(data=dshape,
                                                softmax_label=(dshape[0],))
    rng = np.random.RandomState(seed)
    args = {}
    for n, s in zip(net.list_arguments(), arg_shapes):
        if n in INPUTS:
            continue
        if n.endswith("_weight") and len(s) > 1:
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        elif n.endswith("_gamma"):
            v = rng.uniform(0.5, 1.5, s)
        else:
            v = rng.randn(*s) * 0.1
        args[n] = v.astype(np.float32)
    aux = {}
    for n, s in zip(net.list_auxiliary_states(), aux_shapes):
        v = (rng.uniform(0.5, 1.5, s) if n.endswith("_var")
             else rng.randn(*s) * 0.1)
        aux[n] = v.astype(np.float32)
    return args, aux


def _edit(pkg, net, op, **attrs):
    """``net`` with ``attrs`` set on every node of ``op``, through the
    graph's JSON."""
    graph = json.loads(net.tojson())
    for node in graph["nodes"]:
        if node["op"] == op:
            node.setdefault("attrs", {}).update(attrs)
    return pkg.sym.load_json(json.dumps(graph))


def _no_dropout(pkg, net):
    """``net`` with every Dropout's p set to 0 (the identity)."""
    return _edit(pkg, net, "Dropout", p="0.0")


def _jax_step(net, args, aux, x, y, is_train, grad=True):
    """(output, {param: grad} or None, {aux: value}) by the JAX package's
    interpreter, jitted, with jax.vjp in training unless ``grad`` is
    False."""
    run, names, aux_names = jbuild(net)
    pnames = [n for n in names if n not in INPUTS]

    def f(*pv):
        env = dict(zip(pnames, pv), data=jnp.asarray(x),
                   softmax_label=jnp.asarray(y))
        outs, new_aux = run([env[n] for n in names],
                            [jnp.asarray(aux[n]) for n in aux_names],
                            jax.random.PRNGKey(0), is_train)
        return outs[0], new_aux

    def step(pv):
        if not (is_train and grad):
            out, new_aux = f(*pv)
            return out, None, new_aux
        out, vjp, new_aux = jax.vjp(f, *pv, has_aux=True)
        return out, vjp(jnp.ones_like(out)), new_aux
    out, grads, new_aux = jax.jit(step)(
        tuple(jnp.asarray(args[n]) for n in pnames))
    return (np.asarray(out),
            grads and {n: np.asarray(g) for n, g in zip(pnames, grads)},
            {n: np.asarray(v) for n, v in zip(aux_names, new_aux)})


def _torch_step(net, args, aux, x, y, is_train, grad=True):
    """The same by the port's interpreter and torch.autograd.grad (a
    Dropout graph gets a seeded generator; at inference or at p = 0 it
    draws nothing).  The CPU's oneDNN convolutions are off: they pick
    algorithms (Winograd) whose f32 rounding moved ResNet-18's gradients
    by 4.6e-3 of their largest element against float64 (1.4e-6 without
    them); the card runs cuDNN, not oneDNN."""
    run, names, aux_names = tbuild(net)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))
    vals = [t(x if n == "data" else y if n == "softmax_label" else args[n])
            for n in names]
    grad = grad and is_train
    leaves = [v.requires_grad_() for n, v in zip(names, vals)
              if n not in INPUTS and grad]
    with torch.backends.mkldnn.flags(enabled=False):
        outs, new_aux = run(vals, [t(aux[n]) for n in aux_names],
                            is_train=is_train,
                            generator=torch.Generator().manual_seed(0))
        grads = None
        if grad:
            pnames = [n for n in names if n not in INPUTS]
            gs = torch.autograd.grad(outs[0], leaves,
                                     torch.ones_like(outs[0]),
                                     allow_unused=True)
            grads = {n: (np.zeros(args[n].shape, np.float32) if g is None
                         else g.numpy()) for n, g in zip(pnames, gs)}
    return (outs[0].detach().numpy(), grads,
            {n: v.detach().numpy() for n, v in zip(aux_names, new_aux)})


def _case(net, kwargs, dshape):
    """Both symbols, the JAX package's numpy weights, the port's copy of
    them through ``params_from_numpy``, and a batch."""
    jnet, tnet = _build(mx, net, kwargs), _build(mt, net, kwargs)
    args, aux = _params(jnet, dshape)
    targs, taux = mt.params_from_numpy(
        args, aux, mt.cpu(), tnet,
        {"data": dshape, "softmax_label": (dshape[0],)})
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, dshape).astype(np.float32)
    y = rng.randint(0, kwargs["num_classes"], dshape[0]).astype(np.float32)
    return (jnet, tnet, args, aux, {n: v.numpy() for n, v in targs.items()},
            {n: v.numpy() for n, v in taux.items()}, x, y)


def _assert_grads(got, want, rtol):
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n in want:
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= rtol * scale, (n, err, scale)


def _assert_aux(got, want, rtol):
    for n in want:
        scale = max(float(np.abs(want[n]).max()), 1e-30)
        err = float(np.abs(got[n] - want[n]).max())
        assert err <= rtol * scale, (n, err, scale)


@pytest.mark.parametrize("net,kwargs,dshape", RUN_CASES,
                         ids=[c[0] for c in RUN_CASES])
def test_inference_forward_matches_jax(net, kwargs, dshape):
    """fp32, moving statistics, Dropout off: the network's output."""
    jnet, tnet, args, aux, targs, taux, x, y = _case(net, kwargs, dshape)
    jout, _, _ = _jax_step(jnet, args, aux, x, y, False)
    tout, _, _ = _torch_step(tnet, targs, taux, x, y, False)
    assert tout.shape == (dshape[0], kwargs["num_classes"])
    np.testing.assert_allclose(tout, jout, rtol=0, atol=FWD_TOL)


# the networks whose first layers' gradients pass 14-120 BatchNorm
# backwards over batch statistics; at batch 2 each of those subtracts two
# sums of similar size, so f32 rounding is amplified: against the port in
# float64, both packages' f32 gradients land 1-4% of the largest gradient
# away (measured, port and JAX package: mobilenet 2.7e-3 and 2.4e-3,
# resnext 2.6e-2 and 3.1e-2, densenet 9.0e-3 and 3.1e-2, inception-bn
# 1.7e-2 and 1.2e-2, inception-v3 3.6e-2 and 3.1e-2; the JAX package
# keeps BatchNorm's statistics in f32 even under x64, so no float64
# comparison is possible).  Their gradients are compared with every
# BatchNorm on its moving statistics (use_global_stats), an affine map,
# where the f32 runs land at most 7.7e-4 of the largest gradient from the
# port's float64 (the JAX package on resnext; the port at most 3.5e-4,
# inception-bn): DEEP_GRAD_RTOL is 4x that.  A larger batch does not cure
# it (``tests/torch_numerics.py deep_bn``; ROADMAP §3 keeps the gap
# open).  Their batch-statistics forward lands up to 1.7e-5 from float64
# (resnext): DEEP_FWD_TOL is 3x that.
DEEP_BN = ("mobilenet", "resnext", "densenet", "inception-bn",
           "inception-v3")
DEEP_GRAD_RTOL = 3e-3
DEEP_FWD_TOL = 5e-5


def _global_stats(pkg, net):
    """``net`` with every BatchNorm on its moving statistics."""
    return _edit(pkg, net, "BatchNorm", use_global_stats="True")


@pytest.mark.parametrize("net,kwargs,dshape", RUN_CASES,
                         ids=[c[0] for c in RUN_CASES])
def test_training_step_matches_jax(net, kwargs, dshape):
    """fp32, Dropout off: the training forward (batch statistics), the
    moving statistics it writes, and every parameter's gradient."""
    jnet, tnet, args, aux, targs, taux, x, y = _case(net, kwargs, dshape)
    jnet, tnet = _no_dropout(mx, jnet), _no_dropout(mt, tnet)
    deep = net in DEEP_BN
    # a deep network's gradients come from its moving-statistics graph
    jout, jgrads, jaux = _jax_step(jnet, args, aux, x, y, True, not deep)
    tout, tgrads, tnew = _torch_step(tnet, targs, taux, x, y, True,
                                     not deep)
    np.testing.assert_allclose(tout, jout, rtol=0,
                               atol=DEEP_FWD_TOL if deep else FWD_TOL)
    _assert_aux(tnew, jaux, GRAD_RTOL)
    if deep:
        _, jgrads, _ = _jax_step(_global_stats(mx, jnet), args, aux, x, y,
                                 True)
        _, tgrads, _ = _torch_step(_global_stats(mt, tnet), targs, taux, x,
                                   y, True)
    _assert_grads(tgrads, jgrads, DEEP_GRAD_RTOL if deep else GRAD_RTOL)
    assert max(float(np.abs(g).max()) for g in tgrads.values()) > 0


@pytest.mark.parametrize("net,kwargs,dshape", [
    c for c in RUN_CASES if c[0] in ("alexnet", "vgg", "squeezenet")],
    ids=["alexnet", "vgg", "squeezenet"])
def test_dropout_networks_infer_as_without_dropout(net, kwargs, dshape):
    """At inference every Dropout is the identity: the output equals the
    same graph's with p = 0, bit for bit."""
    tnet = _build(mt, net, kwargs)
    args, aux = _params(tnet, dshape)
    x = np.random.RandomState(2).uniform(-1, 1, dshape).astype(np.float32)
    y = np.zeros(dshape[0], np.float32)
    a, _, _ = _torch_step(tnet, args, aux, x, y, False)
    b, _, _ = _torch_step(_no_dropout(mt, tnet), args, aux, x, y, False)
    np.testing.assert_array_equal(a, b)


def test_vit_trains_above_chance():
    """tests/test_models.py:113 on the port: a one-layer GQA ViT learns a
    linearly separable toy task through Module.fit."""
    rng = np.random.RandomState(0)
    n, nc = 64, 4
    y = rng.randint(0, nc, (n,)).astype("f")
    x = rng.randn(n, 3, 16, 16).astype("f") * 0.1
    for i in range(n):
        x[i] += int(y[i]) * 0.5
    net = mt.models.vit(nc, image_shape=(3, 16, 16), patch_size=8,
                        num_layers=1, d_model=32, num_heads=4,
                        num_kv_heads=2)
    mod = mt.mod.Module(net, context=mt.cpu())
    np.random.seed(0)    # the iterator's shuffle draws from numpy
    it = mt.io.NDArrayIter(x, y, batch_size=32, shuffle=True)
    mt.random.seed(5)
    mod.fit(it, num_epoch=12, optimizer="adam",
            optimizer_params={"learning_rate": 3e-3},
            initializer=mt.initializer.Xavier(), eval_metric="acc")
    it.reset()
    metric = mt.metric.Accuracy()
    mod.score(it, metric)
    acc = dict(metric.get_name_value())["accuracy"]
    assert acc > 0.7, acc
