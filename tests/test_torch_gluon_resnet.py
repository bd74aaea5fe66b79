"""The Gluon model zoo's ResNets in the PyTorch port against the JAX
package: ``resnet18_v1``, ``resnet50_v1`` and ``resnet50_v2`` at full
depth and width on small images (ImageNet stem, 64x64, 10 classes, batch
2), built in both packages in fresh name scopes, the port's weights
copied from the JAX package's initialization (``convert``).

For each network, imperatively and hybridized: the parameter names and
shapes, the inference forward, and one SGD-momentum step (lr 0.1,
momentum 0.9, wd 1e-4) through ``autograd.record()`` -> loss ->
``backward()`` -> ``Trainer.step(2)``.  Then the
``hybridize(compute_dtype="bfloat16")`` contract: fp32 master weights and
gradients, bf16 products.

Tolerances come from a float64 run of the same step (the port in
float64 on the CPU; ``tests/torch_numerics.py gluon`` prints them):

* the inference logits within 1e-5 of their largest value in both
  packages' f32 (BatchNorm with its running statistics: a plain chain);
* in training mode BatchNorm normalises 8 values a channel in the last
  stage (batch 2, 2x2): ResNet-50's training logits then sit up to
  5.1e-5 (port) and 8.6e-5 (JAX) of their largest value from float64,
  so the packages are held to 2e-4 of it there, ResNet-18's to 1e-5;
* the step's update: the deep BatchNorm backward at batch 2 is
  ill-conditioned (ROADMAP §3): from float64 the port's f32 update lands
  6.0e-6 (ResNet-18 v1), 3.1e-2 (ResNet-50 v1) and 7.8e-3 (ResNet-50 v2)
  of the largest update away, the JAX package's 9.3e-6, 3.3e-2 and
  1.9e-2.  So each network's update is held to float64 (1e-4 for
  ResNet-18, 5e-2 for the ResNet-50s, the card check's budget), and the
  port no further from float64 than twice the JAX package is;
* each running statistic within 1e-4 of the largest (4.3e-5 measured).

oneDNN's convolutions stay on: PyTorch's plain f32 CPU convolutions
move ResNet-18 v1's stage-4 backward at this size by 4% of its largest
gradient from float64, oneDNN's by 7e-6 (ROADMAP §3).  The JAX package's
hybridized path does not update BatchNorm's running statistics (ROADMAP
§3), so those are compared imperatively, and the port's hybridized ones
against its imperative ones."""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

NETS = ("resnet18_v1", "resnet50_v1", "resnet50_v2")
B, IMAGE, CLASSES = 2, (3, 64, 64), 10
OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
INFER_RTOL = 1e-5
TRAIN_OUT_RTOL = {"resnet18_v1": 1e-5, "resnet50_v1": 2e-4,
                  "resnet50_v2": 2e-4}
UPDATE_F64_RTOL = {"resnet18_v1": 1e-4, "resnet50_v1": 5e-2,
                   "resnet50_v2": 5e-2}
RUNNING_RTOL = 1e-4
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _cpu_default():
    with CPU:
        yield


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, (B,) + IMAGE).astype(np.float32),
            rng.randint(0, CLASSES, B).astype(np.float32))


def _build(name, seed=0):
    with mx.name.NameManager(), mt.name.NameManager():
        jnet = getattr(mx.gluon.model_zoo.vision, name)(classes=CLASSES)
        tnet = mt.gluon.model_zoo.vision.get_model(name, classes=CLASSES)
    mx.random.seed(seed)
    jnet.initialize(mx.initializer.Xavier(rnd_type="gaussian",
                                          magnitude=2))
    x, _ = _batch()
    jnet(mx.nd.array(x))            # the JAX package's deferred init
    tnet.initialize(ctx=CPU)
    mt.convert.gluon_params_from_numpy(
        tnet.collect_params(),
        mt.convert.gluon_params_to_numpy(jnet.collect_params()))
    return jnet, tnet


def _step(pkg, net, x, y, dtype="float32"):
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {"dtype": dtype} if pkg is mt else {}
    with pkg.autograd.record():
        out = net(pkg.nd.array(x, **kw))
        loss = L(out, pkg.nd.array(y, **kw))
    loss.backward()
    tr.step(B)
    return (out.asnumpy().astype(np.float64),
            loss.asnumpy().astype(np.float64),
            {k: v.astype(np.float64) for k, v in
             mt.convert.gluon_params_to_numpy(net.collect_params()).items()})


def _close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


_CACHE = {}


def _reference(name):
    """The network's initial parameters, the batch, the float64 step
    (the port in float64) and the port's imperative f32 step, once a
    network."""
    if name not in _CACHE:
        jnet, tnet = _build(name)
        before = mt.convert.gluon_params_to_numpy(jnet.collect_params())
        x, y = _batch(1)
        with mt.name.NameManager():
            net64 = mt.gluon.model_zoo.vision.get_model(name,
                                                        classes=CLASSES)
        net64.initialize(ctx=CPU)
        net64.cast("float64")
        mt.convert.gluon_params_from_numpy(net64.collect_params(), before)
        f64 = _step(mt, net64, x.astype(np.float64), y, "float64")
        _CACHE[name] = (before, x, y, f64, _step(mt, tnet, x, y))
    return _CACHE[name]


def _update_err(after, ref, before):
    """Largest difference of the update from ``ref``'s, over the
    network's largest update."""
    keys = [k for k in before if "running" not in k]
    scale = max(float(np.abs(ref[k] - before[k]).max()) for k in keys)
    return max(float(np.abs(after[k] - ref[k]).max()) for k in keys) / scale


@pytest.mark.parametrize("hybridize", [False, True], ids=["imperative",
                                                          "hybridized"])
@pytest.mark.parametrize("name", NETS)
def test_resnet_against_jax(name, hybridize):
    before, x, y, f64, t_imp = _reference(name)
    jnet, tnet = _build(name)
    jp = list(jnet.collect_params().items())
    tp = list(tnet.collect_params().items())
    assert [k for k, _ in tp] == [k for k, _ in jp]
    assert [p.shape for _, p in tp] == [p.shape for _, p in jp]
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    _close(tnet(mt.nd.array(x)).asnumpy(), jnet(mx.nd.array(x)).asnumpy(),
           INFER_RTOL, "inference logits")
    jo, jl, jafter = _step(mx, jnet, x, y)
    to, tl, tafter = _step(mt, tnet, x, y) if hybridize else t_imp
    _close(to, jo, TRAIN_OUT_RTOL[name], "training logits")
    _close(tl, jl, TRAIN_OUT_RTOL[name], "loss")
    t_err = _update_err(tafter, f64[2], before)
    j_err = _update_err(jafter, f64[2], before)
    assert t_err <= UPDATE_F64_RTOL[name], (t_err, j_err)
    assert j_err <= UPDATE_F64_RTOL[name], (t_err, j_err)
    assert t_err <= 2 * j_err + 1e-5, (t_err, j_err)
    running = [k for k in before if "running" in k]
    if not hybridize:
        scale = max(float(np.abs(jafter[k]).max()) for k in running)
        for k in running:
            assert float(np.abs(tafter[k] - jafter[k]).max()) \
                <= RUNNING_RTOL * scale, k
    else:
        # the port's hybridized statistics against its imperative ones
        for k in running:
            _close(tafter[k], t_imp[2][k], RUNNING_RTOL, k)
            assert not np.array_equal(tafter[k], before[k]), k


def test_get_model_names_the_roadmap_for_the_rest_of_the_zoo():
    """The rest of the zoo is ported (G2, once named by this test's
    errors): ``get_model`` knows every name the JAX package's knows; an
    unknown name is not supported, and a missing weight file raises."""
    assert sorted(mt.gluon.model_zoo.vision._models) == \
        sorted(mx.gluon.model_zoo.vision._models)
    with pytest.raises(mt.MXNetError, match="not supported"):
        mt.gluon.model_zoo.get_model("resnet7_v1")
    with pytest.raises(mt.MXNetError):
        mt.gluon.model_zoo.vision.resnet18_v1(pretrained=True,
                                              root="/nonexistent")


# a small input each network accepts: 32x32 takes the ResNets, VGG's
# five pools, SqueezeNet and MobileNet to their global pools; AlexNet's
# stride-4 stem and three pools need 63x63, DenseNet's final
# AvgPool2D(7) 224x224 and Inception v3's AvgPool2D(8) 299x299
ZOO_INPUT = {"alexnet": 63, "densenet": 224, "inceptionv3": 299}


@pytest.mark.parametrize("name", sorted(mx.gluon.model_zoo.vision._models))
def test_every_zoo_name_builds_and_runs_a_forward_pass(name):
    size = next((v for k, v in ZOO_INPUT.items() if name.startswith(k)), 32)
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.get_model(name, classes=3)
    net.initialize(mt.initializer.Xavier(), ctx=CPU)
    out = net(mt.nd.array(np.random.RandomState(0).uniform(
        -1, 1, (1, 3, size, size)).astype(np.float32)))
    assert out.shape == (1, 3)
    assert np.isfinite(out.asnumpy()).all()
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.gluon.model_zoo.vision.get_model(name, pretrained=True,
                                            root="/nonexistent")


def test_bf16_compute_contract():
    """``hybridize(compute_dtype="bfloat16")``: the parameters and their
    gradients stay fp32 (the masters); every convolution and product runs
    in bf16 (seen by a TorchDispatchMode); BatchNorm's statistics and the
    running statistics stay fp32; the logits come out bf16 and the loss
    follows them."""
    from torch.utils._python_dispatch import TorchDispatchMode
    with mt.name.NameManager():
        net = mt.gluon.model_zoo.vision.resnet18_v1(classes=CLASSES)
    net.initialize(mt.initializer.Xavier(), ctx=CPU)
    net.hybridize(compute_dtype="bfloat16")
    x, y = _batch()
    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = str(func)
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            # shape inference runs the ops on meta tensors: not compute
            if ("convolution" in name or "mm" in name) and ts \
                    and ts[0].device.type != "meta":
                seen.append((name, tuple(a.dtype for a in ts)))
            return func(*args, **(kwargs or {}))
    L = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with Spy():
        with mt.autograd.record():
            out = net(mt.nd.array(x, ctx=CPU))
            loss = L(out, mt.nd.array(y, ctx=CPU))
    loss.backward()
    assert out.dtype == "bfloat16"
    assert seen and all(all(d == torch.bfloat16 for d in dts)
                        for _, dts in seen), seen[:3]
    for k, p in net.collect_params().items():
        assert p.data().as_torch().dtype == torch.float32, k
        if p.grad_req != "null":
            g = p.grad().as_torch()
            assert g.dtype == torch.float32 and torch.isfinite(g).all(), k
    rm = net.features[1].running_mean.data().as_torch()
    assert rm.dtype == torch.float32 and rm.abs().sum() > 0
