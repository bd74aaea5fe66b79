"""Shared steps of ``tests/test_torch_gluon_zoo_*.py`` (not collected):
one Gluon zoo network built in both packages with the same parameter
names and values, its inference logits, and one ``gluon.Trainer`` SGD
step through ``autograd.record()`` -> loss -> ``backward()`` ->
``step``, each package's against the port in float64.

Dropout is off (rate 0) throughout: in training its masks come from
each package's own generator, and in inference it is the identity
either way.  The
update is compared with float64 because the networks' BatchNorm
backward at batch 2 is ill-conditioned in f32 (ROADMAP §3, ``DEEP_BN``):
each package's f32 update must land within the network's budget of the
float64 one, and the port's no further than twice the JAX package's."""
import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
CPU = mt.cpu()


def batch(shape, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.randint(0, classes, shape[0]).astype(np.float32))


def build(make, x, hybridize=False, seed=0):
    """``make(pkg)`` in fresh name scopes of both packages; the JAX
    network initialized (Xavier, gaussian, magnitude 2) and the port's set
    from it by name.  With ``hybridize`` both are hybridized first: the
    JAX package's deferred initialization then takes one compile, not one
    an op (25 s against 50 s for densenet121)."""
    with mx.name.NameManager(), mt.name.NameManager():
        jnet, tnet = make(mx), make(mt)
    no_dropout(jnet)
    no_dropout(tnet)
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    mx.random.seed(seed)
    jnet.initialize(mx.initializer.Xavier(rnd_type="gaussian", magnitude=2))
    jnet(mx.nd.array(x))            # the JAX package's deferred init
    tnet.initialize(ctx=CPU)
    mt.convert.gluon_params_from_numpy(
        tnet.collect_params(),
        mt.convert.gluon_params_to_numpy(jnet.collect_params()))
    return jnet, tnet


def blocks(net):
    yield net
    for c in net._children:
        yield from blocks(c)


def no_dropout(net):
    for b in blocks(net):
        if type(b).__name__ == "Dropout":
            b._rate = 0.0
    return net


def step(pkg, net, x, y, dtype="float32"):
    """One SGD-momentum step; (logits, loss, parameters after) as
    float64 numpy."""
    tr = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    kw = {"dtype": dtype} if pkg is mt else {}
    with pkg.autograd.record():
        out = net(pkg.nd.array(x, **kw))
        loss = L(out, pkg.nd.array(y, **kw))
    loss.backward()
    tr.step(x.shape[0])
    return (out.asnumpy().astype(np.float64),
            loss.asnumpy().astype(np.float64),
            {k: v.astype(np.float64) for k, v in
             mt.convert.gluon_params_to_numpy(net.collect_params()).items()})


def close(got, want, rtol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, (what, err, scale)


def update_err(after, ref, before):
    """Largest difference of an update from ``ref``'s, over the largest
    update."""
    keys = [k for k in before if "running" not in k]
    scale = max(float(np.abs(ref[k] - before[k]).max()) for k in keys)
    return max(float(np.abs(after[k] - ref[k]).max()) for k in keys) / scale


def check_logits(make, shape, classes, infer_rtol):
    """Names and shapes and the hybridized inference logits of the network
    ``make`` builds, port against the JAX package (no training step: for
    the networks whose JAX backward takes minutes to compile at full
    size)."""
    x, _ = batch(shape, classes, 1)
    jnet, tnet = build(make, x, hybridize=True)
    jp = list(jnet.collect_params().items())
    tp = list(tnet.collect_params().items())
    assert [k for k, _ in tp] == [k for k, _ in jp]
    assert [p.shape for _, p in tp] == [p.shape for _, p in jp]
    close(tnet(mt.nd.array(x)).asnumpy(), jnet(mx.nd.array(x)).asnumpy(),
          infer_rtol, "inference logits")


def check_against_jax(make, shape, classes, hybridize, infer_rtol,
                      train_rtol, update_rtol):
    """Names and shapes, inference logits, and one Trainer step of the
    network ``make`` builds, port against the JAX package.  Returns
    (port error, JAX error) of the update against float64."""
    x, y = batch(shape, classes, 1)
    jnet, tnet = build(make, x, hybridize)
    jp = list(jnet.collect_params().items())
    tp = list(tnet.collect_params().items())
    assert [k for k, _ in tp] == [k for k, _ in jp]
    assert [p.shape for _, p in tp] == [p.shape for _, p in jp]
    before = mt.convert.gluon_params_to_numpy(tnet.collect_params())
    with mt.name.NameManager():
        net64 = make(mt)
    no_dropout(net64).initialize(ctx=CPU)
    net64.cast("float64")
    mt.convert.gluon_params_from_numpy(net64.collect_params(), before)
    if hybridize:
        net64.hybridize()
    close(tnet(mt.nd.array(x)).asnumpy(), jnet(mx.nd.array(x)).asnumpy(),
          infer_rtol, "inference logits")
    f64 = step(mt, net64, x.astype(np.float64), y, "float64")
    jo, jl, jafter = step(mx, jnet, x, y)
    to, tl, tafter = step(mt, tnet, x, y)
    # the training forward normalises by batch statistics: both packages'
    # f32 logits and loss against float64's
    for out, loss in ((to, tl), (jo, jl)):
        close(out, f64[0], train_rtol, "training logits")
        close(loss, f64[1], train_rtol, "loss")
    t_err = update_err(tafter, f64[2], before)
    j_err = update_err(jafter, f64[2], before)
    assert t_err <= update_rtol, (t_err, j_err)
    assert j_err <= update_rtol, (t_err, j_err)
    assert t_err <= 2 * j_err + 1e-5, (t_err, j_err)
    return t_err, j_err
