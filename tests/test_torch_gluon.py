"""Gluon of the PyTorch port against the JAX package.

The ported cases of ``tests/test_gluon.py`` (parameters, scoping,
constants, deferred initialization, hybridize = imperative, BatchNorm's
running statistics, the Trainer, the losses, nesting, files, SymbolBlock,
utils, ``hybridize(compute_dtype="bfloat16")``), then the cross-package
contract: the same construction gives the same parameter and block names;
from the same weights (``convert.gluon_params_from_numpy``) a forward, a
backward and a Trainer step agree, imperatively and hybridized; a
``save_params`` file and ``Trainer.save_states`` of either package load
into the other; ``export`` loads into the port's ``Module``; and the
network of ``examples/gluon/stochastic_depth.py`` (same seeds, so the
same skip decisions) trains two steps alike in both packages.

Tolerances (float32): 1e-5 relative and absolute for forwards and SGD
steps of these small networks (both packages sum in f32 in another
order); 1e-4 where a BatchNorm backward or Adam's division by sqrt(v)
amplifies that rounding; the stated exceptions say why."""
import contextlib

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon, autograd, nd
from mxnet_tpu_torch.gluon import nn
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CPU = mt.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _cpu_default():
    with CPU:
        yield


@contextlib.contextmanager
def _fresh_names():
    with mx.name.NameManager(), mt.name.NameManager():
        yield


def _to_numpy(params):
    return mt.convert.gluon_params_to_numpy(params)


# --------------------------------------------------------------------------
# the ported cases of tests/test_gluon.py
# --------------------------------------------------------------------------
def test_parameter():
    p = gluon.Parameter('weight', shape=(10, 10))
    p.initialize(init='xavier', ctx=CPU)
    assert p.shape == (10, 10)
    assert p.data().shape == (10, 10)
    assert len(p.list_data()) == 1 and p.list_ctx() == [CPU]
    assert p.grad().shape == (10, 10)
    p.zero_grad()
    assert not p.grad().asnumpy().any()
    p.set_data(np.ones((10, 10), np.float32))
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((10, 10)))
    p.cast('float16')
    assert p.data().dtype == np.float16 and p.grad().dtype == np.float16
    assert p.data()._grad is p.grad()
    p.grad_req = 'null'
    with pytest.raises(mt.MXNetError, match="null"):
        p.grad()
    with pytest.raises(mt.MXNetError, match="D1"):
        p.place(None)


def test_parameter_dict_scoping():
    params = gluon.ParameterDict('net_')
    p = params.get('weight', shape=(4, 4))
    assert p.name == 'net_weight'
    assert params.get('weight') is p
    with pytest.raises(mt.MXNetError, match="D1"):
        params.place(None)


def test_constant():
    c = gluon.Constant('const', np.ones((2, 2)))
    c.initialize(ctx=CPU)
    assert c.grad_req == 'null'
    np.testing.assert_allclose(c.data().asnumpy(), np.ones((2, 2)))


def test_dense_eager_and_shapes():
    net = nn.Dense(8, in_units=4, activation='relu')
    net.initialize(ctx=CPU)
    y = net(nd.array(np.random.randn(2, 4).astype('float32')))
    assert y.shape == (2, 8)
    assert (y.asnumpy() >= 0).all()


def test_deferred_init_and_hybridize_consistency():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation='relu'))
        net.add(nn.Dense(5))
    x = nd.array(np.random.RandomState(0).randn(6, 12).astype('float32'))
    net.initialize(mt.initializer.Xavier(), ctx=CPU)
    assert net[0].weight._deferred_init is not None
    y_eager = net(x).asnumpy()
    assert net[0].weight.shape == (16, 12)
    net.hybridize()
    np.testing.assert_allclose(net(x).asnumpy(), y_eager, rtol=1e-6,
                               atol=1e-6)


def test_deferred_init_through_the_hybridized_path():
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(4, 3), nn.BatchNorm(), nn.Dense(3))
    net.initialize(ctx=CPU)
    net.hybridize()
    y = net(nd.array(np.random.randn(2, 2, 6, 6).astype('float32')))
    assert y.shape == (2, 3)
    assert net[0].weight.shape == (4, 2, 3, 3)
    assert net[1].running_mean.shape == (4,)
    assert net[2].weight.shape == (3, 64)


def _grads_of(net, x, lbl, loss):
    with autograd.record():
        out = loss(net(x), lbl)
    out.backward()
    return {k: p.grad().asnumpy() for k, p in net.collect_params().items()
            if p.grad_req != 'null'}


def test_hybrid_autograd_matches_eager():
    rng = np.random.RandomState(2)
    x = nd.array(rng.randn(4, 6).astype('float32'))
    lbl = nd.array(rng.randn(4, 3).astype('float32'))
    L = gluon.loss.L2Loss()
    res = []
    for hybridize in (False, True):
        mt.random.seed(0)
        with mt.name.NameManager():
            net = nn.HybridSequential()
            with net.name_scope():
                net.add(nn.Dense(8, activation='tanh'))
                net.add(nn.Dense(3))
        net.initialize(mt.initializer.Xavier(rnd_type='gaussian'))
        if hybridize:
            net.hybridize()
        res.append(_grads_of(net, x, lbl, L))
    assert sorted(res[0]) == sorted(res[1])
    for k in res[0]:
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("hybridize", [False, True])
def test_conv2d_pool_batchnorm(hybridize):
    """BatchNorm's running statistics move under record() (training) and
    only then, imperatively and hybridized (the JAX package's hybridized
    path leaves them at their initial values: ROADMAP §3)."""
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Conv2D(8, kernel_size=3, padding=1))
        net.add(nn.BatchNorm())
        net.add(nn.Activation('relu'))
        net.add(nn.MaxPool2D(2, 2))
        net.add(nn.Flatten())
        net.add(nn.Dense(4))
    net.initialize()
    if hybridize:
        net.hybridize()
    x = nd.array(np.random.randn(2, 3, 8, 8).astype('float32'))
    assert net(x).shape == (2, 4)
    rm_before = net[1].running_mean.data().asnumpy().copy()
    with autograd.record(train_mode=False):
        net(x)
    np.testing.assert_array_equal(net[1].running_mean.data().asnumpy(),
                                  rm_before)
    with autograd.record():
        net(x)
    assert not np.allclose(rm_before, net[1].running_mean.data().asnumpy())


def test_trainer_convergence():
    rng = np.random.RandomState(0)
    w_true = rng.randn(3, 5).astype('float32')
    x_np = rng.randn(64, 5).astype('float32')
    net = nn.Dense(3, in_units=5, use_bias=False)
    net.initialize(mt.initializer.Normal(0.1))
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.5})
    L = gluon.loss.L2Loss()
    x, y = nd.array(x_np), nd.array(x_np @ w_true.T)
    for _ in range(100):
        with autograd.record():
            loss = L(net(x), y)
        loss.backward()
        trainer.step(64)
    assert loss.asnumpy().mean() < 1e-3


def test_losses_against_jax():
    """Every loss on the same inputs in both packages, with and without
    sample_weight; CTCLoss (ported in C1.b.2) with its lengths too
    (``tests/test_torch_ctc.py`` holds its gradient)."""
    rng = np.random.RandomState(9)
    p = rng.randn(4, 5).astype('f')
    lab = rng.randn(4, 5).astype('f')
    sign = rng.choice([-1.0, 1.0], (4, 5)).astype('f')
    cls = np.array([0, 3, 4, 1], 'f')
    q = np.abs(rng.randn(4, 5)).astype('f')
    q /= q.sum(axis=1, keepdims=True)
    sw = rng.uniform(0.1, 2.0, (4, 1)).astype('f')
    a, pos, neg = (rng.randn(4, 5).astype('f') for _ in range(3))
    cases = [("L2Loss", {}, (p, lab)), ("L1Loss", {}, (p, lab, sw)),
             ("SigmoidBinaryCrossEntropyLoss", {}, (p, (lab > 0) * 1.0)),
             ("SigmoidBCELoss", {"from_sigmoid": True},
              (1 / (1 + np.exp(-p)), (lab > 0) * 1.0)),
             ("SoftmaxCrossEntropyLoss", {}, (p, cls)),
             ("SoftmaxCELoss", {"sparse_label": False}, (p, q, sw)),
             ("KLDivLoss", {}, (np.log(q), q)),
             ("KLDivLoss", {"from_logits": False}, (p, q)),
             ("HuberLoss", {}, (p, lab)), ("HingeLoss", {}, (p, sign)),
             ("SquaredHingeLoss", {"margin": 0.5}, (p, sign)),
             ("LogisticLoss", {}, (p, sign)),
             ("LogisticLoss", {"label_format": "binary"},
              (p, (sign > 0) * 1.0)),
             ("TripletLoss", {}, (a, pos, neg))]
    for name, kw, arrays in cases:
        arrays = [np.asarray(x, np.float32) for x in arrays]
        j = getattr(mx.gluon.loss, name)(**kw)(
            *[mx.nd.array(x) for x in arrays]).asnumpy()
        t = getattr(gluon.loss, name)(**kw)(
            *[nd.array(x) for x in arrays]).asnumpy()
        np.testing.assert_allclose(t, j, err_msg=name, **TOL)
    pred = rng.randn(4, 6, 5).astype('f')               # NTC, blank 0
    ctc_lab = np.array([[1, 2, 0], [3, 3, 4], [2, 0, 0], [4, 1, 2]], 'f')
    lens = np.array([6, 5, 4, 6], 'f')
    j = mx.gluon.loss.CTCLoss()(mx.nd.array(pred), mx.nd.array(ctc_lab),
                                mx.nd.array(lens)).asnumpy()
    t = gluon.loss.CTCLoss()(nd.array(pred), nd.array(ctc_lab),
                             nd.array(lens)).asnumpy()
    np.testing.assert_allclose(t, j, err_msg="CTCLoss", **TOL)


def test_loss_hybridized_equals_imperative():
    rng = np.random.RandomState(1)
    p, cls = rng.randn(6, 7).astype('f'), rng.randint(0, 7, 6).astype('f')
    L = gluon.loss.SoftmaxCrossEntropyLoss()
    eager = L(nd.array(p), nd.array(cls)).asnumpy()
    L.hybridize()
    np.testing.assert_allclose(L(nd.array(p), nd.array(cls)).asnumpy(),
                               eager, rtol=1e-6)


def test_sequential_nesting_collect_params():
    net = nn.Sequential()
    inner = nn.Sequential()
    inner.add(nn.Dense(4, in_units=4))
    net.add(inner)
    net.add(nn.Dense(2, in_units=4))
    assert len(list(net.collect_params().keys())) == 4
    assert len(net) == 2 and net[0] is inner
    assert len(net.collect_params('.*weight')) == 2


def test_save_load_params(tmp_path):
    net = nn.Dense(4, in_units=3)
    net.initialize(mt.initializer.Xavier())
    f = str(tmp_path / 'dense.params')
    net.save_params(f)
    net2 = nn.Dense(4, in_units=3, prefix=net.prefix)
    net2.initialize()
    net2.load_params(f)
    np.testing.assert_array_equal(net.weight.data().asnumpy(),
                                  net2.weight.data().asnumpy())


def test_symbol_block():
    data = mt.sym.Variable('data')
    fc = mt.sym.FullyConnected(data, num_hidden=6, name='fc')
    out = mt.sym.Activation(fc, act_type='relu')
    blk = gluon.SymbolBlock(out, data)
    blk.collect_params().initialize(ctx=CPU)
    for p in blk.collect_params().values():
        if p._deferred_init is not None:
            p._finish_deferred_init((6, 4) if 'weight' in p.name else (6,))
    x = np.random.randn(2, 4).astype('float32')
    y = blk(nd.array(x))
    assert y.shape == (2, 6)
    w, b = blk.params['fc_weight'].data().asnumpy(), \
        blk.params['fc_bias'].data().asnumpy()
    np.testing.assert_allclose(y.asnumpy(), np.maximum(x @ w.T + b, 0),
                               rtol=1e-5, atol=1e-6)


def test_split_and_load_and_clip():
    x = np.arange(24, dtype='float32').reshape(8, 3)
    parts = gluon.utils.split_data(nd.array(x), 4)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    with pytest.raises(ValueError):
        gluon.utils.split_data(nd.array(x), 3)
    assert len(gluon.utils.split_data(nd.array(x), 3,
                                      even_split=False)) == 3
    loaded = gluon.utils.split_and_load(x, [CPU])
    assert len(loaded) == 1 and loaded[0].context == CPU
    arrs = [nd.array(np.ones(4, 'float32') * 3),
            nd.array(np.ones(4, 'float32') * 4)]
    held = [a for a in arrs]
    total = gluon.utils.clip_global_norm(arrs, 1.0)
    assert abs(total - 10.0) < 1e-4
    new_norm = np.sqrt(sum((a.asnumpy() ** 2).sum() for a in held))
    np.testing.assert_allclose(new_norm, 1.0, rtol=1e-4)


def test_utils_sha1_and_download(tmp_path):
    import hashlib
    f = tmp_path / "w.params"
    f.write_bytes(b"abc")
    sha = hashlib.sha1(b"abc").hexdigest()
    assert gluon.utils.check_sha1(str(f), sha)
    assert not gluon.utils.check_sha1(str(f), "0" * 40)
    assert gluon.utils.download("http://x/w.params", path=str(f),
                                sha1_hash=sha) == str(f)
    with pytest.raises(mt.MXNetError):
        gluon.utils.download("http://x/absent.params", path=str(tmp_path))


def test_hybridize_compute_dtype_bf16():
    """bf16 compute over fp32 master parameters trains (the Gluon analog
    of Module(compute_dtype=...))."""
    net = nn.HybridSequential()
    net.add(nn.Dense(16, activation='relu'), nn.Dense(2))
    net.initialize()
    net.hybridize(compute_dtype="bfloat16")
    trainer = gluon.Trainer(net.collect_params(), 'sgd',
                            {'learning_rate': 0.5})
    X = np.random.RandomState(0).randn(64, 2).astype('f')
    Y = nd.array(((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype('f'))
    X = nd.array(X)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for _ in range(120):
        with autograd.record():
            out = net(X)
            loss = loss_fn(out, Y).mean()
        loss.backward()
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
    assert out.dtype == "bfloat16"
    for p in net.collect_params().values():
        assert p.data().asnumpy().dtype == np.float32
        assert p.data().as_torch().dtype == torch.float32
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


def test_trainer_kvstore_and_mesh_options():
    net = nn.Dense(2, in_units=3)
    net.initialize()
    for kv in (None, "device", "local"):
        gluon.Trainer(net.collect_params(), "sgd", kvstore=kv)
    # dist_async needs its servers (MXT_SERVER_URIS), as in the JAX
    # package: the store is made at the first step
    gluon.Trainer(net.collect_params(), "sgd", kvstore="dist_async")
    with pytest.raises(mt.MXNetError, match="type"):
        gluon.Trainer(net.collect_params(), "sgd",
                      compression_params={"type": "3bit"})
    with pytest.raises(mt.MXNetError, match="D1"):
        gluon.Trainer(net.collect_params(), "sgd", zero_stage=1)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": 0.3})
    assert tr.learning_rate == 0.3
    tr.set_learning_rate(0.1)
    assert tr.learning_rate == 0.1
    tr.allreduce_grads()


def test_step_k_is_k_steps():
    rng = np.random.RandomState(4)
    X = rng.randn(3, 8, 5).astype('f')
    Y = rng.randn(3, 8, 2).astype('f')
    res = []
    for use_k in (False, True):
        with mt.name.NameManager():
            net = nn.Dense(2, in_units=5)
        net.initialize(mt.initializer.Constant(0.1))
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": 0.1})
        L = gluon.loss.L2Loss()
        if use_k:
            losses = tr.step_k(lambda x, y: L(net(x), y), nd.array(X),
                               nd.array(Y)).asnumpy()
        else:
            losses = []
            for j in range(3):
                with autograd.record():
                    loss = L(net(nd.array(X[j])), nd.array(Y[j]))
                loss.backward()
                tr.step(8)
                losses.append(loss.asnumpy())
            losses = np.stack(losses)
        res.append((losses, net.weight.data().asnumpy()))
    np.testing.assert_allclose(res[1][0], res[0][0], rtol=1e-6)
    np.testing.assert_allclose(res[1][1], res[0][1], rtol=1e-6)


def test_layers_forward_against_jax():
    """Each layer of nn/basic_layers.py and nn/conv_layers.py with
    parameters from the JAX package's initialization: the same names and
    the same forward, imperatively (training mode off)."""
    rng = np.random.RandomState(5)
    img = rng.randn(2, 3, 7, 7).astype('f')
    vol = rng.randn(1, 2, 4, 5, 4).astype('f')
    seq = rng.randn(2, 3, 9).astype('f')
    flat = rng.randn(3, 6).astype('f')
    layers = [
        ("Dense", (5,), {"activation": "tanh"}, flat),
        # in_units given: the JAX package cannot infer a bias-free Dense's
        # weight (its symbolic trace passes the absent bias on as None)
        ("Dense", (4,), {"flatten": False, "use_bias": False,
                         "in_units": 7}, img),
        ("Activation", ("softrelu",), {}, flat),
        ("Dropout", (0.5,), {}, flat),
        ("BatchNorm", (), {"scale": False}, img),
        ("InstanceNorm", (), {"scale": True}, img),
        ("LayerNorm", (), {}, flat),
        ("Embedding", (10, 4), {}, np.array([[1, 9], [0, 3]], 'f')),
        ("Flatten", (), {}, img),
        ("LeakyReLU", (0.2,), {}, flat), ("PReLU", (), {}, img),
        ("ELU", (), {}, flat), ("SELU", (), {}, flat),
        ("Swish", (), {}, flat), ("GELU", (), {}, flat),
        ("Conv1D", (4, 3), {"strides": 2, "padding": 1}, seq),
        ("Conv2D", (4, (3, 2)), {"dilation": (2, 1), "groups": 1}, img),
        ("Conv2D", (6, 3), {"groups": 3, "activation": "relu"}, img),
        ("Conv3D", (3, 2), {"padding": 1}, vol),
        ("Conv1DTranspose", (3, 3), {"strides": 2}, seq),
        ("Conv2DTranspose", (4, 3), {"strides": 2, "padding": 1,
                                     "output_padding": 1}, img),
        ("Conv3DTranspose", (2, 2), {"strides": (1, 2, 1)}, vol),
        ("MaxPool1D", (2,), {}, seq), ("MaxPool2D", (3, 2), {}, img),
        ("MaxPool2D", (3, 2, 1), {"ceil_mode": True}, img),
        ("MaxPool3D", (2,), {}, vol), ("AvgPool1D", (3,), {}, seq),
        ("AvgPool2D", (2,), {"padding": 1}, img),
        ("AvgPool3D", (2,), {}, vol), ("GlobalMaxPool1D", (), {}, seq),
        ("GlobalMaxPool2D", (), {}, img), ("GlobalMaxPool3D", (), {}, vol),
        ("GlobalAvgPool1D", (), {}, seq), ("GlobalAvgPool2D", (), {}, img),
        ("GlobalAvgPool3D", (), {}, vol),
        ("ReflectionPad2D", (2,), {}, img),
    ]
    for name, args, kw, x in layers:
        with _fresh_names():
            jl = getattr(mx.gluon.nn, name)(*args, **kw)
            tl = getattr(nn, name)(*args, **kw)
        assert tl.name == jl.name and tl.prefix == jl.prefix
        jl.initialize(mx.initializer.Uniform(0.5))
        jy = jl(mx.nd.array(x))
        jp = mt.convert.gluon_params_to_numpy(jl.collect_params())
        tl.initialize()
        if jp:
            mt.convert.gluon_params_from_numpy(tl.collect_params(), jp)
        ty = tl(nd.array(x))
        assert sorted(jp) == sorted(tl.collect_params().keys()), name
        np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), err_msg=name,
                                   **TOL)


# --------------------------------------------------------------------------
# across packages: names, steps, files
# --------------------------------------------------------------------------
def _mlp_conv(pkg):
    g = pkg.gluon
    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(6, 3, padding=1), g.nn.BatchNorm(),
                g.nn.Activation('relu'), g.nn.MaxPool2D(2),
                g.nn.Conv2D(8, 3, strides=2), g.nn.BatchNorm(scale=False),
                g.nn.LeakyReLU(0.1), g.nn.GlobalAvgPool2D(),
                g.nn.Dense(16, activation='tanh'), g.nn.Dropout(0.0),
                g.nn.Dense(5))
    return net


def _pair(build, x_shape, seed=0):
    """The same net in both packages, from the JAX package's weights
    (after its deferred initialization)."""
    with _fresh_names():
        jnet, tnet = build(mx), build(mt)
    mx.random.seed(seed)
    jnet.initialize(mx.initializer.Xavier(rnd_type="gaussian"))
    x = np.random.RandomState(seed).randn(*x_shape).astype('f')
    jnet(mx.nd.array(x))
    tnet.initialize()
    mt.convert.gluon_params_from_numpy(tnet.collect_params(),
                                       _to_numpy(jnet.collect_params()))
    return jnet, tnet, x


def test_names_equal_across_packages():
    with _fresh_names():
        jnet, tnet = _mlp_conv(mx), _mlp_conv(mt)
        jz = mx.gluon.model_zoo.vision.resnet18_v1(classes=10)
        tz = gluon.model_zoo.vision.resnet18_v1(classes=10)
    assert list(tnet.collect_params().keys()) == \
        list(jnet.collect_params().keys())
    assert list(tz.collect_params().keys()) == \
        list(jz.collect_params().keys())
    assert [b.name for b in tnet._children] == \
        [b.name for b in jnet._children]
    assert tz.features[4].name == jz.features[4].name


@pytest.mark.parametrize("hybridize", [False, True])
def test_train_step_against_jax(hybridize):
    """Forward, backward and one SGD-momentum step from the same weights.
    BatchNorm's running statistics are compared imperatively only: the
    JAX package's hybridized path does not update them (ROADMAP §3), the
    port's does (held against the port's imperative path instead)."""
    jnet, tnet, x = _pair(_mlp_conv, (4, 3, 8, 8))
    y = np.array([0, 3, 1, 4], 'f')
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    res = []
    for pkg, net in ((mx, jnet), (mt, tnet)):
        tr = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                               {'learning_rate': 0.1, 'momentum': 0.9,
                                'wd': 1e-4})
        L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            with pkg.autograd.record():
                out = net(pkg.nd.array(x))
                loss = L(out, pkg.nd.array(y))
            loss.backward()
            tr.step(4)
        res.append((out.asnumpy(), loss.asnumpy(),
                    _to_numpy(net.collect_params())))
    (jo, jl, jp), (to, tl, tp) = res
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k in jp:
        if hybridize and "running" in k:
            continue
        # two steps through two BatchNorm backwards: 1e-4
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_hybridized_running_stats_equal_imperative():
    res = []
    for hybridize in (False, True):
        _, tnet, x = _pair(_mlp_conv, (4, 3, 8, 8))
        if hybridize:
            tnet.hybridize()
        with autograd.record():
            tnet(nd.array(x))
        res.append({k: v for k, v in _to_numpy(tnet.collect_params())
                    .items() if "running" in k})
    for k in res[0]:
        assert not np.allclose(res[0][k], 0) or "mean" not in k
        np.testing.assert_allclose(res[1][k], res[0][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_record_in_predict_mode_keeps_inference_statistics():
    _, tnet, x = _pair(_mlp_conv, (4, 3, 8, 8))
    tnet.hybridize()
    before = _to_numpy(tnet.collect_params())
    with autograd.record(train_mode=False):
        a = tnet(nd.array(x))
    b = tnet(nd.array(x))
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    after = _to_numpy(tnet.collect_params())
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)


def test_params_files_load_both_ways(tmp_path):
    jnet, tnet, x = _pair(_mlp_conv, (2, 3, 8, 8))
    fj, ft = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jnet.save_params(fj)
    tnet.save_params(ft)
    with open(fj, "rb") as a, open(ft, "rb") as b:
        assert a.read() == b.read()
    with _fresh_names():
        jnet2, tnet2 = _mlp_conv(mx), _mlp_conv(mt)
    tnet2.initialize()
    tnet2.load_params(fj)
    jnet2.initialize()
    jnet2.load_params(ft)
    for p in (_to_numpy(jnet2.collect_params()),
              _to_numpy(tnet2.collect_params())):
        for k, v in _to_numpy(jnet.collect_params()).items():
            np.testing.assert_array_equal(p[k], v, err_msg=k)


def test_trainer_states_load_both_ways(tmp_path):
    """Adam's states after two steps, saved by either package's Trainer,
    loaded by the other's: the next step agrees."""
    jnet, tnet, x = _pair(_mlp_conv, (2, 3, 8, 8))
    y = np.array([1, 2], 'f')
    trainers = {}
    for pkg, net in ((mx, jnet), (mt, tnet)):
        tr = pkg.gluon.Trainer(net.collect_params(), 'adam',
                               {'learning_rate': 1e-3})
        L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        for _ in range(2):
            with pkg.autograd.record():
                loss = L(net(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
            tr.step(2)
        trainers[pkg] = tr
    fj, ft = str(tmp_path / "j.states"), str(tmp_path / "t.states")
    trainers[mx].save_states(fj)
    trainers[mt].save_states(ft)

    def states(tr):
        return {k: [np.asarray(s.asnumpy()) for s in v]
                for k, v in tr._updaters[0].states.items()}
    jstates, tstates = states(trainers[mx]), states(trainers[mt])
    assert sorted(jstates) == sorted(tstates) and len(jstates) > 8
    trainers[mx].load_states(ft)
    trainers[mt].load_states(fj)
    # each package now holds the other's states, value for value
    for got, want in ((states(trainers[mt]), jstates),
                      (states(trainers[mx]), tstates)):
        for k in want:
            for a, b in zip(got[k], want[k]):
                np.testing.assert_array_equal(a, b, err_msg=str(k))
    # and steps on from them
    for pkg, net in ((mx, jnet), (mt, tnet)):
        L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        with pkg.autograd.record():
            loss = L(net(pkg.nd.array(x)), pkg.nd.array(y))
        loss.backward()
        trainers[pkg].step(2)
        assert all(np.isfinite(v).all()
                   for v in _to_numpy(net.collect_params()).values())


def test_export_loads_into_the_ports_module(tmp_path):
    _, tnet, x = _pair(_mlp_conv, (2, 3, 8, 8))
    tnet.hybridize()
    want = tnet(nd.array(x)).asnumpy()
    prefix = str(tmp_path / "net")
    tnet.export(prefix)
    sym, args, aux = mt.model.load_checkpoint(prefix, 0)
    assert sorted(aux) == sorted(k for k in tnet.collect_params()
                                 if "running" in k)
    mod = mt.mod.Module(sym, data_names=["data0"], label_names=None,
                        context=CPU)
    mod.bind(data_shapes=[("data0", x.shape)], for_training=False)
    mod.set_params(args, aux)
    mod.forward(mt.io.DataBatch([nd.array(x)], []), is_train=False)
    np.testing.assert_allclose(mod.get_outputs()[0].asnumpy(), want,
                               rtol=1e-5, atol=1e-6)
    # the JAX package reads the same graph
    jsym = mx.sym.load(prefix + "-symbol.json")
    assert jsym.list_arguments() == sym.list_arguments()


# --------------------------------------------------------------------------
# examples/gluon/stochastic_depth.py
# --------------------------------------------------------------------------
def _stochastic_depth(pkg, rng, p_keep=0.8):
    g, ag = pkg.gluon, pkg.autograd

    class StochasticResidual(g.HybridBlock):
        def __init__(self, channels, p_keep, rng, **kwargs):
            super().__init__(**kwargs)
            self.p_keep = p_keep
            self._rng = rng
            with self.name_scope():
                self.conv1 = g.nn.Conv2D(channels, 3, padding=1)
                self.bn1 = g.nn.BatchNorm()
                self.conv2 = g.nn.Conv2D(channels, 3, padding=1)
                self.bn2 = g.nn.BatchNorm()

        def hybrid_forward(self, F, x):
            if ag.is_training() and self._rng.uniform() >= self.p_keep:
                return F.Activation(x, act_type='relu')
            branch = self.bn2(self.conv2(
                F.Activation(self.bn1(self.conv1(x)), act_type='relu')))
            if ag.is_training():
                return F.Activation(x + branch, act_type='relu')
            return F.Activation(x + self.p_keep * branch, act_type='relu')

    net = g.nn.HybridSequential()
    with net.name_scope():
        net.add(g.nn.Conv2D(16, 3, padding=1), g.nn.BatchNorm(),
                g.nn.Activation('relu'),
                StochasticResidual(16, p_keep, rng),
                StochasticResidual(16, p_keep, rng), g.nn.MaxPool2D(2),
                StochasticResidual(16, p_keep, rng),
                g.nn.GlobalAvgPool2D(), g.nn.Dense(10))
    return net


def test_stochastic_depth_example_trains_alike():
    """The example's network (Adam 2e-3, its skip rule from a seeded
    RandomState), two steps on a synthetic 8x8 digit batch of 16.  The
    same seed gives the same skip decisions in both packages.  Every
    convolution feeds a BatchNorm, which cancels its bias: the bias's
    gradient is 0 up to rounding, and Adam (g / sqrt(v)) turns that
    rounding into a step of about +-lr either way, so the conv biases are
    held only to their two steps (|difference| <= 2 x 2 x lr), and the
    running means those biases shift to a tenth of that (momentum 0.9:
    1e-3); every other parameter within 1e-4 relative, 2e-6 absolute.
    The inference forward after the steps normalises with those running
    means, through seven BatchNorms: its logits (of order 0.3) within
    1e-2."""
    rng = np.random.RandomState(0)
    x = rng.rand(16, 1, 8, 8).astype('f')
    y = rng.randint(0, 10, 16).astype('f')
    with _fresh_names():
        jnet = _stochastic_depth(mx, np.random.RandomState(0))
        tnet = _stochastic_depth(mt, np.random.RandomState(0))
    jnet.initialize(mx.initializer.Xavier())
    jnet(mx.nd.array(x))
    tnet.initialize()
    mt.convert.gluon_params_from_numpy(tnet.collect_params(),
                                       _to_numpy(jnet.collect_params()))
    res = []
    for pkg, net in ((mx, jnet), (mt, tnet)):
        tr = pkg.gluon.Trainer(net.collect_params(), 'adam',
                               {'learning_rate': 2e-3})
        L = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
        losses = []
        for _ in range(2):
            with pkg.autograd.record():
                loss = L(net(pkg.nd.array(x)), pkg.nd.array(y))
            loss.backward()
            tr.step(16)
            losses.append(float(loss.mean().asscalar()))
        pred = net(pkg.nd.array(x)).asnumpy()
        res.append((losses, pred, _to_numpy(net.collect_params()),
                    [b._rng.uniform() for b in net._children
                     if hasattr(b, "_rng")]))
    (jl, jpred, jp, jr), (tl, tpred, tp, tr_) = res
    assert jr == tr_          # the same skip decisions were drawn
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    for k in jp:
        if "conv" in k and k.endswith("_bias"):
            assert np.abs(tp[k] - jp[k]).max() <= 4 * 2e-3, k
            continue
        if k.endswith("_running_mean"):
            assert np.abs(tp[k] - jp[k]).max() <= 1e-3, k
            continue
        np.testing.assert_allclose(tp[k], jp[k], rtol=1e-4, atol=2e-6,
                                   err_msg=k)
    np.testing.assert_allclose(tpred, jpred, rtol=0, atol=1e-2)
