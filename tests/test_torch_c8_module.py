"""The port's Module front end against the JAX package's (ROADMAP C8
with C2's two module files): fixed parameters, ``reshape`` and
``forward``'s rebind, SequentialModule, PythonLossModule and
BucketingModule's fixed parameters, each from the same numpy
parameters.

Tolerance: 1e-5 absolute and relative after a few SGD steps of a small
MLP in float32 (two libraries' products and softmax, measured about
1e-7); fixed parameters and kept storage exactly."""
import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-5, atol=1e-5)


def _xor(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2).astype("f")
    return X, ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype("f")


def _mlp(pkg, bn=False):
    S = pkg.sym
    net = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    if bn:
        net = S.BatchNorm(net, name="bn1")
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=2, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


def _params(net, batch, seed=1):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = net.infer_shape(data=(batch, 2))
    args = {n: (rng.randn(*s) * 0.5).astype("f")
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: (np.ones(s, "f") if n.endswith("var") else np.zeros(s, "f"))
           for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    return args, aux


def _batch(pkg, x, y):
    ctx = pkg.cpu()
    return pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                            [pkg.nd.array(y, ctx=ctx)])


def _module(pkg, net, batch, args, aux, opt="sgd", opt_params=None, **kw):
    mod = pkg.mod.Module(net, context=pkg.cpu(), **kw)
    mod.bind(data_shapes=[("data", (batch, 2))],
             label_shapes=[("softmax_label", (batch,))])
    conv = (lambda d: {k: mx.nd.array(v) for k, v in d.items()}) \
        if pkg is mx else (lambda d: d)
    mod.init_params(arg_params=conv(args), aux_params=conv(aux))
    mod.init_optimizer(optimizer=opt, optimizer_params=opt_params or {
        "learning_rate": 0.5, "momentum": 0.9})
    return mod


def _np_params(mod):
    arg, aux = mod.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


FIXED = ["fc1_weight", "fc1_bias"]


def test_fixed_params_match_jax_and_stop_the_backward():
    X, Y = _xor(60)
    nets = {pkg: _mlp(pkg, bn=True) for pkg in (mx, mt)}
    args, aux = _params(nets[mt], 20)
    res = {}
    for pkg in (mx, mt):
        mod = _module(pkg, nets[pkg], 20, args, aux,
                      fixed_param_names=FIXED)
        for i in range(3):
            mod.forward(_batch(pkg, X[20 * i:20 * i + 20],
                               Y[20 * i:20 * i + 20]), is_train=True)
            if pkg is mt:   # autograd's leaves are the trainable ones
                leaves = mod._exec._graph[0]
                names = {mod._exec._arg_names[p] for p in leaves}
                assert names == {"fc2_weight", "fc2_bias", "bn1_gamma",
                                 "bn1_beta"}
            mod.backward()
            mod.update()
        res[pkg] = (_np_params(mod), mod)
    (targ, taux), tmod = res[mt]
    (jarg, jaux), _ = res[mx]
    for n in FIXED:
        np.testing.assert_array_equal(targ[n], args[n])
        assert tmod._exec.grad_dict[n] is None
        assert not tmod._exec.arg_dict[n]._data.requires_grad
        assert n not in tmod._updater.states
    for k in jarg:
        np.testing.assert_allclose(targ[k], jarg[k], err_msg=k, **TOL)
    # BatchNorm's moving statistics follow the training forwards, as in
    # the JAX package
    for k in jaux:
        assert not np.array_equal(taux[k], aux[k]), k
        np.testing.assert_allclose(taux[k], jaux[k], err_msg=k, **TOL)


def test_bucketing_module_takes_fixed_params():
    X, Y = _xor(8)

    def sym_gen(key):
        return _mlp(mt), ("data",), ("softmax_label",)
    mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                 context=mt.cpu(),
                                 fixed_param_names=["fc1_weight"])
    mod.bind(data_shapes=[("data", (8, 2))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.5})
    w0 = mod.get_params()[0]["fc1_weight"].asnumpy().copy()
    b0 = mod.get_params()[0]["fc1_bias"].asnumpy().copy()
    batch = _batch(mt, X, Y)
    batch.bucket_key = 8
    batch.provide_data = [mt.io.DataDesc("data", (8, 2))]
    batch.provide_label = [mt.io.DataDesc("softmax_label", (8,))]
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    np.testing.assert_array_equal(mod.get_params()[0]["fc1_weight"]
                                  .asnumpy(), w0)
    assert not np.array_equal(mod.get_params()[0]["fc1_bias"].asnumpy(), b0)


def test_reshape_keeps_storage_and_state_and_matches_jax():
    X, Y = _xor(8, seed=3)
    nets = {pkg: _mlp(pkg, bn=True) for pkg in (mx, mt)}
    args, aux = _params(nets[mt], 8)
    res = {}
    for pkg in (mx, mt):
        mod = _module(pkg, nets[pkg], 8, args, aux)
        mod.forward(_batch(pkg, X, Y), is_train=True)
        mod.update()
        mod.forward(_batch(pkg, X, Y), is_train=False)
        full = mod.get_outputs()[0].asnumpy()
        before = dict(mod.get_params()[0])
        mod.reshape(data_shapes=[("data", (2, 2))],
                    label_shapes=[("softmax_label", (2,))])
        mod.forward(_batch(pkg, X[:2], Y[:2]), is_train=False)
        small = mod.get_outputs()[0].asnumpy()
        np.testing.assert_allclose(small, full[:2], **TOL)
        if pkg is mt:
            after = mod.get_params()[0]
            for k, v in before.items():
                assert after[k] is v
                assert after[k]._data.data_ptr() == v._data.data_ptr()
        mod.forward(_batch(pkg, X[:2], Y[:2]), is_train=True)
        mod.update()
        mod.reshape(data_shapes=[("data", (8, 2))],
                    label_shapes=[("softmax_label", (8,))])
        mod.forward(_batch(pkg, X, Y), is_train=True)
        mod.update()   # the momentum carries across both reshapes
        res[pkg] = (small, _np_params(mod))
    np.testing.assert_allclose(res[mt][0], res[mx][0], **TOL)
    for k, v in res[mx][1][0].items():
        np.testing.assert_allclose(res[mt][1][0][k], v, err_msg=k, **TOL)
    for k, v in res[mx][1][1].items():
        np.testing.assert_allclose(res[mt][1][1][k], v, err_msg=k, **TOL)


def test_reshape_requires_labels_when_bound_with_labels():
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind(data_shapes=[("data", (8, 2))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    with pytest.raises(mt.MXNetError, match="label_shapes"):
        mod.reshape(data_shapes=[("data", (4, 2))])
    assert mod.data_shapes[0].shape == (8, 2)


@pytest.mark.parametrize("how", ["module_reshape", "forward_rebind",
                                 "executor_reshape"])
def test_reshape_that_changes_a_parameter_raises_as_jax(how):
    """An FC weight behind a flatten fixes the image size: a new image
    size must raise in both packages and leave the trained weight, the
    bound shapes and the old batch's forward as they were.  Only
    ``Executor.reshape(partial_shaping=True)`` allocates new arrays."""
    x = np.random.RandomState(0).randn(2, 1, 4, 4).astype("f")
    for pkg in (mx, mt):
        S = pkg.sym
        net = S.SoftmaxOutput(S.FullyConnected(
            S.Flatten(S.Variable("data")), num_hidden=3, name="fc"),
            name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (2, 1, 4, 4))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(pkg.initializer.Constant(0.01))
        weight = mod.get_params()[0]["fc_weight"].asnumpy()
        with pytest.raises(pkg.base.MXNetError):
            if how == "module_reshape":
                mod.reshape(data_shapes=[("data", (2, 1, 5, 5))],
                            label_shapes=[("softmax_label", (2,))])
            elif how == "forward_rebind":
                mod.forward(_batch(pkg, np.zeros((2, 1, 5, 5), "f"),
                                   np.zeros(2, "f")), is_train=False)
            else:
                mod._exec.reshape(data=(2, 1, 5, 5), softmax_label=(2,))
        np.testing.assert_array_equal(
            mod.get_params()[0]["fc_weight"].asnumpy(), weight)
        mod.forward(_batch(pkg, x, np.zeros(2, "f")), is_train=False)
        assert np.isfinite(mod.get_outputs()[0].asnumpy()).all()
        if pkg is mt:
            # the JAX Module records the new shapes before it fails
            assert mod.data_shapes[0].shape == (2, 1, 4, 4)
            ex = mod._exec.reshape(partial_shaping=True, data=(2, 1, 5, 5),
                                   softmax_label=(2,))
            assert tuple(ex.arg_dict["fc_weight"].shape) == (3, 25)
            assert not ex.arg_dict["fc_weight"].asnumpy().any()
            assert ex.arg_dict["fc_bias"] is mod._exec.arg_dict["fc_bias"]


def test_forward_rebinds_to_new_shapes_as_jax():
    outs = {}
    for pkg in (mx, mt):
        S = pkg.sym
        net = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"),
                                               num_hidden=3, name="fc"),
                              name="softmax")
        mod = pkg.mod.Module(net, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (4, 6))],
                 label_shapes=[("softmax_label", (4,))])
        pkg.random.seed(0)
        mod.init_params(pkg.initializer.Constant(0.01))
        rng = np.random.RandomState(0)
        got = []
        for batch in (4, 2, 7, 4):
            x = rng.randn(batch, 6).astype("f")
            mod.forward(_batch(pkg, x, np.zeros(batch, "f")),
                        is_train=False)
            got.append(mod.get_outputs()[0].asnumpy())
        outs[pkg] = got
    for a, b in zip(outs[mt], outs[mx]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


def _seq(pkg, args, aux, loss=None):
    S = pkg.sym
    n1 = S.Activation(S.FullyConnected(S.Variable("data"), num_hidden=16,
                                       name="fc1"), act_type="relu")
    n2 = S.FullyConnected(S.Variable("data"), num_hidden=2, name="fc2")
    seq = pkg.mod.SequentialModule()
    seq.add(pkg.mod.Module(n1, label_names=None, context=pkg.cpu()))
    if loss is None:
        seq.add(pkg.mod.Module(S.SoftmaxOutput(n2, name="softmax"),
                               context=pkg.cpu()), take_labels=True)
    else:
        seq.add(pkg.mod.Module(n2, label_names=None, context=pkg.cpu()))
        seq.add(pkg.mod.PythonLossModule(grad_func=loss), take_labels=True)
    seq.bind(data_shapes=[("data", (20, 2))],
             label_shapes=[("softmax_label", (20,))])
    conv = (lambda d: {k: mx.nd.array(v) for k, v in d.items()}) \
        if pkg is mx else (lambda d: d)
    seq.init_params(arg_params=conv(args), aux_params=conv(aux))
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.5,
                                         "momentum": 0.9})
    return seq


def _ce_grad(scores, labels):
    s = scores.asnumpy()
    e = np.exp(s - s.max(axis=1, keepdims=True))
    p = e / e.sum(axis=1, keepdims=True)
    onehot = np.eye(2, dtype="f")[labels.asnumpy().astype(int)]
    return (p - onehot) / len(s)


@pytest.mark.parametrize("loss", [None, _ce_grad], ids=["module", "pyloss"])
def test_sequential_module_matches_jax_and_the_single_module(loss):
    """Two chained Modules (or two Modules and a PythonLossModule) take
    the same steps as the JAX package's chain; the chain of Modules also
    takes the steps of one Module over the whole graph."""
    X, Y = _xor(60, seed=2)
    args, aux = _params(_mlp(mt), 20)
    res = {}
    for pkg in (mx, mt):
        seq = _seq(pkg, args, aux, loss)
        for i in range(3):
            seq.forward(_batch(pkg, X[20 * i:20 * i + 20],
                               Y[20 * i:20 * i + 20]), is_train=True)
            seq.backward()
            seq.update()
        res[pkg] = _np_params(seq)[0]
        assert seq.get_outputs()[0].shape == (20, 2)
    single = _module(mt, _mlp(mt), 20, args, aux)
    for i in range(3):
        single.forward(_batch(mt, X[20 * i:20 * i + 20],
                              Y[20 * i:20 * i + 20]), is_train=True)
        single.update()
    one = _np_params(single)[0]
    for k, v in res[mx].items():
        np.testing.assert_allclose(res[mt][k], v, err_msg=k, **TOL)
        if loss is None:
            np.testing.assert_allclose(res[mt][k], one[k], err_msg=k, **TOL)
        assert not np.array_equal(v, args[k])


def test_sequential_module_rejects_duplicate_params():
    S = mt.sym
    n1 = S.FullyConnected(S.Variable("data"), num_hidden=4, name="fc1")
    n2 = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"), num_hidden=4,
                                          name="fc1"), name="softmax")
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(n1, label_names=None, context=mt.cpu()))
    seq.add(mt.mod.Module(n2, context=mt.cpu()), take_labels=True)
    seq.bind(data_shapes=[("data", (2, 4))],
             label_shapes=[("softmax_label", (2,))])
    with pytest.raises(mt.MXNetError, match="duplicate"):
        seq.init_params(mt.initializer.Xavier())


def test_refused_features_name_their_items():
    net = _mlp(mt)
    with pytest.raises(mt.MXNetError, match="D1"):
        mt.mod.Module(net, context=mt.cpu(), zero_stage=1)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=[("data", (2, 2))],
             label_shapes=[("softmax_label", (2,))])
    # the Monitor came with C6: it installs on the module's executor
    mon = mt.monitor.Monitor(1)
    mod.install_monitor(mon)
    assert mon.exes == [mod._exec]


def test_dcasgd_without_momentum_saves_and_loads_its_states(tmp_path):
    """A state slot that is None (DCASGD without momentum) survives a
    state file."""
    X, Y = _xor(8)
    args, aux = _params(_mlp(mt), 8)
    mod = _module(mt, _mlp(mt), 8, args, aux, opt="dcasgd",
                  opt_params={"learning_rate": 0.1})
    mod.forward(_batch(mt, X, Y), is_train=True)
    mod.update()
    f = str(tmp_path / "d.states")
    mod.save_optimizer_states(f)
    mod2 = _module(mt, _mlp(mt), 8, args, aux, opt="dcasgd",
                   opt_params={"learning_rate": 0.1})
    mod2.load_optimizer_states(f)
    for n, st in mod._updater.states.items():
        assert st[0] is None and mod2._updater.states[n][0] is None
        np.testing.assert_array_equal(mod2._updater.states[n][1].asnumpy(),
                                      st[1].asnumpy())
