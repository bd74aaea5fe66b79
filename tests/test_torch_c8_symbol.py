"""The port's symbol front end against the JAX package's (ROADMAP C8):
the reference's pre-nnvm (v0.8) graph file, AttrScope, ``infer_type``,
the bidirectional shape pass and graph introspection.

Shapes, names, attributes and dtypes are compared exactly; the legacy
file's forward to 1e-5 (the same float32 products and softmax in two
libraries, measured about 1e-7)."""
import os
import pickle

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

LEGACY = os.path.join(os.path.dirname(__file__), "golden",
                      "reference_save_000800.json")


def test_legacy_v08_file_loads_binds_and_runs_as_in_jax():
    js, ts = mx.sym.load(LEGACY), mt.sym.load(LEGACY)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states() == \
        ["batchnorm0_moving_mean", "batchnorm0_moving_var"]
    assert ts.list_outputs() == js.list_outputs()
    assert ts.attr_dict() == js.attr_dict()
    assert ts.attr_dict()["data"]["lr_mult"] == "0.2"
    assert ts.attr_dict()["data"]["ctx_group"] == "stage1"
    rng = np.random.RandomState(0)
    jmod = mx.mod.Module(js, label_names=("softmax_label",),
                         context=mx.cpu())
    jmod.bind(data_shapes=[("data", (2, 10))],
              label_shapes=[("softmax_label", (2,))])
    jmod.init_params(mx.initializer.Xavier())
    args, aux = jmod.get_params()
    args = {k: v.asnumpy() for k, v in args.items()}
    aux = {k: v.asnumpy() + 0.5 for k, v in aux.items()}
    jmod.set_params({k: mx.nd.array(v) for k, v in args.items()},
                    {k: mx.nd.array(v) for k, v in aux.items()})
    tmod = mt.mod.Module(ts, label_names=("softmax_label",),
                         context=mt.cpu())
    tmod.bind(data_shapes=[("data", (2, 10))],
              label_shapes=[("softmax_label", (2,))])
    tmod.init_params(arg_params=args, aux_params=aux)
    x = rng.rand(2, 10).astype("f")
    jmod.forward(mx.io.DataBatch([mx.nd.array(x)], [mx.nd.zeros((2,))]),
                 is_train=False)
    tmod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                 [mt.nd.zeros((2,), ctx=mt.cpu())]),
                 is_train=False)
    got, want = tmod.get_outputs()[0].asnumpy(), \
        jmod.get_outputs()[0].asnumpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_legacy_attr_lr_mult_reaches_the_optimizer():
    """The v0.8 file's user attributes are the symbol's: ``__lr_mult__``
    set through them reaches ``Optimizer.set_lr_mult`` as in the JAX
    package."""
    ts = mt.sym.load(LEGACY)
    ts.get_internals()["fc2_weight"]._set_attr(__lr_mult__="0.01")
    opt = mt.optimizer.create("sgd", sym=ts)
    assert opt.lr_mult == {"fc2_weight": 0.01}


def test_load_json_round_trips_and_parses_typed_attrs():
    for pkg in (mx, mt):
        net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=4,
                                     no_bias=True, name="fc1")
        net = pkg.sym.LeakyReLU(net, act_type="leaky", name="lrelu")
        back = pkg.sym.load_json(net.tojson())
        assert back.list_arguments() == net.list_arguments()
        assert "fc1_bias" not in back.list_arguments()
    from mxnet_tpu_torch.symbol.symbol import _parse_attr
    assert _parse_attr("relu", "relu") == "relu"
    assert _parse_attr("1", "relu") == "1"          # a string attribute
    assert _parse_attr("1", False) is True           # a flag
    assert _parse_attr("3", ()) == (3,)              # a tuple of one
    assert _parse_attr("(3, 3)", ()) == (3, 3)
    assert _parse_attr("None", "x") is None


# -- AttrScope ---------------------------------------------------------------
def test_attr_cases_match_jax():
    """The JAX package's tests/test_attr.py, in both packages."""
    for pkg in (mx, mt):
        with pkg.AttrScope(group="4", data="great"):
            data = pkg.sym.Variable("data",
                                    attr={"dtype": "data", "group": "1"})
            gdata = pkg.sym.Variable("data2")
        assert gdata.attr("group") == "4"
        assert data.attr("group") == "1"
        with pkg.AttrScope(__group__="4", __data__="great"):
            fc1 = pkg.sym.Activation(data, act_type="relu")
            with pkg.AttrScope(__init_bias__="0.0"):
                fc2 = pkg.sym.FullyConnected(fc1, num_hidden=10,
                                             name="fc2")
        assert fc1.attr("__data__") == "great"
        assert fc2.attr("__init_bias__") == "0.0"
        assert fc2.get_internals()["fc2_weight"].attr("__data__") == \
            "great"
        with pkg.AttrScope(a="1"):
            with pkg.AttrScope(b="2"):
                v = pkg.sym.Variable("v")
            w = pkg.sym.Variable("w")
        u = pkg.sym.Variable("u")
        assert v.attr("a") == "1" and v.attr("b") == "2"
        assert w.attr("a") == "1" and w.attr("b") is None
        assert u.attr("a") is None
        d = {"__lr_mult__": "2"}
        bn = pkg.sym.BatchNorm(pkg.sym.Variable("x"), name="bn", attr=d)
        assert d == {"__lr_mult__": "2"}
        assert bn.attr("__is_aux__") is None
        assert set(bn.list_auxiliary_states()) == {"bn_moving_mean",
                                                   "bn_moving_var"}
        op = pkg.sym.Convolution(data=pkg.sym.Variable("d", attr={
            "mood": "angry"}), name="conv", kernel=(1, 1), num_filter=1,
            attr={"__mood__": "so so"})
        assert op.list_attr()["__mood__"] == "so so"
        assert op.attr_dict()["d"]["mood"] == "angry"
    with pytest.raises(ValueError):
        mt.AttrScope(lr_mult=0.1)


def _scoped_net(pkg):
    data = pkg.sym.Variable("data")
    with pkg.AttrScope(__lr_mult__="0.1", __wd_mult__="0.0"):
        net = pkg.sym.FullyConnected(data, num_hidden=8, name="trunk")
    net = pkg.sym.Activation(net, act_type="relu")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="head")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


def test_attr_scope_lr_mult_reaches_the_optimizer_as_in_jax():
    outs = {}
    for pkg in (mx, mt):
        net = _scoped_net(pkg)
        names = [n for n in net.list_arguments()
                 if n not in ("data", "softmax_label")]
        opt = pkg.optimizer.create("sgd", sym=net, learning_rate=0.5,
                                   wd=0.1,
                                   param_idx2name={n: n for n in names})
        outs[pkg.__name__] = ({n: opt._get_lr(n) for n in names},
                              {n: opt._get_wd(n) for n in names})
    assert outs["mxnet_tpu_torch"] == outs["mxnet_tpu"]
    lrs, wds = outs["mxnet_tpu_torch"]
    assert lrs["trunk_weight"] == pytest.approx(0.05)
    assert lrs["head_weight"] == pytest.approx(0.5)
    assert wds["trunk_weight"] == 0.0 and wds["head_weight"] == 0.1


def test_symbol_pickles_with_its_attributes():
    """Double-underscore attributes survive a JSON round trip (a plain
    name such as ``group`` is read back as an op attribute by both
    packages' loaders)."""
    with mt.AttrScope(__group__="7"):
        net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=3,
                                    name="fc")
    back = mt.sym.load_json(net.tojson())
    assert back.attr("__group__") == "7"
    assert back.get_internals()["fc_weight"].attr("__group__") == "7"
    assert pickle.loads(pickle.dumps(net.tojson())) == net.tojson()


# -- introspection -----------------------------------------------------------
def test_internals_children_and_inputs_match_jax():
    outs = {}
    for pkg in (mx, mt):
        data = pkg.sym.Variable("data")
        fc1 = pkg.sym.FullyConnected(data, name="fc1", num_hidden=10)
        bn = pkg.sym.BatchNorm(fc1, name="bn")
        net = pkg.sym.FullyConnected(bn, name="fc2", num_hidden=100)
        sliced = pkg.sym.SliceChannel(data, num_outputs=3, name="slice")
        concat = pkg.sym.Concat(*list(sliced))
        internals = net.get_internals()
        outs[pkg.__name__] = (
            internals.list_outputs(),
            internals["fc1_output"].list_arguments(),
            net.get_children().list_outputs(),
            net.get_children().get_children().list_outputs(),
            net.get_children()["fc2_weight"].get_children() is None,
            concat.get_children().list_outputs(),
            net.list_inputs())
    assert outs["mxnet_tpu_torch"] == outs["mxnet_tpu"]


# -- shape and type inference ------------------------------------------------
def _graphs(pkg):
    """The JAX package's tests/test_infer_shape.py graphs: (symbol,
    kwargs of infer_shape)."""
    S = pkg.sym
    out = []
    w = S.Variable("weight")
    wt = S._identity_with_attr_like_rhs(
        S.broadcast_add(w, S.Variable("wshift", shape=(1,))), w)
    out.append((S.FullyConnected(data=S.Variable("data"), weight=wt,
                                 num_hidden=11, no_bias=True),
                {"data": (7, 100)}))
    out.append((S.Variable("a", shape=(0, 10))
                + S.Variable("b", shape=(12, 0)), {}))
    out.append((S.FullyConnected(data=S.Variable("a", shape=(0, 10)),
                                 num_hidden=21)
                + S.Variable("c", shape=(5, 0)), {}))
    b = S.SliceChannel(data=S.Variable("a", shape=(0, 10)), num_outputs=10,
                       axis=1, squeeze_axis=True)
    out.append((b[1] + S.Variable("c", shape=(5,)), {}))
    b = S.SliceChannel(data=S.Variable("a", shape=(0, 15, 0)),
                       num_outputs=3, squeeze_axis=False)
    out.append((b[1] + S.Variable("c", shape=(3, 5, 2)), {}))
    conv = S.Convolution(data=S.Variable("a", shape=(0, 10, 0, 0)),
                         num_filter=21, kernel=(3, 3), dilate=(1, 1),
                         pad=(1, 1))
    out.append((conv + S.Variable("c", shape=(5, 21, 32, 32)), {}))
    c = S.Concat(S.Variable("a", shape=(0, 10)),
                 S.Variable("b", shape=(0, 5)), num_args=2, dim=1)
    out.append((S.Variable("d", shape=(2, 0)) + c, {}))
    fc = S.FullyConnected(S.Variable("data"), num_hidden=4, flatten=False)
    out.append((S.elemwise_add(fc, S.Variable("c", shape=(2, 3, 4))),
                {"data": (2, 3, 5)}))
    out.append((S.Concat(S.Variable("a"), S.Variable("b"), num_args=2,
                         dim=-1), {"a": (2, 10), "b": (2, 5)}))
    s = S.SliceChannel(S.Variable("x"), num_outputs=2, axis=-1,
                       squeeze_axis=True)
    out.append((s[0] + S.Variable("y", shape=(3, 5)), {"x": (3, 5, 2)}))
    mlp = S.FullyConnected(S.Activation(S.FullyConnected(
        S.Variable("data"), name="fc1", num_hidden=1000), act_type="relu"),
        name="fc2", num_hidden=10)
    out.append((mlp, {"data": (100, 100)}))
    return out


@pytest.mark.parametrize("i", range(11))
def test_bidirectional_shape_inference_matches_jax(i):
    js, jkw = _graphs(mx)[i]
    ts, tkw = _graphs(mt)[i]
    assert ts.infer_shape(**tkw) == js.infer_shape(**jkw)
    assert ts.list_arguments() == js.list_arguments()


@pytest.mark.parametrize("case", ["mlp_weight", "concat"])
def test_inconsistent_shapes_raise_in_both(case):
    for pkg in (mx, mt):
        S = pkg.sym
        if case == "mlp_weight":
            net = S.FullyConnected(S.Variable("data"), name="fc1",
                                   num_hidden=1000)
            kw = {"data": (100, 100), "fc1_weight": (1, 100)}
        else:
            net = S.Concat(S.Variable("a", shape=(2, 7)), S.Variable("b"),
                           num_args=2, dim=1) \
                + S.Variable("e", shape=(2, 5))
            kw = {}
        with pytest.raises(pkg.base.MXNetError):
            net.infer_shape(**kw)


def test_partial_graph_binds_and_runs():
    a = mt.sym.Variable("a", shape=(0, 6))
    d = mt.sym.FullyConnected(data=a, num_hidden=4) \
        + mt.sym.Variable("c", shape=(3, 0))
    assert d.infer_shape()[1] == [(3, 4)]
    ex = mt.executor.Executor.simple_bind(d, mt.cpu(),
                                          shapes={"a": (3, 6), "c": (3, 4)})
    assert ex.forward()[0].shape == (3, 4)


def _typed(pkg):
    S = pkg.sym
    fc16 = S.FullyConnected(S.Variable("data", dtype="float16"),
                            name="fc1", num_hidden=10)
    emb = S.FullyConnected(S.Embedding(S.Variable("idx", dtype="int32"),
                                       input_dim=10, output_dim=4,
                                       name="emb"), num_hidden=3, name="fc")
    plain = S.SoftmaxOutput(S.FullyConnected(S.Variable("data"),
                                             num_hidden=3, name="fc"),
                            name="softmax")
    bn = S.BatchNorm(S.Variable("data"), name="bn")
    return [(fc16, {}), (emb, {}), (plain, {}), (plain, {"data": "float16"}),
            (bn, {"data": "float64"})]


@pytest.mark.parametrize("i", range(5))
def test_infer_type_matches_jax(i):
    js, jkw = _typed(mx)[i]
    ts, tkw = _typed(mt)[i]
    jt, tt = js.infer_type(**jkw), ts.infer_type(**tkw)
    for a, b in zip(tt, jt):
        assert [np.dtype(x) for x in a] == [np.dtype(x) for x in b]


def test_shape_inference_runs_ops_in_float32_whatever_the_dtypes():
    """Shapes are inferred with every variable in float32: a net cast to
    bf16 (its weights' ``__dtype__``) fed float32 symbols still resolves
    its deferred shapes, imperatively, as it did before ``infer_type``
    typed the meta tensors."""
    with mt.cpu():
        net = mt.gluon.nn.HybridSequential()
        with net.name_scope():
            net.add(mt.gluon.nn.Conv2D(4, 3), mt.gluon.nn.BatchNorm(),
                    mt.gluon.nn.Dense(3))
        net.initialize(mt.initializer.Xavier())
        net.cast("bfloat16")
        x = mt.nd.array(np.random.RandomState(0).rand(2, 3, 8, 8),
                        dtype="bfloat16")
        out = net(x)
    assert out.shape == (2, 3) and out.dtype == "bfloat16"
    w = mt.sym.Variable("w", dtype="bfloat16")
    fc = mt.sym.FullyConnected(mt.sym.Variable("data"), weight=w,
                               num_hidden=3, no_bias=True)
    assert fc.infer_shape(data=(2, 5))[0] == [(2, 5), (3, 5)]
