"""The dense ops the PyTorch port gained from the families it already had
(ROADMAP C1.b.1), against the JAX package on the same numpy inputs: the
loss heads ``LinearRegressionOutput``, ``MAERegressionOutput``,
``LogisticRegressionOutput`` and ``SVMOutput``, ``softmax_cross_entropy``,
``UpSampling``, ``IdentityAttachKLSparseReg``, the ``_v1`` aliases,
``Crop``, ``_slice_assign`` / ``_crop_assign`` and their ``_scalar``
forms, ``space_to_depth``, ``depth_to_space``, ``diag``, ``shape_array``,
``size_array``, ``cast_storage``, ``_scatter_set_nd``, ``_eye`` and
``_linspace``.

Each op: the forward, and the gradient of every float input for one
seeded cotangent against ``jax.vjp`` of the JAX op (a loss head replaces
the cotangent by its own gradient, in both packages).  The loss heads
also through one SGD step of both ``Module`` s.  Tolerances: the ops
that only move, select or write elements are compared exactly; those
that compute are held to 1e-6 of the largest value (float32 rounding of
a few operations: sigmoid, log-softmax, the KL penalty's divisions)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mx
import mxnet_tpu.ops  # noqa: F401  registers the JAX ops
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg
import torch_threads  # noqa: F401,E402  a worker's share of the cores

RTOL = 1e-6
C1B1 = ("LinearRegressionOutput", "MAERegressionOutput",
        "LogisticRegressionOutput", "SVMOutput", "softmax_cross_entropy",
        "UpSampling", "IdentityAttachKLSparseReg", "BatchNorm_v1",
        "Convolution_v1", "Pooling_v1", "Crop", "_slice_assign",
        "_crop_assign", "_slice_assign_scalar", "_crop_assign_scalar",
        "space_to_depth", "depth_to_space", "diag", "shape_array",
        "size_array", "cast_storage", "_scatter_set_nd", "_eye", "_linspace")


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if rtol == 0:
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=what)
        return
    scale = max(float(np.abs(want.astype(np.float64)).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64)
                       - want.astype(np.float64)).max())
    assert err <= rtol * scale, (what, err, scale)


def _check(name, arrays, attrs=None, rtol=0.0, grad=(0,), seed=0,
           is_train=None):
    """The op's outputs and the gradients of the inputs in ``grad``
    against the JAX op and ``jax.vjp``, for a seeded cotangent."""
    attrs = dict(attrs or {})
    if is_train is not None:
        attrs["is_train"] = is_train
    jins = [jnp.asarray(a) for a in arrays]
    tins = [torch.from_numpy(np.array(a)) for a in arrays]
    for i in grad:
        tins[i].requires_grad_()

    def jf(*g_ins):
        ins = list(jins)
        for i, v in zip(grad, g_ins):
            ins[i] = v
        return jreg.get(name)(*ins, **attrs)
    jout, vjp = jax.vjp(jf, *[jins[i] for i in grad])
    tout = treg.get(name)(*tins, **attrs)
    jl = list(jout) if isinstance(jout, (tuple, list)) else [jout]
    tl = list(tout) if isinstance(tout, (tuple, list)) else [tout]
    assert len(jl) == len(tl)
    for k, (j, t) in enumerate(zip(jl, tl)):
        _close(t.detach().numpy(), np.asarray(j), rtol, f"{name} out{k}")
    if not grad:
        return tl
    rng = np.random.RandomState(seed + 1)
    cots = [rng.uniform(-1, 1, np.shape(j)).astype(np.asarray(j).dtype)
            for j in jl]
    jg = vjp(tuple(jnp.asarray(c) for c in cots)
             if isinstance(jout, (tuple, list)) else jnp.asarray(cots[0]))
    # only the first output carries a gradient in the port's ops (aux
    # updates and shapes are detached)
    torch.autograd.backward([tl[0]], [torch.from_numpy(cots[0])])
    for i, g in zip(grad, jg):
        got = tins[i].grad
        got = np.zeros(arrays[i].shape, arrays[i].dtype) if got is None \
            else got.numpy()
        _close(got, np.asarray(g), rtol, f"{name} grad{i}")
    return tl


def _rand(*shape, seed=0, lo=-1.0, hi=1.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape) \
        .astype(np.float32)


def test_every_c1b1_name_is_registered_with_the_jax_metadata():
    for name in C1B1:
        j, t = jreg.get(name), treg.get(name)
        assert t.arg_names == j.arg_names, name
        assert t.aux_names == j.aux_names, name
        assert t.num_aux == j.num_aux, name
        assert t.takes_is_train == j.takes_is_train, name
        assert t.variadic == j.variadic, name
        assert set(t.attr_defaults) == set(j.attr_defaults), name
    for alias_name, base in (("BatchNorm_v1", "BatchNorm"),
                             ("Convolution_v1", "Convolution"),
                             ("Pooling_v1", "Pooling"),
                             ("_crop_assign", "_slice_assign"),
                             ("_crop_assign_scalar", "_slice_assign_scalar")):
        assert treg.get(alias_name) is treg.get(base)
    # reachable through the NDArray and Symbol namespaces
    for name in C1B1:
        assert hasattr(mt.nd, name) and hasattr(mt.sym, name), name


@pytest.mark.parametrize("name", ["LinearRegressionOutput",
                                  "MAERegressionOutput",
                                  "LogisticRegressionOutput"])
@pytest.mark.parametrize("label_shape", [(4, 3), (12,)],
                         ids=["same", "flat"])
def test_regression_heads(name, label_shape):
    """The forward is the link, the gradient ``(out - label) * grad_scale``
    (MAE: its sign), the label reshaped to the output's shape."""
    x = _rand(4, 3, lo=-2, hi=2)
    y = _rand(*label_shape, seed=1)
    # the logistic head's sigmoid rounds differently in the two packages
    rtol = RTOL if name.startswith("Logistic") else 0.0
    _check(name, [x, y], {"grad_scale": 0.5}, rtol=rtol)


def test_mae_regression_gradient_is_nan_at_a_nan_data_or_label():
    """``jnp.sign`` keeps NaN, so a NaN data or label element gives its
    output a NaN gradient in the JAX package (``torch.sign``'s 0 stopped
    it silently); a tie keeps the sign of zero.  Compared exactly, NaN
    equal to NaN."""
    x = _rand(4, 3, lo=-2, hi=2)
    y = _rand(4, 3, seed=1)
    x[0, 1] = np.nan
    y[2, 2] = np.nan
    y[3, 0] = x[3, 0]
    _check("MAERegressionOutput", [x, y], {"grad_scale": 0.5})
    xt = torch.from_numpy(x.copy()).requires_grad_()
    treg.get("MAERegressionOutput")(xt, torch.from_numpy(y)).sum() \
        .backward()
    nan = np.isnan(xt.grad.numpy())
    assert nan[0, 1] and nan[2, 2] and nan.sum() == 2
    assert xt.grad[3, 0] == 0


@pytest.mark.parametrize("use_linear", [False, True], ids=["l2", "l1"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_svm_output(use_linear, dtype):
    """Identity forward; the one-vs-all hinge gradient in float32, cast to
    the data's dtype.  Labels 7 and -1 lie outside the 5 classes: no true
    class, as ``jax.nn.one_hot`` gives."""
    x = _rand(6, 5, lo=-2, hi=2)
    y = np.array([0, 4, 2, 7, -1, 3], np.float32)
    attrs = {"margin": 1.5, "regularization_coefficient": 0.7,
             "use_linear": use_linear}
    if dtype == "float32":
        _check("SVMOutput", [x, y], attrs)
        return
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    out = treg.get("SVMOutput")(xb, torch.from_numpy(y), **attrs)
    out.backward(torch.ones_like(out))
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda d: jreg.get("SVMOutput")(d, jnp.asarray(y),
                                                     **attrs), jx)
    want = np.asarray(vjp(jnp.ones_like(jx))[0].astype(jnp.float32))
    assert xb.grad.dtype == torch.bfloat16
    _close(xb.grad.float().numpy(), want, 0.0)


def test_softmax_cross_entropy():
    """The summed cross entropy, a 0-d value, and its gradient."""
    x = _rand(4, 5, lo=-3, hi=3)
    y = np.array([0, 4, 2, 1], np.float32)
    out = _check("softmax_cross_entropy", [x, y], rtol=RTOL)
    assert out[0].dim() == 0


@pytest.mark.parametrize("case", ["one", "concat", "sum"])
def test_upsampling_nearest(case):
    a = _rand(2, 3, 4, 5)
    b = _rand(2, 3, 4, 5, seed=1)
    if case == "one":
        _check("UpSampling", [a], {"scale": 2})
    else:
        _check("UpSampling", [a, b], {"scale": 3, "num_args": 2,
                                      "multi_input_mode": case}, grad=(0, 1))


def test_upsampling_bilinear_raises_where_the_jax_package_is_wrong():
    """The JAX package ignores ``sample_type`` and computes nearest for
    bilinear (a reference fault, ROADMAP §3): shown here.  The port
    raises rather than give that answer."""
    a = _rand(1, 2, 3, 3)
    near = np.asarray(jreg.get("UpSampling")(jnp.asarray(a), scale=2))
    bil = np.asarray(jreg.get("UpSampling")(jnp.asarray(a), scale=2,
                                            sample_type="bilinear"))
    np.testing.assert_array_equal(bil, near)
    np.testing.assert_array_equal(bil, a.repeat(2, 2).repeat(2, 3))
    with pytest.raises(mt.MXNetError, match="bilinear.*reference fault"):
        treg.get("UpSampling")(torch.from_numpy(a), scale=2,
                               sample_type="bilinear")


@pytest.mark.parametrize("is_train", [True, False],
                         ids=["train", "inference"])
def test_identity_attach_kl_sparse_reg(is_train):
    """Identity forward; training also returns the new moving average
    (its aux update); the gradient is the cotangent plus the KL penalty
    of the moving average in use."""
    x = _rand(4, 6, lo=0.05, hi=0.95)
    ma = _rand(6, seed=2, lo=0.2, hi=0.8)
    attrs = {"sparseness_target": 0.2, "penalty": 0.01, "momentum": 0.8}
    _check("IdentityAttachKLSparseReg", [x, ma], attrs, rtol=RTOL,
           is_train=is_train)


def test_identity_attach_kl_sparse_reg_updates_its_aux_in_a_module():
    """Through the port's ``Module``: one training forward and backward
    update ``moving_avg`` (one a unit, as the reference infers it) and give
    the input gradient of the JAX op's ``jax.vjp`` on the same
    computation.  The JAX package's own Module cannot bind the op: its
    shape inference gives ``moving_avg`` the data's shape (ROADMAP §3)."""
    B, U = 4, 6
    x = _rand(B, 8, seed=3)
    w = _rand(U, 8, seed=4)
    attrs = {"sparseness_target": 0.1, "penalty": 0.05, "momentum": 0.9}
    ma0 = np.full(U, 0.5, np.float32)

    def net(pkg):
        d = pkg.sym.Variable("data")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            d, num_hidden=U, no_bias=True, name="fc"), act_type="sigmoid")
        return pkg.sym.MakeLoss(pkg.sym.sum(
            pkg.sym.IdentityAttachKLSparseReg(h, name="kl", **attrs)))
    with pytest.raises(mx.base.MXNetError, match="reshape"):
        net(mx).infer_shape(data=(B, 8))
    assert net(mt).infer_shape(data=(B, 8))[2] == [(U,)]
    mod = mt.mod.Module(net(mt), label_names=None, context=mt.cpu())
    mod.bind(data_shapes=[("data", (B, 8))], inputs_need_grad=True)
    mod.init_params(arg_params={"fc_weight": mt.nd.array(w, ctx=mt.cpu())},
                    aux_params={"kl_moving_avg": mt.nd.array(
                        ma0, ctx=mt.cpu())})
    mod.forward(mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())], []),
                is_train=True)
    mod.backward()

    def jf(xx):
        h = jax.nn.sigmoid(xx @ jnp.asarray(w).T)
        out, ma = jreg.get("IdentityAttachKLSparseReg")(
            h, jnp.asarray(ma0), is_train=True, **attrs)
        return jnp.sum(out), ma
    (_, ma), vjp = jax.vjp(jf, jnp.asarray(x))
    gx = vjp((jnp.ones((), jnp.float32), jnp.zeros_like(ma)))[0]
    _close(mod.get_params()[1]["kl_moving_avg"].asnumpy(), np.asarray(ma),
           RTOL)
    _close(mod.get_input_grads()[0].asnumpy(), np.asarray(gx), RTOL)
    assert not np.allclose(np.asarray(ma), 0.5)


@pytest.mark.parametrize("name", ["BatchNorm_v1", "Convolution_v1",
                                  "Pooling_v1"])
def test_v1_aliases(name):
    x = _rand(2, 3, 6, 6)
    if name == "Convolution_v1":
        _check(name, [x, _rand(4, 3, 3, 3, seed=1), _rand(4, seed=2)],
               {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)},
               rtol=RTOL, grad=(0, 1, 2))
    elif name == "Pooling_v1":
        _check(name, [x], {"kernel": (2, 2), "stride": (2, 2),
                           "pool_type": "avg"}, rtol=RTOL)
    else:
        outs = _check(name, [x, _rand(3, seed=1, lo=0.5, hi=1.5),
                             _rand(3, seed=2), np.zeros(3, np.float32),
                             np.ones(3, np.float32)],
                      {"fix_gamma": False}, rtol=1e-5, grad=(0, 1, 2),
                      is_train=False)
        assert len(outs) == 3


@pytest.mark.parametrize("case", ["h_w", "offset", "center", "like"])
def test_crop(case):
    x = _rand(2, 3, 8, 9)
    if case == "like":
        _check("Crop", [x, _rand(2, 3, 5, 6, seed=1)],
               {"num_args": 2, "center_crop": True})
        return
    attrs = {"h_w": (4, 5)}
    if case == "offset":
        attrs["offset"] = (1, 3)
    if case == "center":
        attrs["center_crop"] = True
    _check("Crop", [x], attrs)


SLICES = {"forward": ((1, 1), (3, 4), ()),
          "step": ((0, 4), (4, 0), (2, -2)),
          "partial": ((1,), (3,), ())}


@pytest.mark.parametrize("name", ["_slice_assign", "_crop_assign"])
@pytest.mark.parametrize("case", sorted(SLICES))
def test_slice_assign(name, case):
    begin, end, step = SLICES[case]
    lhs = _rand(4, 5)
    region = np.zeros((4, 5), np.float32)[tuple(
        slice(b, e, s) for b, e, s in zip(begin, end, step or
                                          (None,) * len(begin)))]
    rhs = _rand(*region.shape, seed=1)
    _check(name, [lhs, rhs], {"begin": begin, "end": end, "step": step},
           grad=(0, 1))


@pytest.mark.parametrize("name", ["_slice_assign_scalar",
                                  "_crop_assign_scalar"])
def test_slice_assign_scalar(name):
    _check(name, [_rand(4, 5)], {"scalar": 2.5, "begin": (3, 0),
                                 "end": (0, 5), "step": (-1, 2)})


@pytest.mark.parametrize("name", ["space_to_depth", "depth_to_space"])
def test_space_depth(name):
    x = _rand(2, 8, 4, 6)
    _check(name, [x], {"block_size": 2})
    # each is the other's inverse
    t = torch.from_numpy(x)
    back = treg.get("depth_to_space")(treg.get("space_to_depth")(
        t, block_size=2), block_size=2)
    assert torch.equal(back, t)


@pytest.mark.parametrize("shape,k", [((5,), 1), ((4, 5), -1), ((4, 5), 2),
                                     ((3, 4, 2), 0)])
def test_diag(shape, k):
    _check("diag", [_rand(*shape)], {"k": k})


@pytest.mark.parametrize("name", ["shape_array", "size_array"])
def test_shape_and_size_array(name):
    out = _check(name, [_rand(2, 3, 4)], grad=())
    assert out[0].dtype == torch.int64


def test_cast_storage():
    """The op is the identity on a tensor for every stype, as the JAX
    op is; ``nd.cast_storage`` makes the sparse container (held against
    the JAX package in test_torch_sparse.py); an unknown stype raises."""
    for stype in ("default", "row_sparse", "csr"):
        _check("cast_storage", [_rand(3, 4)], {"stype": stype})
    with pytest.raises(mt.MXNetError, match="stype"):
        treg.get("cast_storage")(torch.zeros(2, 2), stype="coo")


def test_scatter_set_nd_last_write_wins():
    """lhs with rhs written at indices: -1 counts from the end, (1, 2) is
    written twice and the last write wins in the output and the
    gradient; lhs keeps its gradient where nothing is written."""
    lhs = _rand(3, 4)
    rhs = _rand(4, seed=1)
    idx = np.array([[0, 1, 1, -1], [1, 2, 2, 3]], np.float32)
    _check("_scatter_set_nd", [lhs, rhs, idx], {"shape": (3, 4)},
           grad=(0, 1))


@pytest.mark.parametrize("attrs", [{"N": 3, "M": 5, "k": 1},
                                   {"N": 4, "k": -1},
                                   {"N": 3, "dtype": "int32"}])
def test_eye(attrs):
    want = np.asarray(jreg.get("_eye")(**attrs))
    got = treg.get("_eye")(device=torch.device("cpu"), **attrs).numpy()
    _close(got, want, 0.0)
    assert got.dtype == want.dtype


@pytest.mark.parametrize("attrs", [{"start": 0.0, "stop": 1.0, "num": 7},
                                   {"start": -2.0, "stop": 3.0, "num": 6,
                                    "endpoint": False},
                                   {"start": 1.0, "stop": 2.0, "num": 1}])
def test_linspace(attrs):
    """``jnp.linspace``'s arithmetic; XLA's CPU code rounds one element of
    ``start * (1 - t) + stop * t`` one ulp away from torch's (a fused
    multiply-add), hence 1e-6 of the largest value."""
    want = np.asarray(jreg.get("_linspace")(**attrs))
    got = treg.get("_linspace")(device=torch.device("cpu"), **attrs).numpy()
    assert got.dtype == want.dtype
    _close(got, want, RTOL)


def test_creation_ops_through_the_ndarray_and_symbol():
    """``_eye`` and ``_linspace`` take the device the caller or the
    executor gives."""
    with mt.cpu():
        e = mt.nd._eye(N=3, k=1)
    np.testing.assert_array_equal(e.asnumpy(), np.eye(3, k=1))
    s = mt.sym._linspace(start=0.0, stop=1.0, num=5)
    ex = s.simple_bind(mt.cpu())
    ex.forward()
    np.testing.assert_allclose(ex.outputs[0].asnumpy(),
                               np.linspace(0, 1, 5), rtol=0, atol=1e-7)


HEADS = {
    "LinearRegressionOutput": {},
    "MAERegressionOutput": {},
    "LogisticRegressionOutput": {"grad_scale": 2.0},
    "SVMOutput": {"margin": 1.0, "use_linear": False},
    "SVMOutput_linear": {"margin": 1.0, "use_linear": True},
}


@pytest.mark.parametrize("head", sorted(HEADS))
def test_loss_head_module_sgd_step_matches_jax(head):
    """A two-layer net under each loss head through both ``Module`` s:
    one SGD step (lr 0.1, momentum 0.9) from the same parameters gives
    the same new parameters and the same outputs."""
    op = head.split("_")[0]
    B, D, H, C = 8, 6, 7, 4
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, D)).astype(np.float32)
    y = (rng.randint(0, C, B).astype(np.float32) if op == "SVMOutput"
         else rng.uniform(0, 1, (B, C)).astype(np.float32))
    params = {"fc1_weight": rng.randn(H, D).astype(np.float32) * 0.5,
              "fc1_bias": rng.randn(H).astype(np.float32) * 0.1,
              "fc2_weight": rng.randn(C, H).astype(np.float32) * 0.5,
              "fc2_bias": rng.randn(C).astype(np.float32) * 0.1}
    got = {}
    for pkg, ctx in ((mx, mx.cpu()), (mt, mt.cpu())):
        d = pkg.sym.Variable("data")
        h = pkg.sym.Activation(pkg.sym.FullyConnected(
            d, num_hidden=H, name="fc1"), act_type="relu")
        h = pkg.sym.FullyConnected(h, num_hidden=C, name="fc2")
        net = getattr(pkg.sym, op)(h, name="head", **HEADS[head])
        mod = pkg.mod.Module(net, label_names=("head_label",), context=ctx)
        mod.bind(data_shapes=[("data", (B, D))],
                 label_shapes=[("head_label", y.shape)])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=ctx)
                                    for k, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        batch = pkg.io.DataBatch([pkg.nd.array(x, ctx=ctx)],
                                 [pkg.nd.array(y, ctx=ctx)])
        mod.forward(batch, is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward()
        mod.update()
        got[pkg] = (out, {k: v.asnumpy() for k, v in
                          mod.get_params()[0].items()})
    _close(got[mt][0], got[mx][0], RTOL, "outputs")
    for k in params:
        _close(got[mt][1][k] - params[k], got[mx][1][k] - params[k], 1e-5,
               k)
