"""The port's new metrics, initializers, iterators and callbacks
against the JAX package's, on the same numpy inputs (ROADMAP C8).

Tolerances: metrics 1e-6 relative (the port sums on its tensors'
device in float32 and folds the batch sums in float64; the JAX package's
host path sums in numpy, float32 or float64: they differ by roundings,
measured under 1e-7); deterministic initializers and every iterator
batch bit for bit; the random initializers by their moments (their
streams are not the JAX package's), within 5 standard errors."""
import logging

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

RTOL = 1e-6


# -- metrics -----------------------------------------------------------------
def _batches(kind, seed, n=3, batch=16, nclass=5):
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        if kind == "binary":
            pred = rs.rand(batch, 2).astype("f")
            label = rs.randint(0, 2, batch).astype("f")
        elif kind == "prob":
            pred = rs.rand(batch, nclass).astype("f") + 1e-3
            pred /= pred.sum(1, keepdims=True)
            label = rs.randint(0, nclass, batch).astype("f")
        elif kind == "regression":
            label, pred = (rs.randn(batch, 3).astype("f"),
                           rs.randn(batch, 3).astype("f"))
        elif kind == "binary_regression":
            label, pred = (rs.randint(0, 2, batch).astype("f"),
                           rs.rand(batch).astype("f"))
        elif kind == "regression1d":
            label, pred = (rs.randn(batch).astype("f"),
                           rs.randn(batch, 1).astype("f"))
        else:   # a loss-valued output
            label, pred = np.zeros(batch, "f"), rs.rand(batch).astype("f")
        out.append((label, pred))
    return out


METRICS = [
    ("f1", {}, "binary"), ("mae", {}, "regression"),
    ("mse", {}, "regression"), ("rmse", {}, "regression"),
    ("rmse", {}, "regression1d"), ("nll_loss", {}, "prob"),
    ("negativeloglikelihood", {}, "prob"), ("pearsonr", {}, "regression"),
    ("pearsoncorrelation", {}, "binary_regression"), ("torch", {}, "loss"),
    ("caffe", {}, "loss"), ("ce", {}, "prob"),
    ("perplexity", {"ignore_label": 0}, "prob"),
]


@pytest.mark.parametrize("name,kw,kind", METRICS,
                         ids=[f"{m[0]}_{m[2]}" for m in METRICS])
def test_metric_matches_jax(name, kw, kind):
    jm = mx.metric.create(name, **kw)
    tm = mt.metric.create(name, **kw)
    assert type(tm).__name__ == type(jm).__name__
    for label, pred in _batches(kind, seed=len(name)):
        jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
        tm.update([mt.nd.array(label, ctx=mt.cpu())],
                  [mt.nd.array(pred, ctx=mt.cpu())])
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    assert tm.num_inst == jm.num_inst
    np.testing.assert_allclose(tv, jv, rtol=RTOL)


def test_pearson_rejects_mismatched_shapes_in_both():
    for pkg in (mx, mt):
        with pytest.raises(ValueError):
            pkg.metric.PearsonCorrelation().update(
                [pkg.nd.array(np.zeros(4, "f"), ctx=pkg.cpu())],
                [pkg.nd.array(np.zeros((4, 1), "f"), ctx=pkg.cpu())])


def test_jax_metric_cases():
    """The JAX package's own metric cases (tests/test_metric.py)."""
    def arr(x):
        return mt.nd.array(np.array(x, np.float32), ctx=mt.cpu())
    m = mt.metric.create("mse")
    m.update([arr([[0.], [4.]])], [arr([[1.], [2.]])])
    assert m.get()[1] == pytest.approx(2.5)
    m = mt.metric.create("mae")
    m.update([arr([[0.], [4.]])], [arr([[1.], [2.]])])
    assert m.get()[1] == pytest.approx(1.5)
    m = mt.metric.create("rmse")
    m.update([arr([[0.], [4.]])], [arr([[1.], [2.]])])
    assert m.get()[1] == pytest.approx(np.sqrt(2.5))
    m = mt.metric.create("f1")
    m.update([arr([1., 0., 1.])], [arr([[.3, .7], [.8, .2], [.1, .9]])])
    assert m.get()[1] == pytest.approx(1.0)
    m = mt.metric.F1()      # (n, 1) labels do not broadcast
    m.update([arr([[1], [0], [1]])], [arr([[.1, .9], [.8, .2], [.3, .7]])])
    assert m.get()[1] == pytest.approx(1.0)
    m = mt.metric.create(["acc", "mse"])
    m.update([arr([1.])], [arr([[.3, .7]])])
    assert {"accuracy", "mse"} <= set(m.get()[0])
    assert m.get_metric(1).name == "mse"


def test_custom_metric_and_np_match_jax():
    def feval(label, pred):
        return float((label == pred.argmax(1)).mean())

    def pair(label, pred):
        return float(np.abs(label - pred[:, 1]).sum()), label.size

    for make in (lambda pkg: pkg.metric.np(feval),
                 lambda pkg: pkg.metric.create(pair),
                 lambda pkg: pkg.metric.CustomMetric(feval, name="mine")):
        jm, tm = make(mx), make(mt)
        for label, pred in _batches("binary", seed=4):
            jm.update([mx.nd.array(label)], [mx.nd.array(pred)])
            tm.update([mt.nd.array(label, ctx=mt.cpu())],
                      [mt.nd.array(pred, ctx=mt.cpu())])
        assert tm.get()[0] == jm.get()[0]
        np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=RTOL)
        with pytest.raises(NotImplementedError):
            tm.get_config()


@pytest.mark.parametrize("name,label,exc", [
    ("f1", [0., 1., 2., 1.], ValueError),
    ("ce", [0., 1., 7., 1.], IndexError),
    ("perplexity", [0., 1., -9., 1.], IndexError),
], ids=["f1", "ce", "perplexity"])
def test_bad_labels_raise_at_get_and_stay_until_reset(name, label, exc):
    """A batch with an out-of-range label adds nothing and the next
    get() raises, as the JAX package's device path does; the batches
    before it are kept; reset() clears the error."""
    rs = np.random.RandomState(0)
    good = rs.rand(4, 2).astype("f")
    kw = {"ignore_label": None} if name == "perplexity" else {}
    pkgs = {}
    for pkg, ctx in ((mx, None), (mt, mt.cpu())):
        m = pkg.metric.create(name, **kw)
        m.update_device([pkg.nd.array(np.array([0., 1., 1., 0.]), ctx=ctx)],
                        [pkg.nd.array(good, ctx=ctx)]) \
            if pkg is mx else \
            m.update([pkg.nd.array(np.array([0., 1., 1., 0.]), ctx=ctx)],
                     [pkg.nd.array(good, ctx=ctx)])
        bad = [pkg.nd.array(np.array(label), ctx=ctx)]
        if pkg is mx:
            m.update_device(bad, [pkg.nd.array(good)])
        else:
            m.update(bad, [pkg.nd.array(good, ctx=ctx)])
        for _ in range(2):
            with pytest.raises(exc):
                m.get()
        pkgs[pkg.__name__] = (m.sum_metric, m.num_inst)
        m.reset()
        assert np.isnan(m.get()[1])
    np.testing.assert_allclose(pkgs["mxnet_tpu_torch"][0],
                               pkgs["mxnet_tpu"][0], rtol=RTOL)
    assert pkgs["mxnet_tpu_torch"][1] == pkgs["mxnet_tpu"][1]


def test_metric_config_matches_jax():
    for name, kw in (("mae", {}), ("ce", {"eps": 1e-8}),
                     ("perplexity", {"ignore_label": 3})):
        assert mt.metric.create(name, **kw).get_config() == \
            mx.metric.create(name, **kw).get_config()


# -- initializers ------------------------------------------------------------
def _init_one(pkg, initializer, shape, name="weight"):
    ctx = pkg.cpu()
    arr = pkg.nd.zeros(shape, ctx=ctx)
    initializer(pkg.initializer.InitDesc(name), arr)
    return arr.asnumpy()


@pytest.mark.parametrize("shape", [(1, 1, 4, 4), (3, 2, 5, 5),
                                   (2, 1, 3, 6)])
def test_bilinear_equals_jax(shape):
    np.testing.assert_array_equal(
        _init_one(mt, mt.init.Bilinear(), shape),
        _init_one(mx, mx.initializer.Bilinear(), shape))


def test_orthogonal_is_orthogonal():
    mt.random.seed(3)
    w = _init_one(mt, mt.init.Orthogonal(scale=1.0), (32, 32))
    np.testing.assert_allclose(w @ w.T, np.eye(32), atol=1e-5)
    w2 = _init_one(mt, mt.init.Orthogonal(rand_type="normal"), (8, 24))
    np.testing.assert_allclose(w2 @ w2.T, 1.414 ** 2 * np.eye(8),
                               atol=1e-5)
    w3 = _init_one(mt, mt.init.Orthogonal(), (16, 2, 2, 2))
    flat = w3.reshape(16, 8)
    np.testing.assert_allclose(flat.T @ flat, 1.414 ** 2 * np.eye(8),
                               atol=1e-5)


def test_msra_prelu_moments_and_dumps():
    mt.random.seed(2)
    w = _init_one(mt, mt.init.MSRAPrelu(factor_type="in", slope=0.0),
                  (256, 100))
    sigma = np.sqrt(2.0 / 100)
    n = w.size
    assert abs(w.mean()) < 5 * sigma / np.sqrt(n)
    assert abs(w.std() - sigma) < 5 * sigma / np.sqrt(2 * n)
    assert mt.init.MSRAPrelu(slope=0.1).dumps() == \
        mx.initializer.MSRAPrelu(slope=0.1).dumps()


def test_mixed_and_load_equal_jax(tmp_path):
    path = str(tmp_path / "w.params")
    value = np.arange(4, dtype=np.float32).reshape(2, 2)
    mt.nd.save(path, {"arg:fc_weight": mt.nd.array(value, ctx=mt.cpu()),
                      "aux:bn_moving_var": mt.nd.array(np.ones(3, "f"),
                                                       ctx=mt.cpu())})
    for name, shape in (("fc_weight", (2, 2)), ("bn_moving_var", (3,)),
                        ("other_bias", (3,)), ("other_weight", (2, 3))):
        got = _init_one(mt, mt.init.Load(path, default_init=mt.init.One()),
                        shape, name)
        want = _init_one(mx, mx.initializer.Load(
            path, default_init=mx.initializer.One()), shape, name)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(AssertionError, match="Shape mismatch"):
        _init_one(mt, mt.init.Load(path), (5, 5), "fc_weight")
    for pkg in (mx, mt):
        init = pkg.initializer
        mixed = init.Mixed([".*bias", ".*"],
                           [init.Zero(), init.Constant(3.0)])
        assert (_init_one(pkg, mixed, (4,), "fc1_bias") == 0).all()
        assert (_init_one(pkg, mixed, (4, 2), "fc1_weight") == 3).all()
        with pytest.raises(ValueError, match="did not match"):
            _init_one(pkg, init.Mixed(["only"], [init.Zero()]), (2,),
                      "other")


def test_new_initializers_through_module_init_params():
    """A variable's ``init`` attribute with a new initializer and a
    Mixed global one, through Module.init_params, as in the JAX
    package."""
    outs = {}
    for pkg in (mx, mt):
        w = pkg.sym.Variable("up_weight", init=pkg.initializer.Bilinear())
        net = pkg.sym.Deconvolution(pkg.sym.Variable("data"), weight=w,
                                    kernel=(4, 4), stride=(2, 2), pad=(1, 1),
                                    num_filter=2, num_group=2, no_bias=True,
                                    name="up")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc")
        mod = pkg.mod.Module(net, label_names=None, context=pkg.cpu())
        mod.bind(data_shapes=[("data", (1, 2, 3, 3))], for_training=False)
        mod.init_params(pkg.initializer.Mixed(["fc_weight", ".*"],
                                       [pkg.initializer.Constant(0.5),
                                        pkg.initializer.Zero()]))
        arg, _ = mod.get_params()
        outs[pkg.__name__] = {k: v.asnumpy() for k, v in arg.items()}
    for k, v in outs["mxnet_tpu"].items():
        np.testing.assert_array_equal(outs["mxnet_tpu_torch"][k], v)


# -- iterators ---------------------------------------------------------------
def _write_idx(path, arr):
    import struct
    code = {np.uint8: 0x08}[arr.dtype.type]
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, code, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.tobytes())


def _same_batches(jit, tit):
    jb, tb = list(jit), list(tit)
    assert len(jb) == len(tb) > 0
    for a, b in zip(jb, tb):
        assert b.pad == a.pad
        for x, y in zip(a.data, b.data):
            assert getattr(y, "stype", "default") == \
                getattr(x, "stype", "default")
            if getattr(x, "stype", "") == "csr":
                # a CSR batch: its parts exactly, then its dense value
                for part in ("data", "indices", "indptr"):
                    want = getattr(x, part).asnumpy()
                    got = getattr(y, part).asnumpy()
                    np.testing.assert_array_equal(got, want, err_msg=part)
                    assert got.dtype == want.dtype, part
                assert y.shape == x.shape
                x, y = x.todense(), y.todense()
            x = x.asnumpy()
            np.testing.assert_array_equal(y.asnumpy(), x)
            assert y.asnumpy().dtype == x.dtype
        for x, y in zip(a.label or [], b.label or []):
            np.testing.assert_array_equal(y.asnumpy(), x.asnumpy())
    return tb


@pytest.mark.parametrize("round_batch", [True, False])
def test_csv_iter_equals_jax(tmp_path, round_batch):
    data = np.random.RandomState(0).rand(14, 6).astype("f")
    label = np.arange(14).astype("f")
    dp, lp = str(tmp_path / "d.csv"), str(tmp_path / "l.csv")
    np.savetxt(dp, data, delimiter=",")
    np.savetxt(lp, label, delimiter=",")
    kw = dict(data_csv=dp, data_shape=(2, 3), label_csv=lp, batch_size=4,
              round_batch=round_batch)
    tb = _same_batches(mx.io.CSVIter(**kw), mt.io.CSVIter(**kw))
    assert tb[0].data[0].shape == (4, 2, 3)
    np.testing.assert_allclose(tb[0].data[0].asnumpy().reshape(4, 6),
                               data[:4], rtol=1e-6)
    kw.pop("label_csv")
    _same_batches(mx.io.CSVIter(**kw), mt.io.CSVIter(**kw))


@pytest.mark.parametrize("kw", [
    {"shuffle": False}, {"shuffle": True, "seed": 3}, {"flat": True},
    {"shuffle": False, "part_index": 1, "num_parts": 2}],
    ids=["plain", "shuffle", "flat", "part"])
def test_mnist_iter_equals_jax(tmp_path, kw):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (50, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, (50,)).astype(np.uint8)
    ip, lp = str(tmp_path / "i-idx3-ubyte"), str(tmp_path / "l-idx1-ubyte")
    _write_idx(ip, imgs)
    _write_idx(lp, labs)
    args = dict(image=ip, label=lp, batch_size=10, silent=True, **kw)
    tb = _same_batches(mx.io.MNISTIter(**args), mt.io.MNISTIter(**args))
    if kw == {"shuffle": False}:
        np.testing.assert_array_equal(
            np.concatenate([b.data[0].asnumpy() for b in tb]),
            (imgs.astype(np.float32) / 255.0)[:, None])


@pytest.mark.parametrize("round_batch", [True, False])
def test_libsvm_iter_equals_jax(tmp_path, round_batch):
    rng = np.random.RandomState(1)
    n, ncol = 22, 30
    lines = []
    for i in range(n):
        cols = sorted(rng.choice(ncol, rng.randint(1, 6), replace=False))
        toks = ["%d:%s" % (c, round(float(rng.uniform(-2, 2)), 4))
                for c in cols]
        lines.append("%d %s" % (rng.randint(0, 2), " ".join(toks)))
    p = str(tmp_path / "d.libsvm")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    kw = dict(data_libsvm=p, data_shape=(ncol,), batch_size=5,
              round_batch=round_batch)
    _same_batches(mx.io.LibSVMIter(**kw), mt.io.LibSVMIter(**kw))


def test_resize_and_kbatch_equal_jax():
    data = np.arange(40).reshape(10, 4).astype("f")
    label = np.arange(10).astype("f")

    def base(pkg):
        return pkg.io.NDArrayIter(data, label, batch_size=3)
    _same_batches(mx.io.ResizeIter(base(mx), 7), mt.io.ResizeIter(base(mt), 7))
    for last in ("discard", "keep"):
        jk = mx.io.KBatchIter(base(mx), 3, last_group=last)
        tk = mt.io.KBatchIter(base(mt), 3, last_group=last)
        assert [tuple(d.shape) for d in tk.provide_data] == \
            [tuple(d.shape) for d in jk.provide_data]
        _same_batches(jk, tk)


class _Exploding(mt.io.DataIter):
    def __init__(self, inner, after):
        super().__init__(inner.batch_size)
        self.inner, self.after, self.count = inner, after, 0
        self.provide_data = inner.provide_data
        self.provide_label = inner.provide_label

    def reset(self):
        self.inner.reset()

    def next(self):
        if self.count == self.after:
            raise ValueError("injected pipeline crash")
        self.count += 1
        return self.inner.next()


def test_prefetching_iter_equals_jax_and_raises_worker_errors():
    data = np.arange(40).reshape(10, 4).astype("f")
    for kw in ({}, {"device_put": True, "device": mt.cpu()}):
        jit = mx.io.PrefetchingIter(mx.io.NDArrayIter(data, np.zeros(10),
                                                      batch_size=5))
        tit = mt.io.PrefetchingIter(mt.io.NDArrayIter(data, np.zeros(10),
                                                      batch_size=5), **kw)
        _same_batches(jit, tit)
        tit.reset()
        assert len(list(tit)) == 2
        assert len(tit.waits_ms) == 6 and min(tit.waits_ms) >= 0
        tit.close()
    it = mt.io.PrefetchingIter(_Exploding(mt.io.NDArrayIter(
        data, np.zeros(10), batch_size=2), after=2))
    got = [it.next(), it.next()]
    np.testing.assert_array_equal(got[0].data[0].asnumpy(), data[:2])
    for _ in range(2):   # sticky: it never hangs or ends the epoch
        with pytest.raises(mt.MXNetError, match="injected pipeline crash"):
            it.next()


def test_prefetching_iter_device_put_to_the_card_raises_without_cuda():
    """No fallback to the host: without CUDA the default target raises."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.io.PrefetchingIter(mt.io.NDArrayIter(np.zeros((4, 2), "f"),
                                                batch_size=2),
                              device_put=True)


def test_mxdataiter_raises_in_both():
    for pkg in (mx, mt):
        with pytest.raises(pkg.MXNetError if hasattr(pkg, "MXNetError")
                           else Exception):
            pkg.io.MXDataIter()


# -- callbacks ---------------------------------------------------------------
def test_progress_bar_and_validation_log_equal_jax(caplog):
    logs = {}
    for pkg in (mx, mt):
        caplog.clear()
        metric = pkg.metric.create("acc")
        metric.update([pkg.nd.array(np.array([1., 0.]), ctx=pkg.cpu())],
                      [pkg.nd.array(np.array([[.2, .8], [.3, .7]]),
                                    ctx=pkg.cpu())])
        with caplog.at_level(logging.INFO):
            bar = pkg.callback.ProgressBar(total=8, length=20)
            for nbatch in (0, 3, 8):
                bar(pkg.model.BatchEndParam(epoch=1, nbatch=nbatch,
                                            eval_metric=None, locals=None))
            pkg.callback.LogValidationMetricsCallback()(
                pkg.model.BatchEndParam(epoch=2, nbatch=8,
                                        eval_metric=metric, locals=None))
        logs[pkg.__name__] = [r.getMessage() for r in caplog.records]
    assert logs["mxnet_tpu_torch"] == logs["mxnet_tpu"]
    assert "Epoch[2] Validation-accuracy=0.500000" in logs["mxnet_tpu"]
