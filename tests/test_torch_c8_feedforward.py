"""The port's legacy ``FeedForward`` estimator against the JAX
package's (ROADMAP C8): ``fit`` on numpy from the same parameters and
the same shuffle (numpy's global generator), ``predict`` (with the pad
path and ``return_data``), ``score``, ``save`` / ``load`` and
``create``.

Tolerance: 1e-4 absolute on probabilities after 30 SGD steps of a small
MLP in float32 (measured about 1e-6; the steps amplify the two
libraries' roundings), and the packages' own accuracy bar (0.9 on XOR
after 25 epochs)."""
import warnings

import numpy as np
import pytest

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores


def _xor(n=400, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 2).astype("f")
    return X, ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype("f")


def _mlp(pkg):
    S = pkg.sym
    net = S.FullyConnected(S.Variable("data"), num_hidden=16, name="fc1")
    net = S.Activation(net, act_type="relu")
    net = S.FullyConnected(net, num_hidden=2, name="fc2")
    return S.SoftmaxOutput(net, name="softmax")


def _params(seed=1):
    rng = np.random.RandomState(seed)
    return {"fc1_weight": (rng.randn(16, 2) * .5).astype("f"),
            "fc1_bias": np.zeros(16, "f"),
            "fc2_weight": (rng.randn(2, 16) * .5).astype("f"),
            "fc2_bias": np.zeros(2, "f")}


def _model(pkg, num_epoch, **kw):
    arg = {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in _params().items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return pkg.model.FeedForward(_mlp(pkg), ctx=pkg.cpu(),
                                     num_epoch=num_epoch,
                                     numpy_batch_size=40, optimizer="sgd",
                                     learning_rate=0.5, arg_params=arg, **kw)


def test_fit_predict_score_match_jax():
    X, Y = _xor()
    probs = {}
    for pkg in (mx, mt):
        np.random.seed(7)
        model = _model(pkg, 3).fit(X, Y)
        probs[pkg] = model.predict(X)
        assert isinstance(probs[pkg], np.ndarray)
        assert probs[pkg].shape == (400, 2)
    np.testing.assert_allclose(probs[mt], probs[mx], atol=1e-4)


def test_fit_reaches_the_jax_accuracy_and_scores_like_it():
    X, Y = _xor()
    np.random.seed(0)
    with pytest.warns(DeprecationWarning):
        model = mt.model.FeedForward.create(
            _mlp(mt), X, Y, ctx=mt.cpu(), num_epoch=25, optimizer="sgd",
            learning_rate=0.5, initializer=mt.initializer.Xavier())
    acc = model.score(mt.io.NDArrayIter(X, Y, batch_size=40), "acc")
    assert acc > 0.9, acc
    jmodel = _model(mx, 1)
    jmodel.arg_params = {k: mx.nd.array(v.asnumpy())
                         for k, v in model.arg_params.items()}
    jacc = jmodel.score(mx.io.NDArrayIter(X, Y, batch_size=40), "acc")
    assert acc == pytest.approx(jacc)


def test_predict_pads_and_returns_data_as_jax():
    X = np.random.RandomState(3).randn(50, 2).astype("f")
    res = {}
    for pkg in (mx, mt):
        model = _model(pkg, 1)
        res[pkg] = model.predict(X, return_data=True)
    for a, b in zip(res[mt], res[mx]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-6)
    assert res[mt][0].shape[0] == 50 and (res[mt][2] == 0).all()


def test_save_load_round_trip_across_packages(tmp_path):
    X, Y = _xor(80)
    np.random.seed(1)
    model = _model(mt, 2).fit(X, Y)
    prefix = str(tmp_path / "ff")
    model.save(prefix, 2)
    for pkg in (mx, mt):
        with pytest.warns(DeprecationWarning):
            loaded = pkg.model.FeedForward.load(prefix, 2, ctx=pkg.cpu())
        np.testing.assert_allclose(loaded.predict(X), model.predict(X),
                                   rtol=1e-5, atol=1e-6)


def test_fit_needs_labels_and_takes_unconventional_label_names():
    X, _ = _xor(40)
    with pytest.warns(DeprecationWarning):
        model = mt.model.FeedForward(_mlp(mt), num_epoch=1, ctx=mt.cpu())
    with pytest.raises(ValueError):
        model.fit(X)
    rng = np.random.RandomState(0)
    u = rng.randint(0, 10, 200).astype(np.float32)
    r = (u > 4).astype(np.float32)
    S = mt.sym
    pred = S.Flatten(S.sum(S.Embedding(S.Variable("user"), input_dim=10,
                                       output_dim=4, name="emb"), axis=1))
    net = S.LinearRegressionOutput(data=pred, label=S.Variable("score"),
                                   name="lro")
    with pytest.warns(DeprecationWarning):
        model = mt.model.FeedForward(net, ctx=mt.cpu(), num_epoch=4,
                                     optimizer="adam", learning_rate=0.1)
    model.fit(mt.io.NDArrayIter({"user": u}, {"score": r}, batch_size=50))
    out = model.predict(mt.io.NDArrayIter({"user": u}, batch_size=50))
    assert out.shape[0] == 200
