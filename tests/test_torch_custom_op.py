"""``operator.CustomOp`` / ``CustomOpProp`` and the ``Custom`` op of the
PyTorch port against the JAX package: the ``examples/numpy_ops/
custom_softmax.py`` network (a numpy softmax loss head with a
hand-written backward) trained through both packages' ``Module`` from
the same weights, the op imperatively under ``autograd.record()``, an
op with an auxiliary state (no gradient for it) and several outputs.

Tolerances: the parameters after 3 SGD-momentum steps within 1e-5
(the same numpy head in both; the dense layers' float32 products summed
in other orders; measured 1.5e-7); the imperative gradient within 1e-6.
The digits of sklearn are replaced by seeded stand-ins, 10 templates of
64 values plus noise (the card machine has no sklearn)."""
import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
import torch_threads  # noqa: F401,E402  a worker's share of the cores

CPU = mt.cpu()


def _register(pkg):
    """The example's op, registered in ``pkg`` as ``numpy_softmax``."""

    class NumpySoftmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            y = np.exp(x - x.max(axis=1, keepdims=True))
            y /= y.sum(axis=1, keepdims=True)
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = in_data[1].asnumpy().ravel().astype(int)
            y = out_data[0].asnumpy().copy()
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)

    @pkg.operator.register("numpy_softmax")
    class NumpySoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ['data', 'label']

        def list_outputs(self):
            return ['output']

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


for _pkg in (mx, mt):
    _register(_pkg)


def _net(pkg):
    data = pkg.sym.Variable('data')
    label = pkg.sym.Variable('softmax_label')
    h = pkg.sym.FullyConnected(data, num_hidden=16, name='fc1')
    h = pkg.sym.Activation(h, act_type='relu')
    h = pkg.sym.FullyConnected(h, num_hidden=10, name='fc2')
    return pkg.sym.Custom(h, label, op_type='numpy_softmax', name='softmax')


def _digits(seed, n):
    rng = np.random.default_rng(seed)
    tiles = rng.uniform(0, 1, (10, 64))
    y = rng.integers(0, 10, n)
    x = np.clip(tiles[y] + 0.25 * rng.standard_normal((n, 64)), 0, 1)
    return x.astype(np.float32), y.astype(np.float32)


def test_custom_softmax_example_trains_alike_in_both_packages():
    x, y = _digits(0, 60)
    rng = np.random.RandomState(1)
    params = {"fc1_weight": rng.randn(16, 64).astype(np.float32) * 0.1,
              "fc1_bias": np.zeros(16, np.float32),
              "fc2_weight": rng.randn(10, 16).astype(np.float32) * 0.1,
              "fc2_bias": np.zeros(10, np.float32)}
    res = {}
    for pkg in (mx, mt):
        ctx = pkg.cpu()
        mod = pkg.mod.Module(_net(pkg), context=ctx)
        mod.bind(data_shapes=[("data", (20, 64))],
                 label_shapes=[("softmax_label", (20,))])
        mod.init_params(arg_params={n: pkg.nd.array(v, ctx=ctx)
                                    for n, v in params.items()})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        probs = []
        for step in range(3):
            sl = slice(20 * step, 20 * step + 20)
            mod.forward(pkg.io.DataBatch([pkg.nd.array(x[sl], ctx=ctx)],
                                         [pkg.nd.array(y[sl], ctx=ctx)]),
                        is_train=True)
            probs.append(mod.get_outputs()[0].asnumpy())
            mod.backward()
            mod.update()
        res[pkg] = (probs, {n: a.asnumpy()
                            for n, a in mod.get_params()[0].items()})
    for a, b in zip(res[mt][0], res[mx][0]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    for n in params:
        assert not np.array_equal(res[mt][1][n], params[n])
        np.testing.assert_allclose(res[mt][1][n], res[mx][1][n], rtol=1e-5,
                                   atol=1e-5, err_msg=n)


def test_custom_softmax_example_learns_through_fit():
    """``Module.fit`` over an ``NDArrayIter``, as the example runs it:
    the held-out accuracy rises from chance."""
    x, y = _digits(2, 400)
    np.random.seed(0)
    mt.random.seed(0)
    train = mt.io.NDArrayIter(x[:300], y[:300], 50, shuffle=True)
    test = mt.io.NDArrayIter(x[300:], y[300:], 50)
    mod = mt.mod.Module(_net(mt), context=CPU)
    mod.fit(train, num_epoch=4, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            initializer=mt.initializer.Xavier())
    assert mod.score(test, "acc")[0][1] > 0.5


def test_custom_op_imperatively_under_autograd():
    x, y = _digits(3, 8)
    logits = x[:, :10] * 3
    grads = {}
    for pkg in (mx, mt):
        kw = {"ctx": CPU} if pkg is mt else {}
        a = pkg.nd.array(logits, **kw)
        a.attach_grad()
        with pkg.autograd.record():
            out = pkg.nd.Custom(a, pkg.nd.array(y, **kw),
                                op_type="numpy_softmax")
        out.backward()
        grads[pkg] = (out.asnumpy(), a.grad.asnumpy())
    np.testing.assert_allclose(grads[mt][0], grads[mx][0], rtol=1e-6)
    np.testing.assert_allclose(grads[mt][1], grads[mx][1], rtol=1e-6,
                               atol=1e-6)


@mt.operator.register("scale_and_count")
class _ScaleProp(mt.operator.CustomOpProp):
    """Two outputs (2x and x + aux) and an auxiliary state."""

    def list_arguments(self):
        return ['data']

    def list_outputs(self):
        return ['twice', 'shifted']

    def list_auxiliary_states(self):
        return ['shift']

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0], in_shape[0]], [in_shape[0]]

    def create_operator(self, ctx, shapes, dtypes):
        return _Scale()


class _Scale(mt.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], 2 * in_data[0].asnumpy())
        self.assign(out_data[1], req[1],
                    in_data[0].asnumpy() + aux[0].asnumpy())

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], 2 * out_grad[0].asnumpy()
                    + out_grad[1].asnumpy())


def test_outputs_and_an_auxiliary_state_without_gradient():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = mt.nd.array(x, ctx=CPU)
    shift = mt.nd.array(np.full((2, 3), 10, np.float32), ctx=CPU)
    a.attach_grad()
    shift.attach_grad()
    with mt.autograd.record():
        twice, shifted = mt.nd.Custom(a, shift, op_type="scale_and_count")
        loss = twice.sum() + 3 * shifted.sum()
    loss.backward()
    np.testing.assert_array_equal(twice.asnumpy(), 2 * x)
    np.testing.assert_array_equal(shifted.asnumpy(), x + 10)
    np.testing.assert_array_equal(a.grad.asnumpy(), np.full((2, 3), 5.0))
    np.testing.assert_array_equal(shift.grad.asnumpy(), 0)
    s = mt.sym.Custom(mt.sym.Variable("data"), mt.sym.Variable("shift"),
                      op_type="scale_and_count")
    assert len(s.list_outputs()) == 2
    with pytest.raises(mt.MXNetError, match="not registered"):
        mt.nd.Custom(a, op_type="no_such_op")
