"""Sparse storage in the port against the JAX package: every case of
``tests/test_sparse.py`` run through both packages on the same numpy
inputs, and the port's own edges (padded and repeated slots beside row 0
and row n - 1, ``grad_req='add'``, the multi-precision route, ``take``
in wrap mode, the errors).

Each case holds ``DENSIFY_COUNT`` flat over its sparse path in both
packages.  Tolerances: values that are copied, gathered or summed from
the same float32 terms in the same order are compared exactly; an
update of the same formula in float32 gets 1e-6 absolute and relative
(XLA may fuse a multiply and an add that torch rounds apart, a few ulp
a step); products over many terms (the CSR dot) 1e-5 (float32 sums of
up to 30 terms in another order).  The port runs on the CPU."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp
import torch_threads  # noqa: F401,E402  a worker's share of the cores

TOL = dict(rtol=1e-6, atol=1e-6)
SP = {mx: jsp, mt: tsp}
PKGS = (mx, mt)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _flat(pkg, fn):
    """``fn()``'s result, and whether ``pkg``'s DENSIFY_COUNT stayed
    flat over it."""
    start = SP[pkg].DENSIFY_COUNT
    out = fn()
    return out, SP[pkg].DENSIFY_COUNT == start


def test_row_sparse_construction_lazy():
    rng = np.random.RandomState(0)
    vals = rng.uniform(-1, 1, (3, 4)).astype('f')
    idx = np.array([1, 5, 7])
    exp = np.zeros((10, 4), 'f')
    exp[idx] = vals
    for pkg in PKGS:
        a, flat = _flat(pkg, lambda: SP[pkg].row_sparse_array(
            (vals, idx), shape=(10, 4)))
        assert flat and a.stype == 'row_sparse' and a.shape == (10, 4)
        _, flat = _flat(pkg, lambda: (a.data.asnumpy(), a.indices.asnumpy(),
                                      a.dtype, a.context))
        assert flat
        np.testing.assert_array_equal(a.data.asnumpy(), vals)
        np.testing.assert_array_equal(a.indices.asnumpy(), idx)
        np.testing.assert_array_equal(a.todense().asnumpy(), exp)
    assert tsp.row_sparse_array((vals, idx), shape=(10, 4)).context == \
        mt.cpu()


def test_row_sparse_from_dense_and_cast():
    dense = np.zeros((6, 3), 'f')
    dense[2] = 1.5
    dense[4] = -2.0
    for pkg in PKGS:
        a = SP[pkg].row_sparse_array(dense)
        np.testing.assert_array_equal(a.indices.asnumpy(), [2, 4])
        np.testing.assert_array_equal(a.data.asnumpy(), dense[[2, 4]])
        back = SP[pkg].cast_storage(a, 'default')
        np.testing.assert_array_equal(back.asnumpy(), dense)
        rt = SP[pkg].cast_storage(pkg.nd.array(dense), 'row_sparse')
        np.testing.assert_array_equal(rt.todense().asnumpy(), dense)
    # the port's nd.cast_storage and tostype make the containers too
    rsp = mt.nd.cast_storage(mt.nd.array(dense), stype='row_sparse')
    csr = mt.nd.array(dense).tostype('csr')
    assert (rsp.stype, csr.stype) == ('row_sparse', 'csr')
    jcsr = jsp.cast_storage(mx.nd.array(dense), 'csr')
    for part in ('data', 'indices', 'indptr'):
        np.testing.assert_array_equal(getattr(csr, part).asnumpy(),
                                      getattr(jcsr, part).asnumpy())
    np.testing.assert_array_equal(
        mt.nd.cast_storage(rsp, stype='default').asnumpy(), dense)


def test_row_sparse_retain():
    vals = np.arange(12, dtype='f').reshape(4, 3)
    for pkg in PKGS:
        a = SP[pkg].row_sparse_array((vals, [0, 2, 5, 7]), shape=(10, 3))
        r, flat = _flat(pkg, lambda: a.retain([2, 7]))
        assert flat
        np.testing.assert_array_equal(r.indices.asnumpy(), [2, 7])
        np.testing.assert_array_equal(r.data.asnumpy(), vals[[1, 3]])
    # the op: a dense array keeps the listed rows (as the JAX op), a
    # row-sparse one its stored rows among them (no densify)
    dense = np.arange(15, dtype='f').reshape(5, 3)
    ids = np.array([4, 1, 1], 'f')
    for name in ('_sparse_retain', 'sparse_retain'):
        got = getattr(mt.nd, name)(mt.nd.array(dense), mt.nd.array(ids))
        want = getattr(mx.nd, name)(mx.nd.array(dense), mx.nd.array(ids))
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    a = tsp.row_sparse_array((vals, [0, 2, 5, 7]), shape=(10, 3))
    r, flat = _flat(mt, lambda: mt.nd._sparse_retain(a, mt.nd.array(
        np.array([7, 3, 0], 'f'))))
    assert flat and r.stype == 'row_sparse'
    np.testing.assert_array_equal(r.indices.asnumpy(), [0, 7])


def test_csr_construction_and_dot():
    dense = np.zeros((5, 6), 'f')
    dense[0, 1] = 1.0
    dense[2, 3] = 2.0
    dense[2, 5] = 3.0
    dense[4, 0] = -1.0
    rng = np.random.RandomState(0)
    rhs = rng.uniform(-1, 1, (6, 4)).astype('f')
    big = (rng.uniform(-1, 1, (20, 30))
           * (rng.uniform(0, 1, (20, 30)) < 0.3)).astype('f')
    big_rhs = rng.uniform(-1, 1, (30, 5)).astype('f')
    outs = {}
    for pkg in PKGS:
        a = SP[pkg].csr_matrix(dense)
        assert a.stype == 'csr'
        np.testing.assert_array_equal(a.indptr.asnumpy(), [0, 1, 1, 3, 3, 4])
        np.testing.assert_array_equal(a.todense().asnumpy(), dense)
        b = SP[pkg].csr_matrix(big)
        out, flat = _flat(pkg, lambda: (a.dot(pkg.nd.array(rhs)).asnumpy(),
                                        b.dot(pkg.nd.array(big_rhs))
                                        .asnumpy()))
        assert flat
        np.testing.assert_allclose(out[0], dense @ rhs, rtol=1e-5)
        outs[pkg] = out
    np.testing.assert_allclose(outs[mt][1], outs[mx][1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(outs[mt][1], big @ big_rhs, rtol=1e-5,
                               atol=1e-6)


def test_dedup_rows():
    """The JAX package's test, then the port against it on repeats in
    random order: the same ids and slots; sums of the same terms in the
    same (stable) order, so exact."""
    vals = torch.tensor([[1.], [2.], [4.], [8.]])
    idx = torch.tensor([3, 1, 3, 1])
    agg, didx = tsp.dedup_rows(vals, idx, 10)
    got = {int(i): float(v[0]) for v, i in zip(agg, didx) if i < 10}
    assert got == {1: 10.0, 3: 5.0}
    rng = np.random.RandomState(1)
    v = rng.uniform(-1, 1, (40, 3)).astype('f')
    i = rng.randint(0, 9, 40)
    ja, ji = jsp.dedup_rows(jnp.asarray(v), jnp.asarray(i.astype(np.int32)),
                            50)
    ta, ti = tsp.dedup_rows(torch.from_numpy(v), torch.from_numpy(i), 50)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_sparse_zeros():
    for pkg in PKGS:
        z = SP[pkg].zeros('row_sparse', (100, 8))
        assert z.indices.shape[0] == 0 and z.shape == (100, 8)
        zc = SP[pkg].zeros('csr', (10, 10))
        assert zc.data.shape[0] == 0 and zc.indptr.shape == (11,)
    assert tsp.zeros('row_sparse', (4, 2), ctx=mt.cpu()).context == mt.cpu()


def _embedding_grad(pkg, vocab, dim, w0, ids, stype, proj=None,
                    op='Embedding'):
    w = pkg.nd.array(w0)
    w.attach_grad(stype=stype)
    x = pkg.nd.array(ids)

    def run():
        with pkg.autograd.record():
            if op == 'Embedding':
                out = pkg.nd.Embedding(x, w, input_dim=vocab,
                                       output_dim=dim, sparse_grad=True)
            else:
                out = pkg.nd.take(w, x, axis=0, mode=op)
            loss = (out * (out if proj is None
                           else pkg.nd.array(proj))).sum()
        loss.backward()
        return w.grad
    return w, _flat(pkg, run)


def test_embedding_sparse_grad_imperative():
    """A 10^6-row table's gradient holds the 4 rows read, repeats kept in
    the order read, and nothing dense is built."""
    vocab, dim = 1_000_000, 16
    ids = np.array([3, 77, 3, 999_999], 'f')
    for pkg in PKGS:
        w, (g, flat) = _embedding_grad(pkg, vocab, dim,
                                       np.zeros((vocab, dim), 'f'), ids,
                                       'row_sparse')
        assert flat and isinstance(g, SP[pkg].RowSparseNDArray)
        assert g.data.shape == (4, dim)
        np.testing.assert_array_equal(g.indices.asnumpy(),
                                      [3, 77, 3, 999999])


@pytest.mark.parametrize("op,ids", [
    ("Embedding", [3, 7, 3, 9, 7, 3, 60.7, -2.5]),
    ("clip", [3, 7, 3, 9, 7, 3, 60.7, -2.5]),
    ("wrap", [3, 7, 3, 9, 7, 3, 61, -2])],
    ids=["embedding", "take_clip", "take_wrap"])
def test_embedding_sparse_grad_matches_dense(op, ids):
    """The sparse gradient's values and ids equal the JAX package's (ids
    normalised as the gather normalised them: truncated, clipped or
    wrapped), its dense value equals the dense gradient, and lazy SGD
    with momentum and weight decay equals the JAX package's: dense SGD
    on the touched rows, the rest untouched."""
    vocab, dim = 50, 4
    rng = np.random.RandomState(0)
    wv = rng.uniform(-1, 1, (vocab, dim)).astype('f')
    ids = np.array(ids, 'f')
    proj = rng.uniform(-1, 1, (len(ids), dim)).astype('f')
    res = {}
    for pkg in PKGS:
        for stype in ('row_sparse', None):
            w, (g, flat) = _embedding_grad(pkg, vocab, dim, wv, ids, stype,
                                           proj, op)
            assert flat
            opt = pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                    wd=0.01, rescale_grad=1.0)
            state = opt.create_state(0, w)
            snap = (g.data.asnumpy(), g.indices.asnumpy()) if stype else \
                (g.asnumpy(), None)
            dense_g = g.todense().asnumpy() if stype else g.asnumpy()
            _, flat = _flat(pkg, lambda: opt.update(0, w, w.grad,
                                                    list(state)))
            assert flat
            res[pkg, stype] = snap + (dense_g, w.asnumpy())
    for k in range(2):   # sparse values and ids: exact
        np.testing.assert_array_equal(res[mt, 'row_sparse'][k],
                                      res[mx, 'row_sparse'][k])
    np.testing.assert_array_equal(res[mt, 'row_sparse'][2], res[mt, None][2])
    for stype in ('row_sparse', None):
        np.testing.assert_allclose(res[mt, stype][3], res[mx, stype][3],
                                   **TOL)
    touched = np.unique(res[mt, 'row_sparse'][1])
    untouched = np.setdiff1d(np.arange(vocab), touched)
    ws, wd_ = res[mt, 'row_sparse'][3], res[mt, None][3]
    np.testing.assert_allclose(ws[touched], wd_[touched], **TOL)
    np.testing.assert_array_equal(ws[untouched], wv[untouched])


def test_sparse_adam_touches_only_rows():
    vocab, dim = 1000, 8
    w0 = np.random.RandomState(0).uniform(-1, 1, (vocab, dim)).astype('f')
    res = {}
    for pkg in PKGS:
        w, (g, flat) = _embedding_grad(pkg, vocab, dim, w0,
                                       np.array([5, 10, 5], 'f'),
                                       'row_sparse', np.ones((3, dim), 'f'))
        opt = pkg.optimizer.Adam(learning_rate=0.1)
        opt._update_count(0)
        state = opt.create_state(0, w)
        _, flat = _flat(pkg, lambda: opt.update(0, w, w.grad, list(state)))
        assert flat
        w1 = w.asnumpy()
        changed = np.where(np.any(w1 != w0, axis=1))[0]
        np.testing.assert_array_equal(changed, [5, 10])
        res[pkg] = [w1] + [s.asnumpy() for s in state]
    for a, b in zip(res[mt], res[mx]):
        np.testing.assert_allclose(a, b, **TOL)


def test_kvstore_row_sparse_pull_no_densify():
    vocab, dim = 10000, 4
    table = np.random.RandomState(0).uniform(-1, 1, (vocab, dim)).astype('f')
    rid = np.array([17, 2048, 9999, 17], 'f')
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        kv.init('emb', pkg.nd.array(table))
        out = SP[pkg].zeros('row_sparse', (vocab, dim))
        vals, flat = _flat(pkg, lambda: (
            kv.row_sparse_pull('emb', out=out, row_ids=pkg.nd.array(rid)),
            out.data.asnumpy())[1])
        assert flat
        np.testing.assert_array_equal(vals, table[[17, 2048, 9999]])
        np.testing.assert_array_equal(out.indices.asnumpy(),
                                      [17, 2048, 9999])


def _towers_step(pkg, net, trainer, ids, target):
    with pkg.autograd.record():
        loss = ((net(ids) - target) ** 2).sum()
    loss.backward()
    assert isinstance(net.weight.grad(), SP[pkg].RowSparseNDArray)
    trainer.step(1)
    return float(loss.asnumpy())


def test_gluon_sparse_embedding_trains():
    """A sparse Gluon Embedding from the same weights in both packages:
    every loss and the final table agree, the loss falls 20x, and rows
    no batch read are bit-identical to the start."""
    vocab, dim = 500, 8
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-0.07, 0.07, (vocab, dim)).astype('f')
    ids_np = np.array([1, 42, 7, 99], 'f')
    target_np = rng.uniform(-1, 1, (4, dim)).astype('f')
    res = {}
    for pkg in PKGS:
        net = pkg.gluon.nn.Embedding(vocab, dim, sparse_grad=True)
        net.initialize()
        net.weight.set_data(pkg.nd.array(w0))
        trainer = pkg.gluon.Trainer(net.collect_params(), 'sgd',
                                    {'learning_rate': 0.1})
        ids, target = pkg.nd.array(ids_np), pkg.nd.array(target_np)
        losses, flat = _flat(pkg, lambda: [
            _towers_step(pkg, net, trainer, ids, target) for _ in range(30)])
        assert flat
        assert losses[-1] < 0.05 * losses[0], losses
        res[pkg] = (losses, net.weight.data().asnumpy())
    np.testing.assert_allclose(res[mt][0], res[mx][0], rtol=1e-5)
    np.testing.assert_allclose(res[mt][1], res[mx][1], **TOL)
    untouched = np.setdiff1d(np.arange(vocab), ids_np.astype(int))
    np.testing.assert_array_equal(res[mt][1][untouched], w0[untouched])


def test_rand_sparse_ndarray():
    """The same draws from the same RandomState give the same arrays,
    through ``sparse.rand_sparse_ndarray`` and through
    ``test_utils.rand_ndarray`` (C6)."""
    for stype, shape in (('csr', (6, 3)), ('row_sparse', (8, 5))):
        got = tsp.rand_sparse_ndarray(shape, stype, density=0.4,
                                      rng=np.random.RandomState(2))
        want = jsp.rand_sparse_ndarray(shape, stype, density=0.4,
                                       rng=np.random.RandomState(2))
        assert got[0].stype == want[0].stype == stype
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0].todense().asnumpy(), got[1])
        np.testing.assert_array_equal(got[0].indices.asnumpy(),
                                      want[0].indices.asnumpy())
        np.random.seed(5)
        t = mt.test_utils.rand_ndarray(shape, stype, density=0.4)
        np.random.seed(5)
        j = mx.test_utils.rand_ndarray(shape, stype, density=0.4)
        np.testing.assert_array_equal(t.todense().asnumpy(),
                                      j.todense().asnumpy())


def test_square_sum_row_sparse():
    """O(nnz) square_sum, no densify, in both packages and through the
    port's ``nd._square_sum`` (float32 sums of the same terms: 1e-6)."""
    outs = {}
    for pkg in PKGS:
        sp_, dense = SP[pkg].rand_sparse_ndarray(
            (50, 6), 'row_sparse', density=0.2, rng=np.random.RandomState(0))
        (total, ax0, ax1, ax1k), flat = _flat(pkg, lambda: (
            SP[pkg].square_sum(sp_), SP[pkg].square_sum(sp_, axis=0),
            SP[pkg].square_sum(sp_, axis=1),
            SP[pkg].square_sum(sp_, axis=1, keepdims=True)))
        assert flat and isinstance(ax1, SP[pkg].RowSparseNDArray)
        assert ax1k.shape == (50, 1)
        np.testing.assert_allclose(total.asnumpy(), np.sum(dense * dense),
                                   rtol=1e-5)
        np.testing.assert_allclose(ax1.todense().asnumpy(),
                                   np.sum(dense * dense, axis=1), rtol=1e-5)
        d = SP[pkg].square_sum(pkg.nd.array(dense), axis=1)
        np.testing.assert_allclose(d.asnumpy(), np.sum(dense * dense, axis=1),
                                   rtol=1e-5)
        outs[pkg] = [total.asnumpy(), ax0.asnumpy(), ax1.data.asnumpy(),
                     ax1.indices.asnumpy()]
    for a, b in zip(outs[mt], outs[mx]):
        np.testing.assert_allclose(a, b, **TOL)
    sp_, _ = tsp.rand_sparse_ndarray((50, 6), 'row_sparse', density=0.2,
                                     rng=np.random.RandomState(0))
    via_op, flat = _flat(mt, lambda: mt.nd._square_sum(sp_, axis=1))
    assert flat and via_op.stype == 'row_sparse'
    np.testing.assert_array_equal(via_op.data.asnumpy(), outs[mt][2])


# -- the port's own edges ----------------------------------------------------
@pytest.mark.parametrize("ids", [
    [0, 9, 0, 9, 0, 0, 9],        # row 0 first: padding points at row 0
    [9, 9, 9],                     # only row n - 1
    [0, 0],                        # only row 0
    [9, 0, 9, 5, 5, 0, 9, 9]],     # three rows, five padded slots
    ids=["ends", "last_only", "first_only", "three"])
@pytest.mark.parametrize("name,params", [
    ("sgd", {"momentum": 0.9, "wd": 0.1}), ("sgd", {"wd": 0.1}),
    ("adam", {"wd": 0.1})], ids=["sgd_mom", "sgd", "adam"])
def test_padded_and_repeated_slots_change_only_their_rows(ids, name,
                                                          params):
    """Repeats leave padded slots in the lazy update: no other row of the
    weight or of its states changes (bit for bit), not even row 0 or
    row n - 1 beside them, and the touched rows equal the JAX
    package's, over two steps (the second on a weight with -0.0, +0.0
    and NaN in its untouched rows)."""
    n, dim = 10, 3
    rng = np.random.RandomState(3)
    w0 = rng.uniform(-1, 1, (n, dim)).astype('f')
    vals = rng.uniform(-1, 1, (len(ids), dim)).astype('f')
    res = {}
    for pkg in PKGS:
        w = pkg.nd.array(w0)
        opt = pkg.optimizer.create(name, learning_rate=0.3, **params)
        state = list(opt.create_state(0, w))
        before = [w0] + [s.asnumpy() for s in state]
        g = SP[pkg].row_sparse_array((vals, np.array(ids)), shape=(n, dim))
        _, flat = _flat(pkg, lambda: opt.update(0, w, g, state))
        assert flat
        res[pkg] = [w.asnumpy()] + [s.asnumpy() for s in state]
    untouched = np.setdiff1d(np.arange(n), ids)
    for a, b, was in zip(res[mt], res[mx], before):
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_array_equal(a[untouched], was[untouched])
    # signed zeros and NaN in untouched rows survive a second step
    special = res[mt][0].copy()
    special[untouched[0]] = [-0.0, 0.0, np.nan]
    w = mt.nd.array(special)
    opt = mt.optimizer.create(name, learning_rate=0.3, **params)
    state = list(opt.create_state(0, w))
    opt.update(0, w, tsp.row_sparse_array((vals, np.array(ids)),
                                          shape=(n, dim)), state)
    got = w.asnumpy()
    assert np.array_equal(got[untouched].view(np.int32),
                          special[untouched].view(np.int32))


def test_empty_gradient_is_a_no_op_and_other_optimizers_densify():
    w0 = np.random.RandomState(4).uniform(-1, 1, (6, 2)).astype('f')
    for pkg in PKGS:
        w = pkg.nd.array(w0)
        opt = pkg.optimizer.SGD(learning_rate=0.1, momentum=0.9)
        state = list(opt.create_state(0, w))
        _, flat = _flat(pkg, lambda: opt.update(
            0, w, SP[pkg].zeros('row_sparse', (6, 2)), state))
        assert flat
        np.testing.assert_array_equal(w.asnumpy(), w0)
    res = {}
    for pkg in PKGS:
        w = pkg.nd.array(w0)
        opt = pkg.optimizer.AdaGrad(learning_rate=0.1)
        state = opt.create_state(0, w)
        g = SP[pkg].row_sparse_array((np.ones((2, 2), 'f'), [1, 4]),
                                     shape=(6, 2))
        _, flat = _flat(pkg, lambda: opt.update(0, w, g, state))
        assert not flat          # the dense fallback is counted
        res[pkg] = w.asnumpy()
    np.testing.assert_allclose(res[mt], res[mx], **TOL)


def test_grad_req_add_keeps_old_rows_first():
    """With ``grad_req='add'`` each backward's rows follow the old ones,
    as in the JAX package (values and ids exact)."""
    vocab, dim = 20, 3
    rng = np.random.RandomState(5)
    w0 = rng.uniform(-1, 1, (vocab, dim)).astype('f')
    res = {}
    for pkg in PKGS:
        w = pkg.nd.array(w0)
        w.attach_grad(grad_req='add', stype='row_sparse')
        for ids in ([3, 4], [4, 19, 3]):
            with pkg.autograd.record():
                out = pkg.nd.Embedding(pkg.nd.array(np.array(ids, 'f')), w,
                                       input_dim=vocab, output_dim=dim)
                loss = (out * out).sum()
            _, flat = _flat(pkg, loss.backward)
            assert flat
        res[pkg] = (w.grad.data.asnumpy(), w.grad.indices.asnumpy())
    np.testing.assert_array_equal(res[mt][1], [3, 4, 4, 19, 3])
    for a, b in zip(res[mt], res[mx]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,params", [
    ("sgd", {"momentum": 0.9, "wd": 0.01}), ("adam", {})],
    ids=["sgd_mom", "adam"])
def test_multi_precision_route_updates_the_master(name, params):
    """A bf16 table with ``multi_precision``: the lazy update runs on the
    fp32 master and the weight is recast from it; masters and states
    within 1e-6 of the JAX package's, the bf16 weight within one bf16
    step (2**-8 relative)."""
    vocab, dim = 30, 4
    rng = np.random.RandomState(6)
    w0 = rng.uniform(-1, 1, (vocab, dim)).astype('f')
    vals = rng.uniform(-1, 1, (5, dim)).astype('f')
    ids = np.array([2, 29, 2, 0, 11])
    res = {}
    for pkg in PKGS:
        w = pkg.nd.array(w0).astype('bfloat16')
        opt = pkg.optimizer.create(name, learning_rate=0.1,
                                   multi_precision=True, **params)
        state = list(opt.create_state_multi_precision(0, w))
        assert len(state) == 1 + (2 if name == 'adam' else 1)
        for _ in range(2):
            g = SP[pkg].row_sparse_array(
                (pkg.nd.array(vals).astype('bfloat16'), ids),
                shape=(vocab, dim))
            _, flat = _flat(pkg, lambda: opt.update(0, w, g, state))
            assert flat
        res[pkg] = (w.asnumpy(), [s.asnumpy() for s in state])
    np.testing.assert_allclose(res[mt][0], res[mx][0], rtol=2 ** -8,
                               atol=1e-6)
    for a, b in zip(res[mt][1], res[mx][1]):
        np.testing.assert_allclose(a, b, **TOL)
    untouched = np.setdiff1d(np.arange(vocab), ids)
    np.testing.assert_array_equal(
        res[mt][1][0][untouched],
        torch.from_numpy(w0).bfloat16().float().numpy()[untouched])


def test_other_reads_of_a_sparse_variable_raise_as_in_jax():
    """Any op other than a gather, and a hybridized graph, make the
    backward raise in both packages.  The JAX package keeps its tape
    after the failed backward (the next backward would raise the same),
    so the test clears it; the port drops what it recorded."""
    for pkg in PKGS:
        w = pkg.nd.array(np.ones((4, 2), 'f'))
        w.attach_grad(stype='row_sparse')
        with pkg.autograd.record():
            loss = (w * w).sum()
        with pytest.raises(pkg.base.MXNetError, match="only Embedding"):
            loss.backward()
        if pkg is mx:
            mx.autograd._clear_tape()
        net = pkg.gluon.nn.Embedding(4, 2, sparse_grad=True)
        net.initialize()
        net.hybridize()
        with pkg.autograd.record():
            loss = net(pkg.nd.array(np.array([1, 2], 'f'))).sum()
        with pytest.raises(pkg.base.MXNetError, match="hybridized"):
            loss.backward()
        if pkg is mx:
            mx.autograd._clear_tape()
