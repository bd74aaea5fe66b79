"""The sparse slice end to end, through both packages on the CPU:

* ``examples/sparse/linear_classification.py``'s loop at its own size
  (10^4 features, 16 nonzeros a row, batch 128; its ``make_dataset``):
  CSR columns through ``nd.Embedding(sparse_grad=True)``, the store's
  ``row_sparse_pull`` checked against the weight every step, lazy SGD
  (with and without momentum) and lazy Adam;
* ``examples/recommender/two_tower.py``'s ``train`` (its
  ``make_clickstream``, two sparse Gluon Embeddings,
  ``Trainer(kvstore='device')``) and its hit@10; then its whole
  ``tests/test_two_tower.py`` scenario at the same toy sizes: the
  towers train over ``dist_async`` (the row-sparse wire), a
  ``ServingReplica`` serves top-k from the live tables and refreshes
  from the same parameter server after more training;
* ``Module.fit`` of a small MLP with ``kvstore=kv.create('local')``,
  which updates inside the store;
* ``LibSVMIter``'s CSR batches of the classifier's data.

Tolerances, with their reasons: the classifier's weights and states
agree to 1e-5 relative and 1e-6 absolute after every step (XLA's and
torch's float32 log and sigmoid differ by an ulp or two), but lazy
Adam's weights to 2e-4 absolute (the test says why); the towers'
tables to 1e-4 after each epoch (128 SGD steps an epoch at learning
rate 0.5 carry the ulp differences of the products along), and so the
served scores (products of those tables) to 1e-4; the MLP's
weights and states to 1e-6 (the same float32 formulas).  Rows that no
step touched are compared bit for bit against the start."""
import importlib.util
import os

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp
import torch_threads  # noqa: F401,E402  a worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP = {mx: jsp, mt: tsp}
PKGS = (mx, mt)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _example(rel):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- examples/sparse/linear_classification.py --------------------------------
def _linear_steps(pkg, cols, vals, y, optimizer, opt_params, batch, steps):
    """The example's loop for ``steps`` batches, as its ``train`` runs it:
    the per-step snapshot (weight, its states, the pulled row ids, the
    loss) and whether DENSIFY_COUNT stayed flat."""
    nd, sp = pkg.nd, SP[pkg]
    num_features, nnz = 10000, cols.shape[1]
    kv = pkg.kv.create('local')
    w = nd.zeros((num_features, 1))
    w.attach_grad(stype='row_sparse')
    bias = nd.zeros((1,))
    bias.attach_grad()
    kv.init('w', w)
    opt = pkg.optimizer.create(optimizer, learning_rate=0.5, **opt_params)
    w_state = list(opt.create_state(0, w))
    b_state = list(opt.create_state(1, bias))
    start = sp.DENSIFY_COUNT
    snaps = []
    for i in range(steps):
        sl = slice(i * batch, (i + 1) * batch)
        bc, bv, by = nd.array(cols[sl]), nd.array(vals[sl]), nd.array(y[sl])
        row_ids = np.unique(cols[sl]).astype(np.float32)
        pulled = sp.zeros('row_sparse', w.shape)
        kv.row_sparse_pull('w', out=pulled, row_ids=nd.array(row_ids))
        np.testing.assert_array_equal(pulled.data.asnumpy(),
                                      w.asnumpy()[row_ids.astype(int)])
        with pkg.autograd.record():
            emb = nd.Embedding(bc, w, input_dim=num_features, output_dim=1,
                               sparse_grad=True)
            logits = (emb.reshape((batch, nnz)) * bv).sum(axis=1) + bias
            p = nd.sigmoid(logits)
            loss = -(by * nd.log(p + 1e-7)
                     + (1 - by) * nd.log(1 - p + 1e-7)).mean()
        loss.backward()
        assert isinstance(w.grad, sp.RowSparseNDArray)
        opt.update(0, w, w.grad, w_state)
        opt.update(1, bias, bias.grad, b_state)
        kv.push('w', w)
        snaps.append((w.asnumpy(), [s.asnumpy() for s in w_state],
                      pulled.indices.asnumpy(), float(loss.asscalar())))
    return snaps, sp.DENSIFY_COUNT == start


@pytest.mark.parametrize("optimizer,params,w_atol", [
    ("sgd", {}, 1e-6), ("sgd", {"momentum": 0.9}, 1e-6),
    ("adam", {}, 2e-4)], ids=["sgd", "sgd_momentum", "adam"])
def test_linear_classification_loop_matches_jax(optimizer, params, w_atol):
    """``w_atol``: lazy Adam at the example's learning rate 0.5 steps a
    row by about lr * m / (sqrt(v) + 1e-8); where a row's summed gradient
    cancels to about 1e-9, the ulp differences of the two packages'
    float32 logs and sigmoids become percent differences of that step:
    up to 1.33e-4 absolute, bounded over the epoch (measured), against
    weights of order 0.1."""
    ex = _example("examples/sparse/linear_classification.py")
    cols, vals, y, _ = ex.make_dataset(num_features=10000, nnz=16, seed=0)
    batch, steps = 128, 16        # the example's one epoch
    res = {pkg: _linear_steps(pkg, cols, vals, y, optimizer, params, batch,
                              steps) for pkg in PKGS}
    assert res[mt][1] and res[mx][1], "a sparse path densified"
    for step, (t, j) in enumerate(zip(res[mt][0], res[mx][0])):
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=w_atol,
                                   err_msg=f"weight, step {step}")
        for a, b in zip(t[1], j[1]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=f"state, step {step}")
        np.testing.assert_array_equal(t[2], j[2])
        seen = np.unique(cols[:(step + 1) * batch])
        untouched = np.setdiff1d(np.arange(10000), seen)
        np.testing.assert_array_equal(t[0][untouched], 0.0)
        for a in t[1]:
            np.testing.assert_array_equal(a[untouched], 0.0)
    np.testing.assert_allclose([s[3] for s in res[mt][0]],
                               [s[3] for s in res[mx][0]], rtol=1e-5)


def test_libsvm_batches_of_the_classifier_equal_jax(tmp_path):
    """The classifier's rows as a LibSVM file: both packages' CSR batches
    have the same parts, and ``csr.dot(w)`` equals the Embedding route's
    sums (float32 sums of 16 terms in another order: 1e-5)."""
    ex = _example("examples/sparse/linear_classification.py")
    cols, vals, y, planted = ex.make_dataset(num_samples=300,
                                             num_features=10000, nnz=16)
    path = str(tmp_path / "train.libsvm")
    with open(path, "w") as f:
        for c, v, lab in zip(cols.astype(int), vals, y):
            f.write("%d %s\n" % (lab, " ".join(
                "%d:%g" % (ci, vi) for ci, vi in zip(c, v))))
    kw = dict(data_libsvm=path, data_shape=(10000,), batch_size=128)
    jb, tb = list(mx.io.LibSVMIter(**kw)), list(mt.io.LibSVMIter(**kw))
    assert len(jb) == len(tb) == 3 and tb[-1].pad == jb[-1].pad == 84
    w = planted.reshape(-1, 1)
    for r, (a, b) in enumerate(zip(jb, tb)):
        x, z = a.data[0], b.data[0]
        assert z.stype == 'csr' and z.context == mt.cpu()
        for part in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(getattr(z, part).asnumpy(),
                                          getattr(x, part).asnumpy())
        np.testing.assert_array_equal(b.label[0].asnumpy(),
                                      a.label[0].asnumpy())
        start = tsp.DENSIFY_COUNT
        got = z.dot(mt.nd.array(w)).asnumpy()[:, 0]
        assert tsp.DENSIFY_COUNT == start
        rows = (np.arange(128) + r * 128) % 300
        want = (planted[cols[rows].astype(int)] * vals[rows]).sum(axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(z.todense().asnumpy(),
                                      x.todense().asnumpy())


# -- examples/recommender/two_tower.py ----------------------------------------
def _towers(pkg, users, items, dim, u0, i0):
    towers = []
    for n, prefix, w0 in ((users, 'user_embed_', u0),
                          (items, 'item_scores_', i0)):
        t = pkg.gluon.nn.Embedding(n, dim, sparse_grad=True, prefix=prefix)
        t.initialize()
        t.weight.set_data(pkg.nd.array(w0))
        towers.append(t)
    return towers


def _two_tower_epochs(pkg, towers, stream, epochs, batch=64, lr=0.5,
                      kvstore='device', trainer=None):
    """The example's ``train`` (a Trainer over ``kvstore``, SGD), with
    the tables after each epoch; ``trainer`` continues an earlier run."""
    user_tower, item_tower = towers
    u, i, y, _ = stream
    params = (list(user_tower.collect_params().values())
              + list(item_tower.collect_params().values()))
    if trainer is None:
        trainer = pkg.gluon.Trainer(params, 'sgd', {'learning_rate': lr},
                                    kvstore=kvstore)
    _two_tower_epochs.trainer = trainer
    n = len(y)
    out = []
    start = SP[pkg].DENSIFY_COUNT
    for _ in range(epochs):
        total = 0.0
        for lo in range(0, n - batch + 1, batch):
            with pkg.autograd.record():
                ue = user_tower(pkg.nd.array(u[lo:lo + batch]))
                ve = item_tower(pkg.nd.array(i[lo:lo + batch]))
                score = pkg.nd.sum(ue * ve, axis=1)
                loss = pkg.nd.sum((score - pkg.nd.array(y[lo:lo + batch]))
                                  ** 2)
            loss.backward()
            trainer.step(batch)
            total += float(loss.asnumpy())
        out.append((user_tower.weight.data().asnumpy(),
                    item_tower.weight.data().asnumpy(), total / n))
    assert trainer._kvstore is not None or pkg is mx
    return out, SP[pkg].DENSIFY_COUNT == start


def test_two_tower_train_matches_jax():
    ex = _example("examples/recommender/two_tower.py")
    users, items, dim, epochs = 64, 256, 8, 3
    stream = ex.make_clickstream(users, items)
    rng = np.random.RandomState(0)
    u0 = rng.normal(0, 0.3, (users, dim)).astype('f')
    i0 = rng.normal(0, 0.3, (items, dim)).astype('f')
    res = {}
    for pkg in PKGS:
        towers = _towers(pkg, users, items, dim, u0, i0)
        res[pkg] = _two_tower_epochs(pkg, towers, stream, epochs) + (
            ex.hit_rate(*towers, stream[3]),)
    assert res[mt][1] and res[mx][1], "a sparse path densified"
    for e, (t, j) in enumerate(zip(res[mt][0], res[mx][0])):
        for a, b in zip(t[:2], j[:2]):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4,
                                       err_msg=f"epoch {e}")
        np.testing.assert_allclose(t[2], j[2], rtol=1e-4)
    assert res[mt][2] == res[mx][2]
    assert res[mt][0][-1][2] < res[mt][0][0][2]


def test_two_tower_untouched_rows_stay_bit_identical():
    """Users and items no batch reads keep their initial rows exactly."""
    users, items, dim = 40, 100, 4
    rng = np.random.RandomState(1)
    u0 = rng.normal(0, 0.3, (users, dim)).astype('f')
    i0 = rng.normal(0, 0.3, (items, dim)).astype('f')
    u = rng.randint(0, users // 2, 256).astype('f')
    i = rng.randint(0, items // 2, 256).astype('f')
    y = rng.randint(0, 2, 256).astype('f')
    towers = _towers(mt, users, items, dim, u0, i0)
    out, flat = _two_tower_epochs(mt, towers, (u, i, y, None), 1, batch=32)
    assert flat
    for w, w0, ids in ((out[-1][0], u0, u), (out[-1][1], i0, i)):
        untouched = np.setdiff1d(np.arange(len(w0)), ids.astype(int))
        assert len(untouched) >= len(w0) // 2
        np.testing.assert_array_equal(w[untouched], w0[untouched])
        assert not np.array_equal(w, w0)


def _serve_topk(pkg, towers, users, items, dim, uri):
    """The example's ``serve_topk`` in ``pkg``: a replica over the
    trained tables (user ids -> user embedding -> every item's score)
    refreshing from the parameter server at ``uri``, and a client."""
    user = pkg.sym.Variable('user')
    emb = pkg.sym.Embedding(user, input_dim=users, output_dim=dim,
                            name='user_embed')
    net = pkg.sym.FullyConnected(emb, num_hidden=items, no_bias=True,
                                 name='item_scores')
    params = {'user_embed_weight': towers[0].weight.data(),
              'item_scores_weight': towers[1].weight.data()}
    rep = pkg.serving.ServingReplica(net, {'user': ()}, params,
                                     buckets=[1, 4, 16], max_wait_s=0.0,
                                     param_servers=uri)
    rep.start_background()
    return rep, pkg.serving.ServingClient(f"127.0.0.1:{rep.port}")


def _two_tower_dist_serve(pkg, monkeypatch, ex):
    """``tests/test_two_tower.py``'s scenario in ``pkg``; returns what it
    saw."""
    users, items, dim = 32, 64, 4
    stream = ex.make_clickstream(users, items, events=1024, pool=8, seed=3)
    rng = np.random.RandomState(2)
    u0 = rng.normal(0, 0.3, (users, dim)).astype('f')
    i0 = rng.normal(0, 0.3, (items, dim)).astype('f')
    ps = pkg.kvstore_server.KVStoreServer(server_id=0, num_workers=1)
    ps.start_background()
    uri = f"127.0.0.1:{ps.port}"
    for k, v in (("MXT_SERVER_URIS", uri), ("DMLC_NUM_WORKER", "1"),
                 ("DMLC_WORKER_ID", "0"), ("MXNET_KVSTORE_SPARSE", "1")):
        monkeypatch.setenv(k, v)
    pkg.profiler.reset_dispatch_counts()
    rows0 = pkg.profiler.channel_counts().get("kvstore.sparse_rows", 0)
    towers = _towers(pkg, users, items, dim, u0, i0)
    rep = cli = kv = None
    try:
        tables, _ = _two_tower_epochs(pkg, towers, stream, 4, batch=32,
                                      kvstore='dist_async')
        trainer = _two_tower_epochs.trainer
        kv = trainer._kvstore
        assert pkg.profiler.channel_counts()["kvstore.sparse_rows"] > rows0
        hit = ex.hit_rate(*towers, stream[3])
        rep, cli = _serve_topk(pkg, towers, users, items, dim, uri)
        scores = cli.predict(np.arange(16, dtype=np.float32),
                             name='user')[0]
        topk = np.argsort(-scores, axis=1)[:, :10]
        served_hits = np.mean([len(set(topk[r]) & set(stream[3][r])) > 0
                               for r in range(16)])
        probe = np.arange(8, dtype=np.float32)
        before = cli.predict(probe, name='user')[0].copy()
        compiles = pkg.profiler.dispatch_counts().get(
            "serving.predict_compile", 0)
        more, _ = _two_tower_epochs(pkg, towers, stream, 2, batch=32,
                                    trainer=trainer)
        kv.barrier()
        assert cli.refresh()["refreshed"] is False   # nothing published
        v = pkg.serving.publish_version(kv)
        r = cli.refresh()
        assert r["refreshed"] is True and r["version"] == v == 1
        after = cli.predict(probe, name='user')[0]
        assert not np.allclose(before, after)
        fresh = towers[0].weight.data().asnumpy()[probe.astype(np.int64)]
        np.testing.assert_allclose(
            fresh @ towers[1].weight.data().asnumpy().T, after,
            rtol=1e-5, atol=1e-6)
        assert pkg.profiler.dispatch_counts().get(
            "serving.predict_compile", 0) == compiles
        return tables + more, hit, served_hits, scores, before, after
    finally:
        if cli is not None:
            cli.close()
        if rep is not None:
            rep.stop()
        if kv is not None:
            kv.close(stop_servers=False)
        ps.stop()
        monkeypatch.undo()


def test_two_tower_trains_over_dist_async_and_serves_topk_live(monkeypatch):
    """The towers train over ``dist_async`` (the gradients ride the
    row-sparse wire), a replica serves top-k from the same parameter
    server, and after two more epochs a version bump and a refresh swap
    the served tables with no new bucket shape: in both packages, with
    tables, hits, served scores and the refreshed scores equal."""
    ex = _example("examples/recommender/two_tower.py")
    got = {pkg: _two_tower_dist_serve(pkg, monkeypatch, ex)
           for pkg in PKGS}
    (t_mt, hit_mt, sh_mt, *scores_mt), (t_mx, hit_mx, sh_mx, *scores_mx) \
        = got[mt], got[mx]
    for e, (a, b) in enumerate(zip(t_mt, t_mx)):
        for x, y in zip(a[:2], b[:2]):
            np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-4,
                                       err_msg=f"epoch {e}")
    assert hit_mt == hit_mx and hit_mt >= 0.8
    assert sh_mt == sh_mx and sh_mt >= 0.8
    for a, b in zip(scores_mt, scores_mx):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


# -- Module.fit with a KVStore object -----------------------------------------
def _mlp(pkg):
    x = pkg.sym.Variable('data')
    h = pkg.sym.Activation(pkg.sym.FullyConnected(x, num_hidden=16,
                                                  name='fc1'),
                           act_type='relu')
    out = pkg.sym.FullyConnected(h, num_hidden=3, name='fc2')
    return pkg.sym.SoftmaxOutput(out, name='softmax')


def _mlp_fit(pkg, kvstore, x, y, args, states_file):
    mod = pkg.mod.Module(_mlp(pkg), context=pkg.cpu())
    it = pkg.io.NDArrayIter(x, y, batch_size=8)
    mod.fit(it, num_epoch=2, kvstore=kvstore,
            arg_params={k: pkg.nd.array(v) for k, v in args.items()},
            optimizer='sgd',
            optimizer_params={'learning_rate': 0.1, 'momentum': 0.9,
                              'wd': 0.001})
    mod.save_optimizer_states(states_file)
    return mod, {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_through_a_local_store_matches_jax(tmp_path):
    """``Module.fit(kvstore=kv.create('local'))`` updates inside the store
    in both packages: the weights agree, each package's state file loads
    into the other's module value for value, and the port's weights equal
    its own fit without a store."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (32, 5)).astype('f')
    y = rng.randint(0, 3, 32).astype('f')
    args = {'fc1_weight': rng.normal(0, 0.5, (16, 5)).astype('f'),
            'fc1_bias': np.zeros(16, 'f'),
            'fc2_weight': rng.normal(0, 0.5, (3, 16)).astype('f'),
            'fc2_bias': np.zeros(3, 'f')}
    mods, params = {}, {}
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        mods[pkg], params[pkg] = _mlp_fit(pkg, kv, x, y, args,
                                          str(tmp_path / pkg.__name__))
        assert mods[pkg]._update_on_kvstore and mods[pkg]._kvstore is kv
    for k in args:
        np.testing.assert_allclose(params[mt][k], params[mx][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)

    def states(pkg):
        return {k: [s.asnumpy() for s in v] for k, v in
                mods[pkg]._kvstore._updater.states.items()}
    want = {pkg: states(pkg) for pkg in PKGS}
    assert sorted(want[mt]) == sorted(want[mx]) == sorted(args)
    for dst, src in ((mt, mx), (mx, mt)):
        mods[dst].load_optimizer_states(str(tmp_path / src.__name__))
        got = states(dst)
        for k in want[src]:
            for a, b in zip(got[k], want[src][k]):
                np.testing.assert_array_equal(a, b, err_msg=k)
    _, plain = _mlp_fit(mt, None, x, y, args, str(tmp_path / "plain"))
    for k in args:
        np.testing.assert_array_equal(plain[k], params[mt][k], err_msg=k)


def test_feedforward_fit_through_a_local_store_matches_jax():
    """``FeedForward.fit(kvstore=kv.create('local'))`` goes through the
    same store wiring in both packages: equal weights (1e-6, the same
    float32 formulas; both shuffle with numpy's global generator, seeded
    alike) and the store holding them."""
    import warnings
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (24, 5)).astype('f')
    y = rng.randint(0, 3, 24).astype('f')
    args = {'fc1_weight': rng.normal(0, 0.5, (16, 5)).astype('f'),
            'fc1_bias': np.zeros(16, 'f'),
            'fc2_weight': rng.normal(0, 0.5, (3, 16)).astype('f'),
            'fc2_bias': np.zeros(3, 'f')}
    got = {}
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        np.random.seed(2)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            model = pkg.model.FeedForward(
                _mlp(pkg), ctx=pkg.cpu(), num_epoch=2, optimizer='sgd',
                learning_rate=0.1, momentum=0.9, numpy_batch_size=8,
                arg_params={k: pkg.nd.array(v) for k, v in args.items()})
            model.fit(x, y, kvstore=kv)
        got[pkg] = {k: v.asnumpy() for k, v in model.arg_params.items()}
        w = pkg.nd.zeros((16, 5))
        kv.pull('fc1_weight', out=w)
        np.testing.assert_array_equal(w.asnumpy(), got[pkg]['fc1_weight'])
    for k in args:
        np.testing.assert_allclose(got[mt][k], got[mx][k], rtol=1e-6,
                                   atol=1e-6, err_msg=k)
