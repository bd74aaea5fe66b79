"""The port's single-process KVStore against the JAX package's: the local
cases of ``tests/test_kvstore.py`` through both packages, the store's
independence from its callers' arrays (torch tensors are mutable, JAX
arrays are not), and the distributed types as the JAX package makes
them (their stores are tested in ``test_torch_dist_kvstore.py``), with
the switches of elastic membership and the hierarchical tier raising,
naming ROADMAP E2.  The values are small integers and their
sums, exact in float32, so the comparisons are exact; SGD through the
store is the same formula in float32 (1e-6)."""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu.ndarray import sparse as jsp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ndarray import sparse as tsp
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (4, 4)
KEYS = [5, 7, 11]
STR_KEYS = ['b', 'c', 'd']
PKGS = (mx, mt)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with mt.cpu():
        yield


def _init_kv(pkg, keys=()):
    kv = pkg.kv.create('local')
    kv.init(3, pkg.nd.zeros(SHAPE))
    for k in keys:
        kv.init(k, pkg.nd.zeros(SHAPE))
    return kv


def _pulled(pkg, kv, key, shape=SHAPE):
    out = pkg.nd.zeros(shape)
    kv.pull(key, out=out)
    return out.asnumpy()


def test_single_kv_pair():
    for pkg in PKGS:
        for key in (3, 'a'):
            kv = pkg.kv.create('local')
            kv.init(key, pkg.nd.ones(SHAPE))
            np.testing.assert_array_equal(_pulled(pkg, kv, key), 1.0)


def test_push_aggregation():
    """A list of values for one key is summed (2, 3 and 4 copies)."""
    for pkg in PKGS:
        kv = _init_kv(pkg)
        for n in (2, 3, 4):
            kv.push(3, [pkg.nd.ones(SHAPE) * (i + 1) for i in range(n)])
            np.testing.assert_array_equal(_pulled(pkg, kv, 3),
                                          n * (n + 1) / 2)


def test_list_kv_pairs():
    for pkg in PKGS:
        for keys in (KEYS, STR_KEYS):
            kv = pkg.kv.create('local')
            for k in keys:
                kv.init(k, pkg.nd.zeros(SHAPE))
            kv.push(keys, [pkg.nd.ones(SHAPE) * 4] * len(keys))
            outs = [pkg.nd.zeros(SHAPE) for _ in keys]
            kv.pull(keys, out=outs)
            for o in outs:
                np.testing.assert_array_equal(o.asnumpy(), 4.0)


def test_updater_runs_on_push():
    """A custom updater gets (key, summed push, stored value); an integer
    key reaches it as an int, a name as itself."""
    for pkg in PKGS:
        updates = []

        def updater(key, recv, stored):
            updates.append(key)
            stored += recv * 2

        kv = _init_kv(pkg)
        kv.init('w', pkg.nd.zeros(SHAPE))
        kv._set_updater(updater)
        kv.push(3, pkg.nd.ones(SHAPE))
        np.testing.assert_array_equal(_pulled(pkg, kv, 3), 2.0)
        kv.push(3, [pkg.nd.ones(SHAPE)] * 3)
        np.testing.assert_array_equal(_pulled(pkg, kv, 3), 8.0)
        kv.push('w', pkg.nd.ones(SHAPE))
        assert updates == [3, 3, 'w']


def test_aggregator_then_default_updater():
    for pkg in PKGS:
        kv = _init_kv(pkg, KEYS)
        kv.push(KEYS, [[pkg.nd.ones(SHAPE)] * 2] * len(KEYS))
        outs = [pkg.nd.zeros(SHAPE) for _ in KEYS]
        kv.pull(KEYS, out=outs)
        for o in outs:
            np.testing.assert_array_equal(o.asnumpy(), 2.0)


def test_set_optimizer_applies_update():
    """SGD with momentum inside the store, three pushes: the pulled
    weights and the saved states equal the JAX package's."""
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, SHAPE).astype('f')
    grads = [rng.uniform(-1, 1, SHAPE).astype('f') for _ in range(3)]
    res = {}
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        kv.init('w', pkg.nd.array(w0))
        kv.set_optimizer(pkg.optimizer.SGD(learning_rate=0.5, momentum=0.9,
                                           wd=0.01))
        got = []
        for g in grads:
            kv.push('w', pkg.nd.array(g))
            got.append(_pulled(pkg, kv, 'w'))
        res[pkg] = got
    np.testing.assert_allclose(res[mt][0], w0 - 0.5 * (grads[0] + 0.01 * w0),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(res[mt], res[mx]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_optimizer_states_load_across_packages(tmp_path):
    """The store's ``save_optimizer_states`` file of each package loads
    into the other's store, and the port's into its own, value for value
    (a blob of numpy arrays pickled at protocol 2 carries its bytes
    through ``_codecs.encode``)."""
    w0 = np.arange(16, dtype='f').reshape(SHAPE) / 10
    kvs = {}
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        kv.init('w', pkg.nd.array(w0))
        kv.set_optimizer(pkg.optimizer.Adam(learning_rate=0.1))
        kv.push('w', pkg.nd.ones(SHAPE))
        kv.save_optimizer_states(str(tmp_path / pkg.__name__))
        kvs[pkg] = kv
    for dst, src in ((mt, mx), (mx, mt), (mt, mt)):
        kvs[dst].load_optimizer_states(str(tmp_path / src.__name__))
        got = [s.asnumpy() for s in kvs[dst]._updater.states['w']]
        want = [s.asnumpy() for s in kvs[src]._updater.states['w']]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(mt.MXNetError, match="no optimizer"):
        mt.kv.create('local').save_optimizer_states(str(tmp_path / "x"))


def test_row_sparse_pull():
    """Only the rows asked for, once each and sorted: into a dense out
    (zeros elsewhere) and into a RowSparseNDArray (re-armed in place,
    nothing dense built)."""
    dense = np.arange(12, dtype='float32').reshape(4, 3)
    rid = np.array([3, 1, 3.7], 'float32')
    for pkg, sp in ((mx, jsp), (mt, tsp)):
        kv = pkg.kv.create('local')
        kv.init('rs', pkg.nd.array(dense))
        out = pkg.nd.zeros((4, 3))
        kv.row_sparse_pull('rs', out=out, row_ids=pkg.nd.array(rid))
        got = out.asnumpy()
        np.testing.assert_array_equal(got[[1, 3]], dense[[1, 3]])
        np.testing.assert_array_equal(got[[0, 2]], 0.0)
        rsp = sp.row_sparse_array((np.zeros((1, 3), 'float32'),
                                   np.array([0])), shape=(4, 3))
        start = sp.DENSIFY_COUNT
        kv.row_sparse_pull('rs', out=[rsp], row_ids=pkg.nd.array(rid))
        np.testing.assert_array_equal(rsp.data.asnumpy(), dense[[1, 3]])
        np.testing.assert_array_equal(rsp.indices.asnumpy(), [1, 3])
        assert sp.DENSIFY_COUNT == start
    kv = mt.kv.create('local')
    kv.init('a@s0', mt.nd.zeros((2, 2)))
    with pytest.raises(mt.MXNetError, match="separator"):
        kv.row_sparse_pull('a@s0', out=mt.nd.zeros((2, 2)),
                           row_ids=mt.nd.array([0]))


def test_pull_into_out_array():
    for pkg in PKGS:
        kv = _init_kv(pkg)
        kv.push(3, pkg.nd.ones(SHAPE))
        np.testing.assert_array_equal(_pulled(pkg, kv, 3), 1.0)
        with pytest.raises(pkg.base.MXNetError):
            kv.pull(99, out=pkg.nd.zeros(SHAPE))
        with pytest.raises(pkg.base.MXNetError):
            kv.push(99, pkg.nd.zeros(SHAPE))


def test_kvstore_type_and_rank():
    for t in mt.kvstore.LOCAL_TYPES:
        kv = mt.kv.create(t)
        assert kv.type == t and kv.rank == 0 and kv.num_workers == 1
        assert kv.num_dead_nodes() == 0
        kv.barrier()
    for t in ('local', 'device'):
        kv = mx.kv.create(t)
        assert kv.rank == 0 and kv.num_workers == 1
    assert mt.kvstore is mt.kv
    with pytest.raises(TypeError):
        mt.kv.create(3)
    with pytest.raises(mt.MXNetError, match="unknown"):
        mt.kv.create('bogus')
    with pytest.raises(mt.MXNetError, match="gpu"):
        mt.kv.create('tpu')


def _free_port():
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("name", ["dist_async", "dist_sync",
                                  "dist_device_sync", "dist"])
def test_distributed_types_raise_naming_e1(name, monkeypatch):
    """E1 made these types: ``create`` gives what the JAX package's
    gives (``dist_async`` without servers raises, naming the launcher,
    in both), a Trainer takes the type by name, and what is still left
    to E2 (the hierarchical tier) comes up as a group leader, and
    refuses without the host topology or beside elastic membership, as
    in the JAX package; under ``MXNET_KVSTORE_ELASTIC`` the store joins
    an elastic server's roster (E2's elastic half)."""
    monkeypatch.delenv("MXT_SERVER_URIS", raising=False)
    if name == "dist_async":
        for pkg in PKGS:
            with pytest.raises(pkg.base.MXNetError, match="launch"):
                pkg.kv.create(name)
        # the hierarchical tier (E2) comes up: a group leader binds its
        # in-host endpoint, as in the JAX package; without the host
        # topology both packages refuse, naming the launcher's flag
        monkeypatch.setenv("MXNET_KVSTORE_HIERARCHY", "1")
        srv = mt.kvstore_server.KVStoreServer(num_workers=2)
        srv.start_background()
        for pkg in PKGS:
            with mt.cpu(), pytest.raises(pkg.base.MXNetError,
                                         match="workers-per-host"):
                pkg.kv.KVStoreDistAsync(uris=f"127.0.0.1:{srv.port}")
        monkeypatch.setenv("MXNET_KVSTORE_WORKERS_PER_HOST", "2")
        monkeypatch.setenv("DMLC_NUM_WORKER", "2")
        monkeypatch.setenv("MXT_MESH_URIS", f"127.0.0.1:{_free_port()}")
        try:
            with mt.cpu():
                kv = mt.kv.KVStoreDistAsync(uris=f"127.0.0.1:{srv.port}",
                                            rank=0)
                assert kv._hier and kv._mesh_leader is not None
                assert kv._mesh_group == (0, 1)
                kv.close()
        finally:
            srv.stop()
        monkeypatch.delenv("MXNET_KVSTORE_WORKERS_PER_HOST")
        monkeypatch.delenv("DMLC_NUM_WORKER")
        monkeypatch.delenv("MXT_MESH_URIS")
        # ... but not with elastic membership, in either package
        monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
        for pkg in PKGS:
            srv = pkg.kvstore_server.KVStoreServer(elastic=True)
            srv._roster_servers = [f"127.0.0.1:{srv.port}"]
            srv.start_background()
            try:
                with mt.cpu():
                    with pytest.raises(pkg.base.MXNetError,
                                       match="HIERARCHY"):
                        pkg.kv.KVStoreDistAsync(
                            uris=f"127.0.0.1:{srv.port}")
            finally:
                srv.stop()
        monkeypatch.delenv("MXNET_KVSTORE_ELASTIC")
        monkeypatch.delenv("MXNET_KVSTORE_HIERARCHY")
        monkeypatch.setenv("MXNET_KVSTORE_ELASTIC", "1")
        srv = mt.kvstore_server.KVStoreServer(elastic=True)
        srv.start_background()
        try:
            with mt.cpu():
                kv = mt.kv.KVStoreDistAsync(uris=f"127.0.0.1:{srv.port}")
                assert kv._elastic and kv._roster_member
                assert kv._roster_servers == [srv.uri]
                assert kv.num_workers == 1
                kv.close(stop_servers=True)
        finally:
            srv.stop()
        monkeypatch.delenv("MXNET_KVSTORE_ELASTIC")
    else:
        for pkg in PKGS:
            kv = pkg.kv.create(name)
            assert kv.type == name and kv.rank == 0 \
                and kv.num_workers == 1
    mt.gluon.Trainer([], 'sgd', kvstore=name)


def test_init_duplicate_key_raises():
    for pkg in PKGS:
        kv = pkg.kv.create('local')
        kv.init(9, pkg.nd.zeros(SHAPE))
        with pytest.raises(pkg.base.MXNetError, match="duplicate"):
            kv.init(9, pkg.nd.zeros(SHAPE))


def test_assign_bypasses_updater():
    for pkg in PKGS:
        kv = _init_kv(pkg)
        applied = []
        kv._set_updater(lambda key, recv, stored: applied.append(key))
        kv.assign(3, pkg.nd.ones(SHAPE) * 7)
        kv.assign('fresh_key', pkg.nd.ones((2,)) * 3)   # no init needed
        np.testing.assert_array_equal(_pulled(pkg, kv, 3), 7.0)
        np.testing.assert_array_equal(_pulled(pkg, kv, 'fresh_key', (2,)),
                                      3.0)
        assert applied == []


def test_set_gradient_compression_validation():
    """A local store refuses compression, as in the JAX package and the
    reference; the other types record a validated setting (only
    ``dist_async`` has a wire to compress); ``server_stats`` of a local
    store is the process's profiler snapshot, as in the JAX package."""
    with pytest.raises(mx.base.MXNetError, match="not supported"):
        mx.kv.create('local').set_gradient_compression({'type': '2bit'})
    with pytest.raises(mt.MXNetError, match="not supported"):
        mt.kv.create('local').set_gradient_compression({'type': '2bit'})
    for t in ('device', 'nccl', 'dist_sync'):
        for pkg in PKGS:
            kv = pkg.kv.create(t)
            kv.set_gradient_compression({'type': '2bit', 'threshold': 0.25})
            assert (kv._gcompress.type, kv._gcompress.threshold) == \
                ('2bit', 0.25)
            with pytest.raises(pkg.base.MXNetError, match="threshold"):
                kv.set_gradient_compression({'type': '2bit',
                                             'threshold': 0.0})
    assert set(mt.kv.create('local').server_stats()) == \
        set(mx.kv.create('local').server_stats())


def test_store_never_shares_a_tensor_with_its_caller():
    """Changing the source in place after ``init``, ``assign`` or a push
    without an updater, or the out array after ``pull``, leaves the
    store as it was."""
    kv = mt.kv.create('local')
    src = mt.nd.ones(SHAPE)
    kv.init('w', src)
    src.as_torch().add_(5)
    np.testing.assert_array_equal(_pulled(mt, kv, 'w'), 1.0)
    out = mt.nd.zeros(SHAPE)
    kv.pull('w', out=out)
    out.as_torch().mul_(0)
    np.testing.assert_array_equal(_pulled(mt, kv, 'w'), 1.0)
    for store in (lambda v: kv.push('w', v), lambda v: kv.assign('w', v)):
        v = mt.nd.ones(SHAPE) * 2
        store(v)
        v.as_torch().add_(1)
        np.testing.assert_array_equal(_pulled(mt, kv, 'w'), 2.0)
    rsp = tsp.zeros('row_sparse', SHAPE)
    kv.row_sparse_pull('w', out=rsp, row_ids=mt.nd.array([1]))
    rsp.data.as_torch().add_(1)
    np.testing.assert_array_equal(_pulled(mt, kv, 'w'), 2.0)
