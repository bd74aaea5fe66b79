"""The port's row-sparse ``dist_async`` wire against the JAX package's: the
non-elastic cases of ``tests/test_sparse_dist.py`` through both
packages.  Only touched rows ride the wire: a striped 2-server embedding
at 1% touch density moves <= 5% of the dense run's push bytes (the same
bytes in both packages: the same frames) and reaches the table the
dense run and the JAX package reach, bit for bit (dyadic gradients,
plain SGD at a power-of-two rate: exact in float32); 2-bit compression
keeps its residuals per GLOBAL row id on the host and drains them
exactly; the density cutover, a server refusing a contradictory
payload, a typed KeyError for an unknown key, the reserved separator and
the fp16 wire."""
import numpy as np
import pytest

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.compression import RowSparsePayload
from mxnet_tpu_torch.kvstore import _await
from torch_dist import PKGS, cluster, nd, pulled, zeros
import torch_threads  # noqa: F401,E402  a worker's share of the cores

VOCAB, DIM = 400, 32


def _sgd(pkg, lr=0.5):
    return pkg.optimizer.SGD(learning_rate=lr, momentum=0.0, wd=0.0,
                             rescale_grad=1.0)


def _rsp(pkg, vals, ids, shape):
    return pkg.nd.sparse.row_sparse_array(
        (np.asarray(vals, np.float32), np.asarray(ids, np.int64)),
        shape=shape)


def _grad_rounds(nrounds=6, touch=4):
    rng = np.random.RandomState(7)
    rounds = []
    for _ in range(nrounds):
        ids = np.sort(rng.choice(VOCAB, size=touch,
                                 replace=False)).astype(np.int64)
        vals = (rng.randint(-8, 8, (touch, DIM)) / 4.0).astype(np.float32)
        rounds.append((ids, vals))
    return rounds


def _run_embedding(pkg, monkeypatch, sparse_wire, rounds):
    # no heartbeat socket: its codec hello's reply counts as "sent" on an
    # in-process server whenever it lands, and the bytes are compared
    with cluster(pkg, monkeypatch, n=2, MXNET_KVSTORE_BIGARRAY_BOUND=64,
                 MXNET_KVSTORE_SPARSE=int(sparse_wire),
                 MXNET_KVSTORE_HEARTBEAT_INTERVAL=0):
        kv = pkg.kv.create("dist_async")
        kv.init("emb", zeros(pkg, (VOCAB, DIM)))
        kv.set_optimizer(_sgd(pkg))
        kv._flush_all()
        rows0 = pkg.profiler.channel_counts().get("kvstore.sparse_rows", 0)
        b0 = pkg.profiler.wire_bytes_total()
        for ids, vals in rounds:
            kv.push("emb", _rsp(pkg, vals, ids, (VOCAB, DIM)))
        kv._flush_all()
        push_bytes = pkg.profiler.wire_bytes_total() - b0
        rows = pkg.profiler.channel_counts().get("kvstore.sparse_rows",
                                                 0) - rows0
        table = pulled(pkg, kv, "emb", (VOCAB, DIM))
        kv.close(stop_servers=True)
        return table, push_bytes, rows


def test_sparse_wire_bytes_tiny_fraction_of_dense_bit_identical_table(
        monkeypatch):
    rounds = _grad_rounds()
    t_sparse, b_sparse, rows = _run_embedding(mt, monkeypatch, True, rounds)
    t_dense, b_dense, _ = _run_embedding(mt, monkeypatch, False, rounds)
    t_jax, b_jax, rows_jax = _run_embedding(PKGS["jax"], monkeypatch, True,
                                            rounds)
    assert 0 < b_sparse <= 0.05 * b_dense, (b_sparse, b_dense)
    assert b_sparse == b_jax and rows == rows_jax == sum(
        ids.size for ids, _ in rounds)
    golden = np.zeros((VOCAB, DIM), np.float32)
    for ids, vals in rounds:
        golden[ids] -= np.float32(0.5) * vals
    for t in (t_sparse, t_dense, t_jax):
        np.testing.assert_array_equal(t, golden)


def test_sparse_2bit_per_row_residuals_drain_exact(monkeypatch):
    """A 0.25 gradient under a 0.5 threshold parks in the residual bank
    (keyed by GLOBAL row id though the wire carries stripe-local ids);
    the next push drains it into one quantum; equal to the JAX
    package's tables and banks."""
    def scenario(pkg):
        kv = pkg.kv.create("dist_async")
        kv.init("emb", zeros(pkg, (10, 4)))
        kv.set_optimizer(_sgd(pkg, lr=1.0))
        assert kv._stripe_plan("emb", (10, 4)) == [0, 5, 10]
        ids = np.array([1, 7], np.int64)
        grad = _rsp(pkg, np.full((2, 4), 0.25), ids, (10, 4))
        got = []
        for _ in range(3):
            kv.push("emb", grad)
            bank = kv._sparse_residual["emb"]
            got.append({int(k): np.asarray(v) for k, v in bank.items()})
            kv.push("emb", grad)
            got.append(pulled(pkg, kv, "emb", (10, 4)))
        kv.close(stop_servers=True)
        return got
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch, n=2, MXNET_KVSTORE_BIGARRAY_BOUND=16,
                     MXNET_KVSTORE_COMPRESSION="2bit",
                     MXNET_KVSTORE_COMPRESSION_THRESHOLD=0.5):
            got[name] = scenario(pkg)
    for k, (a, b) in enumerate(zip(got["jax"], got["port"])):
        if isinstance(a, dict):
            assert set(a) == set(b) == {1, 7}
            for r in a:
                np.testing.assert_array_equal(a[r], b[r])
                np.testing.assert_array_equal(b[r], 0.25)
        else:
            np.testing.assert_array_equal(a, b)
            assert b[1, 0] == b[7, 0] == -0.5 * (k // 2 + 1)


@pytest.mark.parametrize("case", ["cutover", "fp16"])
def test_density_cutover_and_fp16_wire(monkeypatch, case):
    """A 90%-touched push goes dense (no sparse rows banked) and lands
    the same update; fp16 halves the sparse value block and values
    exact in fp16 round-trip; equal to the JAX package's."""
    env = {"MXNET_KVSTORE_SPARSE_DENSITY_CUTOVER": 0.5} if case == \
        "cutover" else {"MXNET_KVSTORE_COMPRESSION": "fp16"}
    ids = np.arange(9) if case == "cutover" else np.array([2, 9])
    val = 1.0 if case == "cutover" else 0.5
    got = {}
    for name, pkg in PKGS.items():
        with cluster(pkg, monkeypatch, **env):
            kv = pkg.kv.create("dist_async")
            kv.init("w", zeros(pkg, (10, 4)))
            kv.set_optimizer(_sgd(pkg, lr=1.0))
            r0 = pkg.profiler.channel_counts().get("kvstore.sparse_rows", 0)
            kv.push("w", _rsp(pkg, np.full((ids.size, 4), val), ids,
                              (10, 4)))
            got[name] = (pulled(pkg, kv, "w", (10, 4)),
                         pkg.profiler.channel_counts().get(
                             "kvstore.sparse_rows", 0) - r0)
            kv.close(stop_servers=True)
    golden = np.zeros((10, 4), np.float32)
    golden[ids] = -val
    for name in got:
        np.testing.assert_array_equal(got[name][0], golden)
    assert got["port"][1] == got["jax"][1] == (0 if case == "cutover"
                                               else 2)


def test_server_rejects_mismatched_rowsparse_push_and_keeps_serving(
        monkeypatch):
    with cluster(mt, monkeypatch):
        kv = mt.kv.create("dist_async")
        kv.init("w", zeros(mt, (10, 4)))
        conn = kv._conn_of("w")
        bad = RowSparsePayload(np.array([1], np.int64), 99,
                               np.ones((1, 4), np.float32))
        with pytest.raises(mt.MXNetError, match="declares 99 rows"):
            _await(conn.request(("push", "w", bad)))
        badrow = RowSparsePayload(np.array([1], np.int64), 10,
                                  np.ones((1, 3), np.float32))
        with pytest.raises(mt.MXNetError, match="row-sparse"):
            _await(conn.request(("push", "w", badrow)))
        np.testing.assert_array_equal(pulled(mt, kv, "w", (10, 4)), 0.0)
        kv.close(stop_servers=True)


def test_pull_rowsparse_unknown_key_raises_typed_keyerror(monkeypatch):
    with cluster(mt, monkeypatch):
        kv = mt.kv.create("dist_async")
        kv.init("known", zeros(mt, (4, 2)))
        out = mt.nd.sparse.zeros('row_sparse', (4, 2))
        with pytest.raises(KeyError, match="uninitialized key 'nope'"):
            kv.row_sparse_pull("nope", out=out,
                               row_ids=nd(mt, [0, 1], np.int64))
        kv.row_sparse_pull("known", out=out,
                           row_ids=nd(mt, [1, 3], np.int64))
        np.testing.assert_array_equal(out.indices.asnumpy(), [1, 3])
        np.testing.assert_array_equal(out.data.asnumpy(), 0.0)
        kv.close(stop_servers=True)


def test_row_sparse_user_keys_reject_stripe_separator(monkeypatch):
    local = mt.kv.create("local")
    with mt.cpu():
        local.init("ok", zeros(mt, (4, 2)))
        out = mt.nd.sparse.zeros('row_sparse', (4, 2))
        with pytest.raises(mt.MXNetError,
                           match="reserved stripe separator"):
            local.row_sparse_pull("bad@s0", out=out,
                                  row_ids=nd(mt, [0], np.int64))
    with cluster(mt, monkeypatch):
        kv = mt.kv.create("dist_async")
        kv.init("ok", zeros(mt, (4, 2)))
        with pytest.raises(mt.MXNetError,
                           match="reserved stripe separator"):
            kv.row_sparse_pull("bad@s0", out=out,
                               row_ids=nd(mt, [0], np.int64))
        kv.close(stop_servers=True)
