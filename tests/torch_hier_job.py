"""One worker of the port's hierarchical-tier job (not collected): the
JAX package's ``tests/dist/dist_hier_smoke.py`` scenario with the port's
package, on the CPU.

Run via:  python tools/launch.py -n 2 -s 1 --workers-per-host 2 \\
              --launcher local python tests/torch_hier_job.py

Two workers of ONE host group train a linear head (MakeLoss over a
FullyConnected without bias: a gradient constant in the weights, the
integer column sums of the data) with SGD at a power-of-two rate through
``Module.run_steps``' chunked driver, once flat (every worker pushes over
the TCP wire) and once under the tier the launcher armed (the follower
hands its gradient to the leader, which ships the sum).  Both runs must
land EXACTLY on the analytic golden.  The server's own byte counters
show the tier's wire traffic at most 60% of the flat run's; the follower
pushed no gradient over the wire, and its bytes rode the shm lane
(``shm_*``) or, with ``MXNET_KVSTORE_SHM=0``, the loopback socket
(``ici_*``).  With ``MXNET_FI_SHM_WEDGE_AFTER`` the leader stops draining
the ring mid-run: the follower must record a ``kvstore.shm_fallback`` and
every step must still land on the golden.  A server is the same command
with ``DMLC_ROLE=server``."""
import os
import sys

os.environ.setdefault("MXNET_KVSTORE_RETRY_INITIAL_MS", "20")
os.environ.setdefault("MXNET_KVSTORE_RETRY_MAX_MS", "200")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

K = 8
CHUNK = 2
BATCH = 64
NIN = 128
NH = 64
LR = 0.125              # power of two: every update exact in fp32
NWORKER = int(os.environ.get("DMLC_NUM_WORKER", "2"))


def rank_data(rank):
    rs = np.random.RandomState(100 + rank)
    return rs.randint(-1, 2, (K, BATCH, NIN)).astype(np.float32)


def init_weight():
    rs = np.random.RandomState(0)
    return rs.randint(-2, 3, (NH, NIN)).astype(np.float32)


def golden():
    """W0 - lr x every rank's every step's gradient: exact dyadics, so
    the flat run's two applies and the tier's one summed apply land on
    the same bits."""
    w = init_weight().copy()
    for r in range(NWORKER):
        data = rank_data(r)
        for s in range(K):
            g = np.tile(data[s].sum(axis=0), (NH, 1)).astype(np.float32)
            w = w - np.float32(LR) * g
    return w


def make_module(mt, tag):
    data = mt.sym.Variable('data')
    net = mt.sym.FullyConnected(data, num_hidden=NH, no_bias=True,
                                name=f'fc_{tag}')
    sym = mt.sym.MakeLoss(net, name=f'loss_{tag}')
    mod = mt.mod.Module(sym, data_names=('data',), label_names=None,
                        context=mt.cpu())
    mod.bind(data_shapes=[('data', (BATCH, NIN))])
    mod.init_params(
        arg_params={f'fc_{tag}_weight': mt.nd.array(init_weight())})
    mod.init_optimizer(
        kvstore='dist_async', optimizer='sgd',
        optimizer_params={'learning_rate': LR, 'momentum': 0.0,
                          'wd': 0.0, 'rescale_grad': 1.0})
    return mod


def server_wire_bytes(kv):
    """The server's own transport byte total (its ("stats",) reply)."""
    st = kv.server_stats(0)
    return sum(v for k, v in st.get("channel_bytes", {}).items()
               if not k.startswith("ici_"))


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import profiler, shmlane
    rank = int(os.environ.get("DMLC_WORKER_ID", "0"))
    data = rank_data(rank)
    os.environ["MXNET_KVSTORE_FUSED_CHUNK"] = str(CHUNK)
    os.environ["MXNET_KVSTORE_FUSED_STALENESS"] = "1"
    assert os.environ.get("MXT_MESH_URIS"), \
        "launch with tools/launch.py --workers-per-host 2"
    assert os.environ.get("MXNET_KVSTORE_HIERARCHY") == "1"
    with mt.cpu():
        # both modules first: the tier's store binds or dials its mesh
        # endpoint when it is made
        os.environ["MXNET_KVSTORE_HIERARCHY"] = "0"
        mod_f = make_module(mt, "f")
        os.environ["MXNET_KVSTORE_HIERARCHY"] = "1"
        mod_h = make_module(mt, "h")
        kv = mod_f._kvstore
        assert mod_h._kvstore._hier, "the tier did not arm"
        assert (mod_h._kvstore._mesh_leader is not None) is (rank == 0)

        kv.barrier()
        b0 = server_wire_bytes(kv)
        mod_f.run_steps(data, k=K)
        kv.barrier()
        b1 = server_wire_bytes(kv)

        ici0 = profiler.ici_bytes_total()
        ici_pay0 = profiler.ici_payload_bytes_total()
        shm0 = profiler.shm_bytes_total()
        sent0 = profiler.channel_bytes().get("sent", 0)
        mod_h.run_steps(data, k=K)
        kv.barrier()
        b2 = server_wire_bytes(kv)
        ici_d = profiler.ici_bytes_total() - ici0
        ici_pay_d = profiler.ici_payload_bytes_total() - ici_pay0
        shm_d = profiler.shm_bytes_total() - shm0
        sent_d = profiler.channel_bytes().get("sent", 0) - sent0

        want = golden()
        for tag, m in (("f", mod_f), ("h", mod_h)):
            out = mt.nd.zeros((NH, NIN))
            m._kvstore.pull(f'fc_{tag}_weight', out=out)
            np.testing.assert_array_equal(
                out.asnumpy(), want,
                err_msg=f"run {tag!r} diverged from the analytic golden")

        flat_bytes, hier_bytes = b1 - b0, b2 - b1
        assert hier_bytes < 0.6 * flat_bytes, (hier_bytes, flat_bytes)
        payload = NH * NIN * 4
        mesh_host = os.environ["MXT_MESH_URIS"].split(",")[0] \
            .rsplit(":", 1)[0]
        lane_on = shmlane.client_enabled(mesh_host)
        wedged = bool(os.environ.get("MXNET_FI_SHM_WEDGE_AFTER"))
        if rank == 0:
            assert ici_d + shm_d > 0, "the leader served no in-host traffic"
            if lane_on and not wedged:
                assert shm_d > 0, "lane armed but no bytes rode the ring"
        elif wedged:
            fb = profiler.channel_counts().get("kvstore.shm_fallback", 0)
            assert fb >= 1, "wedged drain but no shm_fallback recorded"
            assert sent_d < K * payload, (sent_d, K * payload)
        elif lane_on:
            assert shm_d > K * payload, (shm_d, K * payload)
            assert ici_pay_d < payload, (ici_pay_d, payload)
            assert sent_d < K * payload, (sent_d, K * payload)
        else:
            assert ici_d > K * payload, (ici_d, K * payload)
            assert sent_d < K * payload, (sent_d, K * payload)

        kv.barrier()
        mod_h._kvstore.close()
        mod_f._kvstore.close(stop_servers=(rank == 0))
    print("torch hier rank %d/%d OK (golden exact; wire %db -> %db, ici "
          "%db, shm %db%s)" % (rank, NWORKER, flat_bytes, hier_bytes, ici_d,
                               shm_d, ", wedge->tcp fallback"
                               if wedged and rank else ""), flush=True)


if __name__ == "__main__":
    if os.environ.get("DMLC_ROLE") == "server":
        import mxnet_tpu_torch  # noqa: F401  serves until stopped
        sys.exit(0)
    main()
