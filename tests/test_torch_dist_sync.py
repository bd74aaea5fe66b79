"""Real multi-process runs of the port's distributed plane on the CPU,
each through ``tools/launch.py --launcher local`` under a time limit of
its own (the process group is killed on timeout):

* ``dist_sync`` over gloo in two worker processes
  (``tests/torch_dist_sync_job.py``): rank 0's init wins, a push is the
  rank-order sum, bit-identical on both ranks and equal to the JAX
  package's single-process sum of the same values; a tiny LM trained by
  ``Module.fit(kvstore='dist_sync')`` ends bit-identical on both ranks
  and close to one process trained on the concatenated batch: the
  gradient is summed in another order (two per-rank sums of two
  examples, then their sum, against one sum of four), which moves SGD's
  weights by float32 rounding (3.0e-8 measured, held to 1e-7) and
  Adam's by more (1.2e-5 measured, held to 5e-5; 6.4e-6 of the update's
  norm, held to 1e-4), since Adam divides an element's step by the root
  mean square of its gradient, so an element whose gradient is near zero
  turns a rounding difference into a step difference of up to the
  learning rate; and a wrong reduction (one rank's half batch alone) is
  far outside: 0.93 of the update's norm with Adam, 0.74 with SGD
  (required above 0.2: ``chip_smoke.py``'s dist_sync update gate,
  2.5e-2 of the norm, lies between the two);
* ``dist_async`` with two parameter-server processes of the port
  (``DMLC_ROLE=server``: importing the package serves) and a worker
  pushing 2-bit compressed gradients.

And the single-process degradation of the ``distributed`` API."""
import os
import sys

import numpy as np
import pytest

import mxnet_tpu as mx
import mxnet_tpu.distributed  # noqa: F401  mx.distributed
import mxnet_tpu_torch as mt
from torch_dist import ROOT, launch
import torch_threads  # noqa: F401,E402  a worker's share of the cores

sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_dist_sync_job as job  # noqa: E402

# float32 gradient sums in another order (see the module docstring)
SYNC_VS_SINGLE_ATOL = {"sgd": 1e-7, "adam": 5e-5}
SYNC_VS_SINGLE_NORM = 1e-4
WRONG_REDUCTION_NORM_MIN = 0.2


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_dist_sync_two_processes_agree_and_match_the_jax_sum(tmp_path,
                                                             optimizer):
    out = launch(2, [os.path.join(ROOT, "tests", "torch_dist_sync_job.py"),
                     str(tmp_path)], timeout=240,
                 env_extra={"OMP_NUM_THREADS": "1",
                            "OPTIMIZER": optimizer})
    for r in range(2):
        assert f"rank {r}/2 OK" in out
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for k in ranks[0]:
        assert ranks[0][k].tobytes() == ranks[1][k].tobytes(), k
    np.testing.assert_array_equal(ranks[0]["init"], 1.0)
    vals = [np.random.RandomState(100 + r).randn(5, 7).astype(np.float32)
            for r in range(2)]
    jkv = mx.kv.create("local")
    jkv.init("g", mx.nd.zeros((5, 7)))
    jkv.push("g", [mx.nd.array(v) for v in vals])
    want = mx.nd.zeros((5, 7))
    jkv.pull("g", out=want)
    assert ranks[0]["sum"].tobytes() == want.asnumpy().tobytes()
    assert int(ranks[0]["allgather_bytes"]) == 5 * 7 * 4

    # one process on the concatenated batch, and on rank 0's half alone
    # (what a missing reduction would give)
    net, params = job.lm_params()
    x, y = job.lm_data()

    def single(rows, batch, rescale):
        with mt.cpu():
            it = mt.io.NDArrayIter({"data": x[rows]},
                                   {"softmax_label": y[rows]},
                                   batch_size=batch)
            mod = mt.mod.Module(net, context=mt.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params(arg_params={k: mt.nd.array(v)
                                        for k, v in params.items()})
            mod.fit(it, num_epoch=1, optimizer=optimizer,
                    optimizer_params={"learning_rate": job.LR,
                                      "rescale_grad": rescale})
            return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}

    def update_distance(a, b):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
        den = sum(float(((b[k] - params[k]) ** 2).sum()) for k in b)
        return (num / den) ** 0.5
    want = single(np.arange(len(x)), job.GLOBAL_BATCH, 1 / job.GLOBAL_BATCH)
    got = {k: ranks[0]["param:" + k] for k in want}
    worst = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    assert worst <= SYNC_VS_SINGLE_ATOL[optimizer], worst
    assert update_distance(got, want) <= SYNC_VS_SINGLE_NORM
    wrong = single(job.rank_rows(0, 2), job.GLOBAL_BATCH // 2,
                   1 / job.GLOBAL_BATCH)
    assert update_distance(wrong, want) > WRONG_REDUCTION_NORM_MIN


ASYNC_JOB = """
import numpy as np, mxnet_tpu_torch as mt
with mt.cpu():
    kv = mt.kv.create("dist_async")
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    kv.init("w", mt.nd.zeros((40, 30)))
    kv.set_optimizer(mt.optimizer.SGD(learning_rate=1.0, momentum=0.0,
                                      wd=0.0, rescale_grad=1.0))
    g = np.full((40, 30), 0.3, np.float32)
    for _ in range(3):
        kv.push("w", mt.nd.array(g))
    o = mt.nd.zeros((40, 30))
    kv.pull("w", out=o)
    servers = [kv.server_stats(i)["server"] for i in range(2)]
    stripes = [d["device"] for d in servers]
    assert not any(d["cuda_initialized"] for d in servers)
    assert (o.asnumpy() == -0.5).all(), o.asnumpy()[0, :4]
    assert kv._stripe_plan("w", (40, 30)) == [0, 20, 40]
    kv.close(stop_servers=True)
    print("async OK", stripes, flush=True)
"""


def test_dist_async_with_port_server_processes():
    """Two server processes of the port (the launcher's DMLC_ROLE=server
    contract) and one worker: 0.3 pushed three times under a 0.5
    threshold fires once (0.3, 0.6 -> 0.1, 0.4), so SGD at rate 1 leaves
    -0.5; the servers keep their store on the host; the job ends."""
    out = launch(1, ["-c", ASYNC_JOB], timeout=180, servers=2,
                 env_extra={"MXNET_KVSTORE_BIGARRAY_BOUND": "100",
                            "OMP_NUM_THREADS": "1"})
    assert "async OK ['cpu', 'cpu']" in out


def test_distributed_api_single_process(monkeypatch):
    """Without initialize(): rank 0 of 1, sums and broadcasts are the
    value, no dead node, a dist_sync store of one process, in both
    packages.  No dist_async store is open here: a store another test in
    the same worker left unreclaimed would report its own roster
    generation, so each package's registry of open stores starts empty."""
    for pkg in (mx, mt):
        d = pkg.distributed
        monkeypatch.setattr(d, "_dead_node_sources", [])
        assert d.rank() == 0 and d.size() == 1
        assert d.num_dead_nodes() == 0
        assert d.roster_generation() == 0 == d.coordinator_failovers()
        np.testing.assert_array_equal(d.allreduce_sum(np.ones(3)),
                                      np.ones(3))
        np.testing.assert_array_equal(d.broadcast_from_root(np.ones(2)),
                                      np.ones(2))
        kv = pkg.kv.create("dist_sync")
        assert kv.rank == 0 and kv.num_workers == 1
        kv.barrier()
        stats = d.cluster_stats(compact=True)
        assert set(stats) == {"workers", "servers", "stats_bank"}
    # the verdict reads the process's health state, which other tests in
    # the same worker may have degraded: its shape is what is held here
    health = mt.distributed.cluster_health()
    assert set(health) == {"status", "nodes", "dead", "stale",
                           "num_dead_nodes"}
    assert health["status"] in ("OK", "DEGRADED", "CRITICAL")
    assert health["num_dead_nodes"] == 0
