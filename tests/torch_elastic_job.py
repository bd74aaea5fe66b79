"""One worker (or, with ``DMLC_ROLE=server``, one parameter server) of the
port's elastic-membership scenario on the CPU, for
``tests/test_torch_elastic_launch.py``; not collected.  The scenario of
``tests/dist/dist_elastic_membership.py`` with the port's package:

    python tools/launch.py --elastic -n 2 -s 2 \\
        --env MXNET_FI_KILL_PROCESS_AFTER=<N> --env MXNET_FI_ONLY_SERVER=<SID> \\
        --env MXT_KILL_SERVER=<SID> python tests/torch_elastic_job.py

Two workers train against two servers with one striped key (a row slice
on each server) and one small key per server; server ``MXT_KILL_SERVER``
(default 1) is REALLY SIGKILLed right after the last ack of round
``KILL_ROUND`` and the job must finish without a restart, its final
weights equal to the static roster's analytic golden bit for bit
(integer gradients, a power-of-two learning rate).  ``MXT_KILL_SERVER=0``
kills the coordinator (compose with ``MXNET_FI_ONLY_COORDINATOR=1``).
``MXT_PRINT_KILL_ACKS=1`` prints the kill point the wire arithmetic
gives (:func:`expected_kill_acks`) and exits."""
import os
import sys

os.environ.setdefault("MXNET_KVSTORE_ELASTIC", "1")
os.environ.setdefault("MXNET_KVSTORE_RETRY_MAX", "3")
os.environ.setdefault("MXNET_KVSTORE_RETRY_INITIAL_MS", "20")
os.environ.setdefault("MXNET_KVSTORE_RETRY_MAX_MS", "200")
os.environ.setdefault("MXNET_KVSTORE_HEARTBEAT_INTERVAL", "0.5")
os.environ.setdefault("MXNET_KVSTORE_HEARTBEAT_TIMEOUT", "2.0")
os.environ.setdefault("MXNET_KVSTORE_BIGARRAY_BOUND", "16")

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402

ROUNDS = 4
KILL_ROUND = 2          # the doomed server dies at the END of this round
KILL_SERVER = int(os.environ.get("MXT_KILL_SERVER", "1"))
LR = 0.125              # power of two: every update exact in fp32


def expected_kill_acks(nworker=2, kill_round=KILL_ROUND,
                       server=KILL_SERVER):
    """Enveloped replies the doomed server serves through the end of
    ``kill_round`` (the JAX package's arithmetic,
    ``tests/dist/dist_elastic_membership.py``): server 1 serves, per
    worker, init of its big stripe and small key and the set_optimizer
    barrier's flush, plus rank 0's optimizer command; then each round,
    per worker, two pushes, a flush, two pulls and a flush.  The
    coordinator also serves each worker's roster_join and every
    barrier's rendezvous."""
    if server == 0:
        setup = nworker * 5 + 1
        per_round = nworker * 8
    else:
        setup = nworker * 3 + 1
        per_round = nworker * 6
    return setup + per_round * kill_round


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import membership, profiler
    with mt.cpu():
        kv = mt.kv.create("dist_async")
        rank, nworker = kv.rank, kv.num_workers
        assert nworker == 2, nworker
        keys, i = {}, 0
        while len(keys) < 2:
            keys.setdefault(membership.server_index(f"k{i}", 2), f"k{i}")
            i += 1
        small0, small1 = keys[0], keys[1]
        big0 = np.arange(40, dtype=np.float32).reshape(10, 4)
        kv.init("big", mt.nd.NDArray(big0))
        kv.init(small0, mt.nd.zeros((2, 2)))
        kv.init(small1, mt.nd.zeros((2, 2)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=LR, momentum=0.0,
                                          wd=0.0, rescale_grad=1.0))
        out_big = mt.nd.zeros((10, 4))
        out_s = [mt.nd.zeros((2, 2)), mt.nd.zeros((2, 2))]
        grad = float(rank + 1)
        for _r in range(ROUNDS):
            kv.push("big", mt.nd.ones((10, 4)) * grad)
            kv.push(small0, mt.nd.ones((2, 2)) * grad)
            kv.push(small1, mt.nd.ones((2, 2)) * grad)
            kv.barrier()
            kv.pull("big", out=out_big)
            kv.pull(small0, out=out_s[0])
            kv.pull(small1, out=out_s[1])
            kv.barrier()
        counts = profiler.channel_counts()
        assert counts.get("kvstore.roster_bump", 0) >= 1, counts
        assert counts.get("kvstore.roster_generation", 0) >= 1, counts
        assert kv._roster_gen >= 1 and len(kv._conns) == 1, \
            (kv._roster_gen, len(kv._conns))
        assert profiler.channel_bytes().get("handoff", 0) > 0
        if KILL_SERVER == 0:
            assert kv._failovers >= 1, kv._failovers
            assert counts.get("kvstore.coordinator_failover_observed",
                              0) >= 1, counts
            assert counts.get("kvstore.coordinator_slot", None) == 1, counts
        total = ROUNDS * sum(r + 1 for r in range(nworker))
        np.testing.assert_array_equal(
            out_big.asnumpy(), big0 - LR * total,
            err_msg="striped key diverged from the static-roster run")
        for o in out_s:
            np.testing.assert_array_equal(
                o.asnumpy(), np.full((2, 2), -LR * total, np.float32),
                err_msg="small key diverged from the static-roster run")
        kv.barrier()
        kv.close(stop_servers=True)
        print("torch elastic rank %d/%d OK (roster gen %d, failovers %d)"
              % (rank, nworker, kv._roster_gen, kv._failovers), flush=True)


if __name__ == "__main__":
    if os.environ.get("MXT_PRINT_KILL_ACKS"):
        print(expected_kill_acks())
        sys.exit(0)
    if os.environ.get("DMLC_ROLE") == "server":
        import mxnet_tpu_torch  # noqa: F401  serves until stopped
        sys.exit(0)
    main()
