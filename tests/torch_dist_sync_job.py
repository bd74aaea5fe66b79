"""One worker of a ``dist_sync`` job of the port on the CPU (gloo), for
``tests/test_torch_dist_sync.py``; not collected.  Run as

    python tools/launch.py -n 2 --launcher local \\
        python tests/torch_dist_sync_job.py OUTDIR

Each rank joins the gloo group from the DMLC_* variables, checks the
store's init (rank 0 wins) and a push of rank-seeded values, then trains
a tiny LM through ``Module.fit(kvstore='dist_sync')`` on its half of
each global batch, with the optimizer ``OPTIMIZER`` names (sgd or adam,
default adam), and writes what it saw to ``OUTDIR/rank<r>.npz``."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import mxnet_tpu_torch as mt  # noqa: E402

LM = dict(vocab_size=50, seq_len=16, num_layers=2, d_model=32, num_heads=4)
GLOBAL_BATCH, STEPS, LR = 4, 3, 1e-2
OPTIMIZER = os.environ.get("OPTIMIZER", "adam")


def lm_data():
    rng = np.random.RandomState(42)
    x = rng.randint(0, LM["vocab_size"], (STEPS * GLOBAL_BATCH,
                                          LM["seq_len"])).astype(np.int32)
    y = rng.randint(0, LM["vocab_size"], x.shape).astype(np.int32)
    return x, y


def lm_params():
    net = mt.models.transformer_lm(**LM)
    shapes = dict(zip(net.list_arguments(), net.infer_shape(
        data=(1, LM["seq_len"]), softmax_label=(1, LM["seq_len"]))[0]))
    rng = np.random.RandomState(7)
    return net, {n: (rng.randn(*s) * 0.1).astype(np.float32)
                 for n, s in shapes.items()
                 if n not in ("data", "softmax_label")}


def rank_rows(rank, world):
    """The rows of ``lm_data()`` this rank trains on: its slice of each
    global batch."""
    per = GLOBAL_BATCH // world
    return np.concatenate([np.arange(s * GLOBAL_BATCH + rank * per,
                                     s * GLOBAL_BATCH + (rank + 1) * per)
                           for s in range(STEPS)])


def main(outdir):
    mt.distributed.initialize()
    rank, world = mt.distributed.rank(), mt.distributed.size()
    assert world == int(os.environ["DMLC_NUM_WORKER"])
    out = {}
    with mt.cpu():
        kv = mt.kv.create("dist_sync")
        assert kv.rank == rank and kv.num_workers == world
        kv.init("w", mt.nd.array(np.full((3, 4), rank + 1, np.float32)))
        o = mt.nd.zeros((3, 4))
        kv.pull("w", out=o)
        out["init"] = o.asnumpy()
        vals = np.random.RandomState(100 + rank).randn(5, 7).astype(
            np.float32)
        kv.init("g", mt.nd.zeros((5, 7)))
        mt.profiler.reset_channel_bytes()
        kv.push("g", mt.nd.array(vals))
        o = mt.nd.zeros((5, 7))
        kv.pull("g", out=o)
        out["sum"] = o.asnumpy()
        out["allgather_bytes"] = np.int64(
            mt.profiler.channel_bytes().get("allgather", 0))
        kv.barrier()

    net, params = lm_params()
    x, y = lm_data()
    rows = rank_rows(rank, world)
    it = mt.io.NDArrayIter({"data": x[rows]}, {"softmax_label": y[rows]},
                           batch_size=GLOBAL_BATCH // world)
    mod = mt.mod.Module(net, context=mt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in params.items()})
    mod.fit(it, num_epoch=1, kvstore="dist_sync", optimizer=OPTIMIZER,
            optimizer_params={"learning_rate": LR},
            eval_metric=mt.metric.CrossEntropy())
    args, _ = mod.get_params()
    for k, v in args.items():
        out["param:" + k] = v.asnumpy()
    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    print(f"rank {rank}/{world} OK", flush=True)
    mt.distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
