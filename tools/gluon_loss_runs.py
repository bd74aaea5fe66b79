#!/usr/bin/env python3
"""How far ``chip_smoke.py``'s Gluon ResNet-50 v1 loss falls, run to run.

    python3 tools/gluon_loss_runs.py [--runs 6] [--steps 60] [--out FILE]

Runs the loop of ``chip_smoke.py``'s ``gluon_resnet_train`` phase (the
same net, seed, batches, optimizer and backend flags: TF32 off,
``cudnn.benchmark`` on) for ``--steps`` steps in ``--runs`` fresh
processes on ``cuda:0``, so that each run makes its own cuDNN algorithm
choice.  Prints one JSON line a run with its losses and, for every step
count ``n`` in 25, 30, ..., ``--steps``, the mean loss of the first 5
steps less the mean of steps ``n - 4 .. n`` (the phase's check reads it
at its own step count); first the card's name and power limit as
``nvidia-smi`` reads them; writes the list to ``--out``.
"""
import argparse
import json
import subprocess
import sys

RUN = r'''
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
dev = torch.device("cuda", 0)
net = cs.gluon_resnet(mt, mt.gpu(0), cs.SEED)
trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(cs.GLUON_OPT))
loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
batches = cs.gluon_batches(torch, mt, dev, cs.GLUON_BATCH, (3, 224, 224),
                           cs.SEED + 20)
_, losses = cs.gluon_train_steps(mt, net, trainer, loss_fn, batches,
                                 int(sys.argv[1]), torch.cuda.synchronize)
print(json.dumps({"losses": losses}))
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    rows = []
    for i in range(args.runs):
        res = subprocess.run([sys.executable, "-c", RUN, str(args.steps)],
                             capture_output=True, text=True, timeout=600)
        row = dict(run=i, rc=res.returncode, card=smi)
        lines = [l for l in res.stdout.splitlines()
                 if l.startswith('{"losses"')]
        if lines:
            losses = json.loads(lines[-1])["losses"]
            first5 = sum(losses[:5]) / 5
            row["losses"] = losses
            row["drop_at"] = {n: first5 - sum(losses[n - 5:n]) / 5
                              for n in range(25, args.steps + 1, 5)}
        else:
            row["stderr"] = res.stderr[-2000:]
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
