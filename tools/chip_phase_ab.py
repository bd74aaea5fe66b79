#!/usr/bin/env python3
"""Compare one ``chip_smoke.py`` phase across two checkouts on one card.

    python3 tools/chip_phase_ab.py PHASE TREE_A TREE_B [--out FILE]

Runs ``phase_<PHASE>(torch, mt)`` of each checkout's own
``chip_smoke.py`` in a fresh process from that checkout's root, in the
order A, B, B, A (so drift over the call falls on both sides), with the
same backend flags ``chip_smoke.py``'s main sets before its training
phases (TF32 off, ``cudnn.benchmark`` on).  Only phases that take
``(torch, mt)`` can be run this way (``vit_train``, ``ptb_bucketing``,
``rnn_fp32``, ...).  Prints one JSON line a run with the scalar keys
of the phase's own line (``median_step_ms``, ``seconds``, ...), and
writes the list to ``--out``.  A phase that prints one line a case
(``kernels`` and ``bwd_kernels``, whose cases are ``kernel_check`` and
``kernel_check_bwd`` lines) is read at the one line that ``--name``
names, and a phase that prints its cases inside one line (``nms_kernel``:
``kernel_check_nms``'s ``cases``) at the case of that name, e.g.

    python3 tools/chip_phase_ab.py bwd_kernels build/parent . \
        --name main_fp32
    python3 tools/chip_phase_ab.py nms_kernel build/parent . \
        --name detect_bf16

``--name`` may be given more than once: each run then prints one line a
name.
"""
import argparse
import json
import subprocess
import sys

RUN = r'''
import os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as cs
import mxnet_tpu_torch as mt
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.benchmark = True
getattr(cs, "phase_" + sys.argv[1])(torch, mt)
'''


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("phase")
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--out")
    ap.add_argument("--name", action="append",
                    help="read the line of this case (repeatable)")
    args = ap.parse_args()
    rows = []
    for tree in (args.tree_a, args.tree_b, args.tree_b, args.tree_a):
        res = subprocess.run([sys.executable, "-c", RUN, args.phase],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        lines = [json.loads(l) for l in res.stdout.splitlines()
                 if l.startswith('{"phase": ')]
        for name in args.name or [None]:
            if name:
                picked = [l for l in lines if l.get("name") == name] + [
                    dict(l["cases"][name], phase=l["phase"])
                    for l in lines if isinstance(l.get("cases"), dict)
                    and name in l["cases"]]
            else:
                picked = [l for l in lines if l["phase"] == args.phase]
            row = dict(tree=tree, rc=res.returncode)
            if name:
                row["name"] = name
            if len(picked) > 1 and name:
                # two phases' lines of one name: refuse to guess which
                row["rc"] = row["rc"] or 1
                row["error"] = "%d lines named %s, phases %s" % (
                    len(picked), name, sorted({l["phase"] for l in picked}))
            elif picked:
                row.update({k: v for k, v in picked[-1].items()
                            if isinstance(v, (int, float)) and k != "t_s"})
            if not picked or res.returncode:
                row["stderr"] = res.stderr[-2000:]
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0 if all(r["rc"] == 0 for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
