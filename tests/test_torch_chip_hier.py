"""CPU rehearsal of ``chip_smoke.py``'s ``hier_lm_fit`` phase, run through
the script's own functions at a small size before any card run: the
unedited ``tools/launch.py -n 2 -s 2 --workers-per-host 2`` starts two
parameter servers and two ranks of one host group
(``chip_smoke.py --hier-worker``), the follower's gradients ride the shm
lane to the leader, which sums them, compresses the sum (2-bit; the
plain quantizer on the CPU) and alone pushes it; every check of the
phase runs: the sum bit for bit, the payload against the plain
quantizer with its residual, the first step against the servers' Adam
replayed, the ranks' weights equal after every step, the follower's
bytes on the lane, the loss falling, the servers and the leader's
endpoint closed.  On the CPU no kernel launches (the phase expects zero
counts there).  The case stays well inside 120 s."""
import sys

import torch

import mxnet_tpu_torch as mt
from torch_dist import ROOT
import torch_threads  # noqa: F401  a worker's share of the cores

sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

SMALL = dict(vocab_size=64, seq_len=16, num_layers=2, d_model=32,
             num_heads=4, d_ff=64)


def test_hier_lm_fit_phase_on_a_small_lm(tmp_path):
    # a learning rate and threshold for the small LM: its gradients are
    # some 1e-2, and 3 steps must move the loss by the margin
    spec = cs.hier_spec(device="cpu", cfg=SMALL, batch=16, steps=4,
                        threshold=0.005, lr=0.01, margin=0.05,
                        compute_dtype="bfloat16")
    started = cs.start_hier_job(str(tmp_path), spec)
    try:
        lead, foll, q1 = cs.phase_hier_lm_fit(torch, mt, str(tmp_path),
                                               started, spec)
    finally:
        cs.stop_hier_job(started)
    assert not any(lead.values()) and not any(foll.values()) and q1 == 0
