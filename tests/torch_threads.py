"""Torch's intra-op threads in a pytest-xdist worker: an even share of
the cores (not collected; imported by the port's test files).

The suite runs in several worker processes at once (``-n 6``), and each
would otherwise start one torch (OpenMP) thread a core: six times the
threads the machine has, which spin at every parallel region's barrier
while the others hold the cores.  Measured on 8 cores with five other
processes busy: DenseNet-121's forward at 224x224 took 60 s with 8
threads, 10 s with 2 and 7 s with 1.  Each worker therefore takes
``cores // workers`` threads (at least one); outside xdist torch keeps
its default.  The JAX package's XLA threads are left as they are."""
import os

import torch


def share_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers > 1:
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // workers))


share_cores()
