"""The port's hierarchical tier through real processes: the unedited
``tools/launch.py -n 2 -s 1 --workers-per-host 2`` starts one server and
two port workers of one host group (``tests/torch_hier_job.py``, the
scenario of the JAX package's ``tests/dist/dist_hier_smoke.py``), over
the shm lane, over the loopback socket, and with the leader's drain
wedged.  Each worker asserts its weights EQUAL to the analytic golden in
both the flat and the tiered run, and the bytes where they must be.
Each case runs under its own 120 s limit (``torch_dist.run`` kills the
process group past it)."""
import os
import sys

import pytest

from torch_dist import ROOT, run
import torch_threads  # noqa: F401  a worker's share of the cores

JOB = os.path.join(ROOT, "tests", "torch_hier_job.py")


@pytest.mark.parametrize("mode", ["lane", "tcp", "wedge"])
def test_launch_workers_per_host_runs_port_workers(mode):
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "-n", "2", "-s", "1", "--workers-per-host", "2",
           "--launcher", "local",
           "--env", "MXNET_KVSTORE_SHM=%s" % ("0" if mode == "tcp" else "1")]
    if mode == "wedge":
        cmd += ["--env", "MXNET_FI_SHM_WEDGE_AFTER=3",
                "--env", "MXNET_KVSTORE_SHM_STALL_S=0.5"]
    cmd += [sys.executable, JOB]
    rc, out, err = run(cmd, 120, env=env)
    assert rc == 0, (out[-2000:], err[-3000:])
    for rank in (0, 1):
        assert f"torch hier rank {rank}/2 OK" in out, out[-2000:]
    if mode == "wedge":
        assert "wedge->tcp fallback" in out, out[-2000:]
