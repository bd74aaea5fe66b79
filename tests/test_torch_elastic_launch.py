"""The port's elastic membership through real processes: the scenario of
``tests/dist/dist_elastic_membership.py`` (two workers, two servers,
one striped key and a small key a server) with the port's package,
launched by the unedited ``tools/launch.py --elastic -n 2 -s 2``.  A
server is REALLY SIGKILLed by ``MXNET_FI_KILL_PROCESS_AFTER`` right
after the last ack of round 2 (the count from the wire arithmetic,
``tests/torch_elastic_job.py expected_kill_acks``), and so, in the
second case, is the coordinator (``MXNET_FI_ONLY_COORDINATOR=1``).  The
job must finish without a restart and each worker asserts its final
weights EQUAL to the static roster's golden (integer gradients and a
power-of-two learning rate: exact in float32, in any order).  Each case
runs under its own 90 s limit (``torch_dist.run`` kills the process
group past it)."""
import os
import sys

import pytest

from torch_dist import ROOT, run
import torch_threads  # noqa: F401  a worker's share of the cores

JOB = os.path.join(ROOT, "tests", "torch_elastic_job.py")


def _kill_acks(server):
    env = dict(os.environ, MXT_PRINT_KILL_ACKS="1",
               MXT_KILL_SERVER=str(server))
    rc, out, err = run([sys.executable, JOB], 30, env=env)
    assert rc == 0, err
    return int(out.strip())


@pytest.mark.parametrize("server", [1, 0], ids=["data_shard",
                                                "coordinator"])
def test_sigkilled_server_recovers_bit_identical(server):
    acks = _kill_acks(server)
    # the JAX package's arithmetic for the same scenario
    assert acks == {1: 2 * 3 + 1 + 2 * 6 * 2,
                    0: 2 * 5 + 1 + 2 * 8 * 2}[server]
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "--elastic", "-n", "2", "-s", "2", "--launcher", "local",
           "--env", f"MXNET_FI_KILL_PROCESS_AFTER={acks}",
           "--env", f"MXNET_FI_ONLY_SERVER={server}",
           "--env", f"MXT_KILL_SERVER={server}"]
    if server == 0:
        cmd += ["--env", "MXNET_FI_ONLY_COORDINATOR=1"]
    cmd += [sys.executable, JOB]
    rc, out, err = run(cmd, 90, env=env)
    assert rc == 0, (out[-2000:], err[-3000:])
    for rank in (0, 1):
        assert f"torch elastic rank {rank}/2 OK" in out, out[-2000:]
    if server == 0:
        assert "failovers 1" in out, out[-2000:]
