"""Shared helpers of the distributed-plane tests (not collected): the two
packages side by side, in-process parameter-server clusters of either
package, and a subprocess runner with a time limit of its own that kills
the process group on timeout."""
import contextlib
import os
import signal
import subprocess
import sys

import numpy as np

import mxnet_tpu as mx
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": mx, "port": mt}


@contextlib.contextmanager
def cluster(pkg, monkeypatch, n=1, **env):
    """``n`` in-process servers of ``pkg`` (a package module) with the
    worker env pointing at them; the port runs on the CPU inside."""
    srvs = [pkg.kvstore_server.KVStoreServer(server_id=i, num_workers=1)
            for i in range(n)]
    for s in srvs:
        s.start_background()
    monkeypatch.setenv("MXT_SERVER_URIS", ",".join(
        f"127.0.0.1:{s.port}" for s in srvs))
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    try:
        if pkg is mt:
            with mt.cpu():
                yield srvs
        else:
            yield srvs
    finally:
        for s in srvs:
            s.stop()


def nd(pkg, x, dtype=np.float32):
    """A host array of ``pkg`` holding ``x``."""
    return pkg.nd.NDArray(np.asarray(x, dtype))


def zeros(pkg, shape):
    return nd(pkg, np.zeros(shape))


def pulled(pkg, kv, key, shape):
    out = zeros(pkg, shape)
    kv.pull(key, out=out)
    return out.asnumpy()


def run(cmd, timeout, env=None, cwd=ROOT):
    """Run ``cmd`` in a session of its own; on timeout SIGTERM then
    SIGKILL its process group and fail naming the tail of its output
    (as ``tests/test_distributed.py`` does)."""
    proc = subprocess.Popen(cmd, env=env, cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        import time
        os.killpg(proc.pid, signal.SIGTERM)
        time.sleep(2)
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} timed out after {timeout}s; killed. "
                             f"tail: {out[-1500:]} {err[-1500:]}")
    return proc.returncode, out, err


def launch(n, script_args, timeout, servers=0, env_extra=None):
    """``tools/launch.py -n n [-s servers] python <script_args>`` on the
    CPU; returns stdout (asserts the launcher exited 0)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    cmd = [sys.executable, os.path.join(ROOT, "tools", "launch.py"),
           "-n", str(n), "--launcher", "local"]
    if servers:
        cmd += ["-s", str(servers)]
    cmd += [sys.executable] + list(script_args)
    rc, out, err = run(cmd, timeout, env=env)
    assert rc == 0, (out[-2000:], err[-2000:])
    return out
