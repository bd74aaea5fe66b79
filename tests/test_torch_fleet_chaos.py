"""The serving fleet over the port's replicas as real child processes
on the CPU: ``tests/dist/dist_fleet_chaos.py`` and
``tests/dist/dist_fleet_canary.py`` with the port's ``ServingReplica``
(``tests/torch_fleet_job.py``) and the port's ``FleetClient`` in this
process.

* Chaos: of three replicas, rank 1 is SIGKILLed by
  ``MXNET_FI_KILL_PROCESS_AFTER=25`` mid-storm and rank 2 blackholed by
  ``MXNET_FI_BLACKHOLE_AFTER=15`` (it accepts and heartbeats but never
  replies).  A 64-thread storm of 256 requests sees zero failures, the
  scoreboard marks both DEAD, follow-up traffic goes only to the
  survivor (``profiler.fleet_route_counts``), and the unedited
  ``tools/postmortem.py`` names the victim from the absence of its
  health bundle.
* Canary: the canary replica delays every reply by 80 ms
  (``MXNET_FI_DELAY_ACK_MS``); the fleet rolls it back on its own
  mid-stream with a ``canary_rollback`` health event, and every request
  succeeds.

Replies are held against numpy's softmax of the same float32 weights,
rtol 1e-5 / atol 1e-6 (float32 summation order and exp).  Each case
kills its children in ``finally`` and bounds every wait, well inside
60 s."""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import health, profiler
from mxnet_tpu_torch.serving import FleetClient
from torch_dist import ROOT
from torch_fleet_job import FEAT, model
import torch_threads  # noqa: F401  a worker's share of the cores

JOB = os.path.join(ROOT, "tests", "torch_fleet_job.py")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _spawn(ports, extra_env, health_dir=None):
    """One replica child a port; waits (30 s at most each) for READY."""
    uris = ["127.0.0.1:%d" % p for p in ports]
    children = []
    for rank, port in enumerate(ports):
        env = dict(os.environ, PYTHONPATH=ROOT, FLEET_PORT=str(port),
                   DMLC_SERVER_ID=str(rank),
                   DMLC_NUM_SERVER=str(len(ports)), DMLC_NUM_WORKER="0",
                   MXT_SERVER_URIS=",".join(uris))
        env.pop("DMLC_ROLE", None)
        if health_dir:
            env["MXNET_HEALTH_DIR"] = health_dir
        env.update(extra_env.get(rank, {}))
        children.append(subprocess.Popen(
            [sys.executable, JOB], env=env, stdout=subprocess.PIPE,
            text=True, start_new_session=True))
    for rank, proc in enumerate(children):
        deadline = time.monotonic() + 30
        line = ""
        while time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line or line.startswith("READY"):
                break
        assert line.startswith("READY"), \
            "replica %d never came up: %r" % (rank, line)
    return uris, children


def _kill_all(children):
    for proc in children:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=10)


def _reference(x):
    _sym, _params, w, b = model(mt)
    logits = x @ w.T + b
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def test_fleet_chaos_kill_and_blackhole_zero_failures(tmp_path):
    victim, gray = 1, 2
    health_dir = str(tmp_path)
    profiler.reset_channel_counts()
    uris, children = _spawn(
        _free_ports(3),
        {victim: {"MXNET_FI_KILL_PROCESS_AFTER": "25"},
         gray: {"MXNET_FI_BLACKHOLE_AFTER": "15"}}, health_dir)
    try:
        fl = FleetClient(uris, retries=4, attempt_s=2.0, deadline_s=30.0,
                         backoff_ms=5.0, backoff_max_ms=50.0,
                         stats_interval=0.5, connect_timeout=15.0)
        assert set(fl.poll_once().values()) == {"OK"}
        x = np.random.RandomState(7).randn(4, FEAT).astype(np.float32)
        ref = _reference(x)
        errors = []

        def storm():
            for _ in range(4):
                try:
                    outs = fl.predict({'data': x})
                    np.testing.assert_allclose(outs[0], ref,
                                               rtol=1e-5, atol=1e-6)
                except Exception as exc:  # noqa: BLE001 — counted
                    errors.append(repr(exc))

        threads = [threading.Thread(target=storm) for _ in range(64)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(40)
        assert not errors, errors[:5]
        deadline = time.monotonic() + 10
        while children[victim].poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        assert children[victim].poll() == -signal.SIGKILL
        fl.poll_once()
        states = fl.scoreboard()
        assert states[uris[victim]]["state"] == "DEAD", states
        assert states[uris[gray]]["state"] == "DEAD", states
        assert states[uris[0]]["state"] == "OK", states
        before = profiler.fleet_route_counts()
        for _ in range(64):
            np.testing.assert_allclose(fl.predict({'data': x})[0], ref,
                                       rtol=1e-5, atol=1e-6)
        after = profiler.fleet_route_counts()
        delta = {u: after.get(u, 0) - before.get(u, 0) for u in uris}
        assert delta == {uris[0]: 64, uris[victim]: 0, uris[gray]: 0}
        counts = profiler.channel_counts()
        assert counts.get("fleet.retry", 0) > 0
        assert counts.get("fleet.conn_error", 0) \
            + counts.get("fleet.timeout", 0) > 0
        fl.close()
        for rank, proc in enumerate(children):
            if rank != victim:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=20)
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import postmortem
        report = postmortem.build_report(health_dir)
        dead = report["dead"]
        assert len(dead) == 1, json.dumps(dead, indent=2, default=str)
        assert (dead[0]["role"], dead[0]["rank"], dead[0]["shape"],
                dead[0]["uri"]) == ("server", str(victim), "sigkill",
                                    uris[victim]), dead
        assert {"server-0", "server-%d" % gray} <= \
            set(report["terminated"]), report["terminated"]
    finally:
        _kill_all(children)


def test_fleet_canary_rolls_back_on_its_own():
    health.reset()
    profiler.reset_channel_counts()
    uris, children = _spawn(_free_ports(2),
                            {1: {"MXNET_FI_DELAY_ACK_MS": "80"}})
    base_uri, canary_uri = uris
    try:
        fl = FleetClient(uris, retries=3, attempt_s=5.0, deadline_s=30.0,
                         stats_interval=0.0, connect_timeout=15.0,
                         canary_min_n=20)
        assert set(fl.poll_once().values()) == {"OK"}
        x = np.random.RandomState(7).randn(2, FEAT).astype(np.float32)
        ref = _reference(x)
        fl.start_canary([canary_uri], fraction=0.5, refresh=False)
        assert fl.canary_active
        n_sent = 0
        while fl.canary_active and n_sent < 400:
            np.testing.assert_allclose(fl.predict({'data': x})[0], ref,
                                       rtol=1e-5, atol=1e-6)
            n_sent += 1
        assert not fl.canary_active, fl.canary_report()
        rb = fl.last_rollback
        assert rb and "p99" in rb["reasons"], rb
        assert rb["canary_p99_ms"] > rb["baseline_p99_ms"], rb
        assert fl.scoreboard()[canary_uri]["state"] == "DRAINING"
        assert profiler.channel_counts().get("fleet.rollback") == 1
        events = [ev for ev in health.events()
                  if ev["kind"] == "canary_rollback"]
        assert len(events) == 1 and events[0]["uris"] == [canary_uri]
        before = profiler.fleet_route_counts()
        for _ in range(32):
            np.testing.assert_allclose(fl.predict({'data': x})[0], ref,
                                       rtol=1e-5, atol=1e-6)
        after = profiler.fleet_route_counts()
        assert after.get(base_uri, 0) - before.get(base_uri, 0) == 32
        assert after.get(canary_uri, 0) == before.get(canary_uri, 0)
        fl.close()
    finally:
        _kill_all(children)
