"""Observability in the PyTorch port (tracing, health, the profiler), held
against the JAX package: the cases of ``tests/test_tracing.py`` and
``tests/test_health.py`` that need no distributed plane, run through
both packages where the behaviour is shared, with the port's files read
by ``tools/trace_merge.py`` and ``tools/postmortem.py``.

Comparisons of records, snapshots and rule verdicts are exact (they are
host bookkeeping).  Every wait has a timeout of its own, every test
starts from reset state (``profiler.reset_all``, ``health.reset``,
tracing's ring), and nothing installs a dump hook in the test process:
the hooks are tested in subprocesses."""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import health as jhealth
from mxnet_tpu import profiler as jprof
from mxnet_tpu import tracing as jtr

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import health as thealth
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch import tracing as ttr
from mxnet_tpu_torch.serving import DynamicBatcher
import torch_threads  # noqa: F401,E402  a worker's share of the cores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import trace_merge  # noqa: E402  (tools/trace_merge.py)
import postmortem  # noqa: E402  (tools/postmortem.py)

PKGS = {"jax": (jtr, jhealth, jprof), "port": (ttr, thealth, tprof)}
KNOBS = ("MXNET_TRACE", "MXNET_TRACE_DIR", "MXNET_TRACE_RING",
         "MXNET_TRACE_FLUSH_N", "MXNET_HEALTH", "MXNET_HEALTH_DIR",
         "MXNET_HEALTH_BARRIER_STALL_S", "MXNET_HEALTH_WIRE_STALL_S",
         "MXNET_HEALTH_RECOVERY_S", "MXNET_HEALTH_P99_MS",
         "MXNET_HEALTH_OVERLAP_FLOOR", "MXNET_HEALTH_FAILOVER_BUDGET_S",
         "MXNET_HEALTH_BUSY_STORM", "MXNET_HEALTH_BUSY_WINDOW_S",
         "MXNET_HEALTH_EVENTS", "MXNET_PROFILER_XLA_LOGDIR")
WAIT_S = 10.0


def _reset_all():
    for tr, health, prof in PKGS.values():
        tr.reconfigure()
        tr.reset()
        health.reconfigure()
        health.reset()
        prof.reset_all()
        # reset_all leaves these two families, in both packages
        prof.reset_serialization()
        prof.reset_mesh_fanin()
    tprof.profiler_set_state("stop")
    tprof.profiler_set_config(xla_logdir="")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("MXNET_HEALTH_INTERVAL_S", "0.05")
    for _, health, _ in PKGS.values():
        monkeypatch.setattr(health, "_install_hooks", lambda: None)
    _reset_all()
    try:
        with mt.cpu():
            yield
    finally:
        with monkeypatch.context() as m:
            for knob in KNOBS:
                m.delenv(knob, raising=False)
            _reset_all()


def _env(monkeypatch, **kw):
    for k, v in kw.items():
        monkeypatch.setenv(k, str(v))
    for tr, health, _ in PKGS.values():
        tr.reconfigure()
        health.reconfigure()


def _shape(rec):
    """A span record without its ids, clocks and process."""
    return {k: v for k, v in rec.items()
            if k not in ("trace", "span", "parent", "ts", "dur", "pid",
                         "tid")}


# -- tracing -----------------------------------------------------------------
def test_span_nesting_ring_and_records_match_jax(monkeypatch):
    _env(monkeypatch, MXNET_TRACE=1)
    recs = {}
    for name, (tr, _, _) in PKGS.items():
        with tr.span("outer", args={"k": 1}) as outer:
            with tr.span("inner") as inner:
                assert tr.current_ctx() == (inner.trace, inner.span)
                tr.instant("mark")
            assert tr.current_ctx() == (outer.trace, outer.span)
        recs[name] = tr.ring_records()
        mark, inner_r, outer_r = recs[name]
        assert [r["name"] for r in recs[name]] == ["mark", "inner", "outer"]
        assert inner_r["trace"] == outer_r["trace"] == mark["trace"]
        assert inner_r["parent"] == outer_r["span"]
        assert mark["parent"] == inner_r["span"]
        assert outer_r["parent"] is None and mark["dur"] == 0.0
        assert tr.stats()["recorded"] == 3
    assert [_shape(r) for r in recs["port"]] == \
        [_shape(r) for r in recs["jax"]]
    assert [sorted(r) for r in recs["port"]] == \
        [sorted(r) for r in recs["jax"]]


def test_spans_parent_per_thread(monkeypatch):
    _env(monkeypatch, MXNET_TRACE=1)

    def other():
        with ttr.span("other.root"):
            pass
    with ttr.span("main.root") as main_sp:
        t = threading.Thread(target=other)
        t.start()
        t.join(WAIT_S)
        assert ttr.current_ctx() == (main_sp.trace, main_sp.span)
    by = {r["name"]: r for r in ttr.ring_records()}
    assert by["other.root"]["parent"] is None
    assert by["other.root"]["trace"] != by["main.root"]["trace"]


def test_ring_bounded_and_disabled_noop(monkeypatch):
    assert not ttr.enabled()
    with ttr.span("nope") as sp:
        assert sp is None and ttr.current_ctx() is None
    ttr.instant("nope2")
    assert ttr.span_begin("x") is None
    ttr.span_end(None)
    assert ttr.ring_records() == [] and ttr.stats()["recorded"] == 0
    _env(monkeypatch, MXNET_TRACE=1, MXNET_TRACE_RING=16)
    for i in range(40):
        ttr.instant("e%d" % i)
    st = ttr.stats()
    assert st["ring"] == 16 and st["recorded"] == 40
    assert ttr.ring_records()[-1]["name"] == "e39"


def test_trace_file_is_read_by_trace_merge(monkeypatch, tmp_path):
    """The port's journal keeps the JAX package's format: the same file
    name, torn-line tolerance, and tools/trace_merge.py merges it."""
    _env(monkeypatch, MXNET_TRACE=1, MXNET_TRACE_DIR=tmp_path,
         MXNET_TRACE_FLUSH_N=1)
    t0 = time.monotonic_ns()
    with ttr.span("file.op"):
        with ttr.span("file.child"):
            pass
    ttr.add_span("file.added", t0, t0 + 1000)
    ttr.flush()
    path = ttr.trace_file_path()
    assert os.path.basename(path) == "local-0.trace.jsonl"
    assert [r["name"] for r in ttr.read_trace_file(path)] == \
        ["file.child", "file.op", "file.added"]
    with open(path, "a") as f:
        f.write('{"name": "torn", "half":')
    assert len(ttr.read_trace_file(path)) == 3
    merged = trace_merge.merge_spans([path])
    assert merged["metadata"]["spans"] == 3
    assert merged["metadata"]["files"] == ["local-0"]
    x = {e["name"]: e for e in merged["traceEvents"] if e.get("ph") == "X"}
    assert set(x) == {"file.op", "file.child", "file.added"}
    assert x["file.added"]["dur"] == 1.0


def test_exit_flush_registers_at_first_span_not_at_import(tmp_path):
    code = ("import atexit, json, torch\n"
            "n0 = atexit._ncallbacks()\n"
            "import mxnet_tpu_torch as mt\n"
            "n1 = atexit._ncallbacks()\n"
            "mt.tracing.instant('first')\n"
            "n2 = atexit._ncallbacks()\n"
            "print(json.dumps([n0, n1, n2]))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_TRACE="1",
               MXNET_TRACE_DIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n0, n1, n2 = json.loads(res.stdout.strip().splitlines()[-1])
    assert n1 == n0 and n2 == n0 + 1
    # the exit flush wrote the span
    assert [r["name"] for r in ttr.read_trace_file(
        str(tmp_path / "local-0.trace.jsonl"))] == ["first"]


class _Echo:
    buckets = [4]

    def predict(self, data):
        return 0, [np.asarray(data["data"])]


class _Blocking(_Echo):
    def __init__(self):
        self.started = threading.Event()
        self.release = threading.Event()

    def predict(self, data):
        self.started.set()
        assert self.release.wait(WAIT_S)
        return 0, [np.asarray(data["data"])]


def test_batcher_span_and_busy_shed_note(monkeypatch):
    _env(monkeypatch, MXNET_TRACE=1)
    b = DynamicBatcher(_Echo(), max_wait_s=0.0, queue_depth=8)
    try:
        caller = ttr.span_begin("srv.predict", detach=True)
        s = b.submit({"data": np.ones((2, 3), np.float32)}, span=caller)
        assert s.done.wait(WAIT_S) and s.reply[0] == "ok"
    finally:
        b.stop()
    ttr.span_end(caller)
    by = {r["name"]: r for r in ttr.ring_records()}
    sp = by["serving.batch"]
    assert sp["cat"] == "serving"
    assert sp["args"]["rows"] == 2 and sp["args"]["slots"] == 1
    assert "queue_wait_ms_max" in sp["args"]
    assert "queue_wait_ms" in by["srv.predict"]["args"]
    stub = _Blocking()
    b = DynamicBatcher(stub, max_wait_s=0.0, queue_depth=1)
    try:
        x = {"data": np.ones((1, 2), np.float32)}
        first = b.submit(x)
        assert stub.started.wait(WAIT_S)
        queued, shed = b.submit(x), b.submit(x)
        assert shed.done.is_set() and shed.reply[1][0] == "busy"
        assert thealth.event_counts().get("busy_shed") == 1
        assert any(r["name"] == "health.busy_shed"
                   for r in ttr.ring_records())
    finally:
        stub.release.set()
        b.stop()
    for s in (first, queued):
        assert s.done.wait(WAIT_S)


# -- the profiler ------------------------------------------------------------
def test_snapshot_keys_match_jax_and_reset():
    for compact in (False, True):
        t = tprof.snapshot(compact=compact)
        j = jprof.snapshot(compact=compact)
        assert set(t) == set(j), set(t) ^ set(j)
        assert set(t["wire"]) == set(j["wire"])
        assert set(t["health"]) == set(j["health"])
    snap = tprof.snapshot()
    assert set(snap["trace"]) == set(jprof.snapshot()["trace"])
    json.dumps(snap, default=str)
    tprof.record_dispatch("t.reset")
    tprof.record_channel_bytes("ici_sent", 10)
    assert tprof.ici_bytes_total() == 10 and tprof.wire_bytes_total() == 0
    tprof.reset_all()
    assert tprof.snapshot()["dispatch"] == {}
    assert tprof.snapshot()["channel_bytes"] == {}


def test_counter_arithmetic_matches_jax():
    for _, _, prof in PKGS.values():
        for i, d in enumerate([0.010, 0.030, 0.020, 0.500]):
            prof.record_latency("serving.request", d, ts=1.0 + i)
        prof.record_wire_wait(0.1)
        prof.record_wire_round(0.4)
        prof.record_mesh_fanin_wait(0.25)
        prof.record_serialization("codec_bytes", 7)
        prof.record_channel_count("kvstore.sparse_rows", 5)
        prof.record_channel_gauge("kvstore.roster_generation", 3)
        prof.record_channel_bytes("control", 9)
        prof.record_channel_bytes("shm_sent", 4)
    assert tprof.latency_stats("serving.request") == \
        jprof.latency_stats("serving.request")
    for fn in ("wire_wait_ms", "wire_round_ms", "wire_rounds",
               "wire_overlap_pct", "mesh_fanin_wait_ms", "mesh_fanin_rounds",
               "codec_bytes_total", "control_bytes_total",
               "shm_bytes_total", "wire_bytes_total", "channel_counts",
               "serialization_counts"):
        assert getattr(tprof, fn)() == getattr(jprof, fn)(), fn


def test_profiler_cli_dump_one_json_line_and_reset():
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("DMLC_ROLE", None)
    out = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.profiler", "--dump"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    snap = json.loads(lines[0])
    assert set(snap) == set(jprof.snapshot())
    tprof.record_dispatch("t.cli")
    assert tprof._main(["--reset"]) == 0
    assert tprof.dispatch_counts() == {}


def _module(pkg):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=4, name="fc1")
    net = pkg.sym.SoftmaxOutput(net, name="softmax")
    kw = {"context": pkg.cpu()}
    mod = pkg.mod.Module(net, **kw)
    mod.bind(data_shapes=[("data", (2, 3))],
             label_shapes=[("softmax_label", (2,))])
    mod.init_params()
    mod.init_optimizer()
    batch = pkg.io.DataBatch([pkg.nd.array(np.ones((2, 3), "f"))],
                             [pkg.nd.array(np.zeros(2, "f"))])
    return mod, batch


def test_chrome_trace_holds_the_executor_and_module_events(tmp_path):
    fname = str(tmp_path / "profile.json")
    mod, batch = _module(mt)
    tprof.profiler_set_config(mode="symbolic", filename=fname)
    tprof.profiler_set_state("run")
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    with tprof.scope("user.scope"):
        pass
    tprof.record_event("user.event", 5, 7)
    mt.nd.ones((2,)) + 1          # an eager op: mode symbolic skips it
    tprof.profiler_set_state("stop")
    mod.forward(batch, is_train=False)    # stopped: not recorded
    tprof.dump_profile()
    with open(fname) as f:
        doc = json.load(f)
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    names = [e["name"] for e in doc["traceEvents"]]
    for want in ("executor_forward", "executor_backward", "module.forward",
                 "module.backward", "module.update", "user.scope",
                 "user.event"):
        assert names.count(want) == 1, (want, names)
    assert "_plus_scalar" not in names
    for e in doc["traceEvents"]:
        assert set(e) == {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
        assert e["ph"] == "X" and e["dur"] >= 0
    # the JAX package's trace has the same event keys
    jfname = str(tmp_path / "jprofile.json")
    jmod, jbatch = _module(mx)
    jprof.profiler_set_config(mode="symbolic", filename=jfname)
    jprof.profiler_set_state("run")
    jmod.forward(jbatch, is_train=False)
    jmod.get_outputs()[0].asnumpy()
    jprof.profiler_set_state("stop")
    jprof.dump_profile()
    with open(jfname) as f:
        jdoc = json.load(f)
    assert set(jdoc) == set(doc)
    assert {k for e in jdoc["traceEvents"] for k in e} == \
        {k for e in doc["traceEvents"] for k in e}


def test_mode_all_records_eager_ops(tmp_path):
    tprof.profiler_set_config(mode="all",
                              filename=str(tmp_path / "p.json"))
    tprof.profiler_set_state("run")
    mt.nd.ones((2,)) + 1
    tprof.profiler_set_state("stop")
    tprof.dump_profile()
    with open(str(tmp_path / "p.json")) as f:
        assert any(e["name"] == "_plus_scalar"
                   for e in json.load(f)["traceEvents"])
    with pytest.raises(mt.MXNetError):
        tprof.profiler_set_config(mode="bogus")
    with pytest.raises(mt.MXNetError):
        tprof.profiler_set_state("paused")


def test_xla_logdir_drives_torch_profiler(tmp_path, monkeypatch):
    """``xla_logdir`` (and ``MXNET_PROFILER_XLA_LOGDIR``) make run/stop
    drive torch.profiler and write its chrome trace there."""
    mod, batch = _module(mt)
    logdir = str(tmp_path / "dev")
    tprof.profiler_set_config(filename=str(tmp_path / "p.json"),
                              xla_logdir=logdir)
    tprof.profiler_set_state("run")
    mod.forward(batch, is_train=True)
    mod.backward()
    tprof.profiler_set_state("stop")
    files = tprof.device_trace_files()
    assert len(files) == 1 and os.path.dirname(files[0]) == logdir
    with open(files[0]) as f:
        evs = json.load(f)["traceEvents"]
    assert any("addmm" in str(e.get("name", "")) or "linear" in
               str(e.get("name", "")) for e in evs)
    # the env knob, with the config cleared
    tprof.profiler_set_config(filename=str(tmp_path / "p.json"),
                              xla_logdir="")
    monkeypatch.setenv("MXNET_PROFILER_XLA_LOGDIR", str(tmp_path / "env"))
    tprof.profiler_set_state("run")
    mod.forward(batch, is_train=False)
    tprof.profiler_set_state("stop")
    assert len(tprof.device_trace_files()) == 2
    assert os.listdir(str(tmp_path / "env"))


def test_kvstore_server_stats_is_the_snapshot():
    kv = mt.kv.create("local")
    stats = kv.server_stats()
    assert set(stats) == set(mx.kv.create("local").server_stats())
    with pytest.raises(mt.MXNetError):
        kv.server_stats(rank=1)


# -- health ------------------------------------------------------------------
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_note_ring_counts_and_bound(monkeypatch, pkg):
    health = PKGS[pkg][1]
    _env(monkeypatch, MXNET_HEALTH_EVENTS=16)
    for i in range(40):
        health.note("t.tick", i=i)
    evs = health.events()
    assert len(evs) == 16 and evs[-1]["i"] == 39 and evs[0]["i"] == 24
    assert health.event_counts()["t.tick"] == 40


def test_master_switch_off(monkeypatch, tmp_path):
    _env(monkeypatch, MXNET_HEALTH=0, MXNET_HEALTH_DIR=tmp_path)
    thealth.note("t.ignored")
    assert thealth.events() == []
    assert thealth.wait_begin("kv.barrier") is None
    assert thealth.status() == "OK"
    assert thealth.dump("off") is None
    assert list(tmp_path.iterdir()) == []
    assert thealth.snapshot_section() == {"status": "OK", "enabled": False}


def test_bundle_dump_and_postmortem(monkeypatch, tmp_path):
    _env(monkeypatch, MXNET_HEALTH_DIR=tmp_path)
    thealth.note("t.before_crash", detail="x")
    try:
        raise ValueError("boom for the black box")
    except ValueError as exc:
        seen = []
        monkeypatch.setattr(thealth, "_prev_excepthook",
                            lambda t, v, tb: seen.append(t))
        thealth._excepthook(ValueError, exc, exc.__traceback__)
    assert seen == [ValueError]
    path = str(tmp_path / "local-0.crash.json")
    b = json.loads(open(path).read())
    assert b["reason"] == "crash" and b["role"] == "local"
    assert b["exception"]["type"] == "ValueError"
    assert any(e["kind"] == "t.before_crash" for e in b["events"])
    thealth.dump("second")
    b2 = json.loads(open(path).read())
    assert b2["reasons"] == ["crash", "second"]
    assert not [p for p in os.listdir(tmp_path) if ".tmp" in p]
    # the JAX package's bundle has the same keys
    monkeypatch.setenv("MXNET_HEALTH_DIR", str(tmp_path / "jax"))
    jhealth.reconfigure()
    jpath = jhealth.dump("second")
    assert set(json.loads(open(jpath).read())) == set(b2) - {"exception"}
    report = postmortem.build_report(str(tmp_path))
    assert [d["shape"] for d in report["dead"]] == ["crash"]
    assert report["dead"][0]["named_by"] == ["self"]


def test_dump_hooks_install_at_first_use_and_write_a_crash_bundle(
        tmp_path):
    """In a process of its own: importing installs no hook; the first
    note installs them; an uncaught exception then leaves a bundle that
    tools/postmortem.py names as a crash."""
    code = ("import sys, threading, signal, atexit, json\n"
            "import torch\n"
            "n0 = atexit._ncallbacks()\n"
            "import mxnet_tpu_torch as mt\n"
            "before = [sys.excepthook is sys.__excepthook__,\n"
            "          atexit._ncallbacks() == n0]\n"
            "mt.health.note('t.first')\n"
            "after = [sys.excepthook is sys.__excepthook__,\n"
            "         atexit._ncallbacks() == n0]\n"
            "print(json.dumps([before, after]), flush=True)\n"
            "raise RuntimeError('uncaught in the port')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, MXNET_HEALTH_DIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 1 and "uncaught in the port" in res.stderr
    before, after = json.loads(res.stdout.strip().splitlines()[-1])
    assert before == [True, True] and after == [False, False]
    b = json.loads(open(tmp_path / "local-0.crash.json").read())
    # the crash dump, then the exit dump, which replaces it (the JAX
    # package's order): the reasons accumulate
    assert b["reasons"] == ["crash", "exit"]
    assert any(e["kind"] == "t.first" for e in b["events"])
    report = postmortem.build_report(str(tmp_path))
    assert [d["shape"] for d in report["dead"]] == ["crash"]


def test_watchdog_trips_a_stalled_wait_and_recovers(monkeypatch):
    _env(monkeypatch, MXNET_HEALTH_BARRIER_STALL_S=0.15,
         MXNET_HEALTH_WIRE_STALL_S=60, MXNET_HEALTH_RECOVERY_S=0.3)
    tok = thealth.wait_begin("kv.barrier")
    deadline = time.monotonic() + WAIT_S
    while not thealth.trip_counts().get("barrier_stall") \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    assert thealth.trip_counts() == {"barrier_stall": 1}
    ev = [e for e in thealth.events()
          if e["kind"] == "watchdog.barrier_stall"]
    assert ev and ev[0]["name"] == "kv.barrier"
    assert 0.15 <= ev[0]["age_s"] <= 2.0
    assert tprof.channel_counts().get("health.barrier_stall") == 1
    assert thealth.status() == "DEGRADED"
    assert "stalled_wait:kv.barrier" in thealth.snapshot_section()["active"]
    thealth.wait_end(tok)
    assert any(e["kind"] == "stall_cleared" for e in thealth.events())
    deadline = time.monotonic() + WAIT_S
    while thealth.status() != "OK" and time.monotonic() < deadline:
        time.sleep(0.05)
    assert thealth.status() == "OK"
    assert thealth.snapshot_section()["worst"] == "DEGRADED"
    assert thealth._dead_nodes() == 0      # no dist_async store is open


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_slo_rules(monkeypatch, pkg):
    _, health, prof = PKGS[pkg]
    _env(monkeypatch, MXNET_HEALTH_P99_MS=100, MXNET_HEALTH_RECOVERY_S=0,
         MXNET_HEALTH_OVERLAP_FLOOR=25, MXNET_HEALTH_FAILOVER_BUDGET_S=1.0)
    prof.record_latency("serving.request", 0.010, ts=1.0)
    assert health.status() == "OK"
    prof.record_latency("serving.request", 0.500, ts=2.0)
    assert health.status() == "DEGRADED"
    rules = {r["rule"]: r for r in health.snapshot_section()["rules"]}
    assert rules["p99_ms"]["ok"] is False
    assert rules["p99_ms"]["value"] == pytest.approx(500.0)
    st, failed = health.evaluate(
        {"channel": {"kvstore.failover_rebuild_s": 9.9}})
    assert st == "DEGRADED" and [r["rule"] for r in failed] == \
        ["failover_budget_s"]
    assert health.evaluate({"channel": {},
                            "health": {"status": "CRITICAL"}})[0] == \
        "CRITICAL"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_busy_storm_hysteresis(monkeypatch, pkg):
    health = PKGS[pkg][1]
    _env(monkeypatch, MXNET_HEALTH_BUSY_STORM=3,
         MXNET_HEALTH_BUSY_WINDOW_S=1.0, MXNET_HEALTH_RECOVERY_S=2.0)
    t0 = 1000.0
    for i in range(3):
        health.note("busy_shed", mono=t0 + i * 0.1)
    assert health.status(now=t0 + 0.3) == "DEGRADED"
    assert health.status(now=t0 + 1.5) == "DEGRADED"
    assert health.status(now=t0 + 3.6) == "OK"


def test_channel_poison_and_snapshot_sections(monkeypatch):
    _env(monkeypatch, MXNET_HEALTH_RECOVERY_S=0.1)
    assert tprof.snapshot()["health"]["status"] == "OK"
    thealth.note_channel_poison("127.0.0.1:9999")
    assert thealth.status() == "CRITICAL"
    assert tprof.snapshot(compact=True)["health"]["status"] == "CRITICAL"
    thealth.clear_channel_poison("127.0.0.1:9999")
    assert thealth.status() == "DEGRADED"
    deadline = time.monotonic() + WAIT_S
    while thealth.status() != "OK" and time.monotonic() < deadline:
        time.sleep(0.03)
    assert thealth.status() == "OK"
    s = thealth.summary()
    assert set(s) == set(jhealth.summary()) and s["worst"] == "CRITICAL"
    assert set(thealth.snapshot_section()) == \
        set(jhealth.snapshot_section())
