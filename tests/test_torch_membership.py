"""The port's copy of ``membership`` against the JAX package's: the pure
cases of ``tests/test_membership.py`` (stripe plans, routing, wire
layouts, sparse routing, moved row spans, handoff planning, restriping
values and states, succession, ledger rebuild, the coordinator's
idempotent mutations, its snapshot and stats banks, roster diffs, host
groups), each run through both modules on the same seeded inputs and
compared exactly, plus the worker's stripe plan derived by the port's
store."""
import numpy as np
import pytest

import mxnet_tpu.membership as jm
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import membership as tm
from torch_dist import cluster
import torch_threads  # noqa: F401,E402  a worker's share of the cores

RNG = np.random.RandomState(19)
KEYS = ["w", "emb", "fc1_weight", "layer3_attn_qkv_weight", "k" * 40]
SHAPES = [(10, 4), (2, 1000), (100, 4), (1,), (50304, 768), (7, 3, 5)]
SERVERS = [["a:1"], ["a:1", "b:2"], ["a:1", "b:2", "c:3"],
           ["b:2", "c:3", "d:4", "e:5", "f:6"]]


def _norm(x):
    """Comparable form: numpy arrays as (dtype, shape, bytes), tuples
    and lists element-wise, dicts sorted, Roster objects by wire."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (tuple, list)):
        return type(x).__name__, tuple(_norm(v) for v in x)
    if isinstance(x, dict):
        return "dict", tuple(sorted((str(k), _norm(v))
                                    for k, v in x.items()))
    if hasattr(x, "as_wire"):
        return "roster", _norm(x.as_wire())
    return x


def _same(fn, *args):
    assert _norm(fn(jm, *args)) == _norm(fn(tm, *args)), (fn, args)
    return fn(tm, *args)


@pytest.mark.parametrize("bound", [16, 1000, 1_000_000])
def test_routing_math_equals_the_jax_package(bound):
    for key in KEYS:
        for n in range(1, 6):
            _same(lambda m, k, nn: m.server_index(k, nn), key, n)
            for i in range(4):
                _same(lambda m, k, ii, nn: m.stripe_server_index(k, ii, nn),
                      key, i, n)
        for shape in SHAPES:
            for n in range(1, 6):
                _same(lambda m, *a: m.stripe_plan(*a), key, shape, n, bound)
            for servers in SERVERS:
                _same(lambda m, *a: m.wire_layout(*a), key, shape, servers,
                      bound)
                for old in SERVERS:
                    if len(shape) > 1 or shape[0] > 1:
                        _same(lambda m, *a: m.moved_row_spans(*a), key,
                              shape, old, servers, bound)
    assert tm.stripe_plan("w", (10, 4), 2, 16) == [0, 5, 10]
    assert tm.stripe_plan("w", (2, 1000), 5, 16) == [0, 1, 2]
    assert tm.stripe_plan("w", (10, 4), 1, 16) is None
    for wk in ("w", "w@s0", "w@s12", "a@s1@s2"):
        _same(lambda m, k: m.base_key(k), wk)


def test_sparse_route_and_handoff_planning_equal_the_jax_package():
    plan = tm.stripe_plan("emb", (100, 4), 2, 8)
    assert plan == [0, 50, 100]
    for _ in range(20):
        idx = np.unique(RNG.randint(0, 100, RNG.randint(0, 12))).astype(
            np.int64)
        _same(lambda m, p, i: m.sparse_route(p, i), plan, idx)
    routed = tm.sparse_route(plan, np.array([3, 49, 50, 99], np.int64))
    assert [(i, list(loc), list(pos)) for i, loc, pos in routed] == [
        (0, [3, 49], [0, 1]), (1, [0, 49], [2, 3])]
    shapes = {"big": (10, 4), "smallA": (2, 2), "smallB": (2, 2)}
    for old in SERVERS:
        for new in SERVERS:
            _same(lambda m, *a: sorted(m.plan_handoff(*a)), shapes, old,
                  new, 16)
    val = np.arange(40, dtype=np.float32).reshape(10, 4)
    for servers in SERVERS:
        _same(lambda m, *a: sorted(m.restripe_value(*a), key=str), "w",
              val, servers, 16)


def test_restripe_states_equal_the_jax_package():
    mom = np.arange(40, dtype=np.float32).reshape(10, 4)
    old = [0, 5, 10]
    cases = [
        ({"w@s0": (mom[0:5],), "w@s1": (mom[5:10],)}, None),
        ({"w@s0": (mom[0:5],), "w@s1": (mom[5:10],)},
         tm.stripe_plan("w", (10, 4), 3, 16)),
        ({"w@s0": mom[0:5], "w@s1": mom[5:10]}, None),
        ({"w@s0": (), "w@s1": ()}, None),
        ({"w@s0": (mom[0:5],)}, None),
        ({"w@s0": 3.5, "w@s1": 4.5}, None),
    ]
    for per_wire, new in cases:
        _same(lambda m, *a: m.restripe_states(*a), "w", per_wire, old, new)
    np.testing.assert_array_equal(
        tm.restripe_states("w", cases[0][0], old, None)["w"][0], mom)


def test_succession_ledger_and_roster_diff_equal_the_jax_package():
    servers = ["a:1", "b:2", "c:3"]
    for dead in (set(), {"a:1"}, {"a:1", "b:2"}, set(servers)):
        _same(lambda m, s, d: m.elect_successor(s, d), servers, dead)
    for s in (servers, [], None):
        _same(lambda m, x: m.coordinator_uri(x), s)
    reports = [
        {"uri": "b:2", "generation": 3, "beat_seq": 7, "keys": ["w@s1"]},
        {"uri": "c:3", "generation": 5, "beat_seq": 2, "keys": []},
        {"generation": "x"}, None, {}]
    snaps = {"a:1": (4, {"store": {}, "states": {}})}

    def ledger(m, srv, wk, rep, sn):
        led = m.rebuild_ledger(srv, wk, rep, sn)
        return (led.generation, led.failovers, led.roster(),
                led.snapshot_of("a:1"))
    for srv, wk in ((["b:2", "c:3"], [0, 1]), (["b:2"], [0])):
        assert _same(ledger, srv, wk, reports, snaps)[0] == 6
    for old, new in ((["a:1", "b:2", "c:3"], ["b:2", "d:4", "c:3"]),
                     ([], ["x:1"]), (["x:1"], []), (["a:1", ""],
                                                     ["a:1", None]),
                     (None, None)):
        _same(lambda m, o, n: m.roster_diff(o, n), old, new)
    for per_host in (1, 2, 3):
        _same(lambda m, w, p: m.host_groups(w, p), list(range(7)), per_host)
        for r in range(7):
            _same(lambda m, *a: m.mesh_group(*a), r, list(range(7)),
                  per_host)


def test_coordinator_mutations_and_banks_equal_the_jax_package():
    """One script of joins, leaves, evictions, dead reports, beats and
    snapshots through each package's coordinator: the same
    generations, rosters, counters and banks at every step."""
    def script(m):
        c = m.MembershipCoordinator(["a:1", "b:2"], [0, 1])
        out = [c.generation, c.roster()]
        out.append(c.report_dead_server("b:2"))
        out.append(c.report_dead_server("b:2"))
        try:
            c.report_dead_server("a:1")
        except RuntimeError as exc:
            out.append(str(exc))
        out += [c.join_server("c:3"), c.join_server("c:3"),
                c.join_worker(2), c.join_worker(2), c.evict_worker(1),
                c.evict_worker(1), c.leave_worker(0), c.leave_server("c:3"),
                c.evictions, c.roster(), c.workers_snapshot()]
        for seq, k in ((1, 1), (3, 3), (2, 2)):
            c.note_server_beat("a:1", seq=seq, snapshot={"k": k},
                               stats={"s": k})
        out += [c.snapshot_of("a:1"), c.snapshot_of("nope"),
                c.stats_of("a:1"), c.stats_bank()]
        bank = {}
        for seq, k in ((2, "x"), (1, "y"), (4, "z")):
            m.bank_newest(bank, "u", seq, k)
        out.append(bank)
        return out
    _same(script)
    assert tm.MembershipCoordinator(["a:1"], [0]).silent_servers(0.01) == []


def test_stripe_plan_matches_worker_derivation(monkeypatch):
    """The port's store delegates its stripe plans to the membership
    math, so the two cannot diverge."""
    with cluster(mt, monkeypatch, MXNET_KVSTORE_BIGARRAY_BOUND=16):
        kv = mt.kv.create("dist_async")
        for shape in ((10, 4), (3, 3), (40,)):
            assert kv._stripe_plan("w%d" % shape[0], shape) == \
                tm.stripe_plan("w%d" % shape[0], shape, 1, 16)
        kv.close(stop_servers=True)
