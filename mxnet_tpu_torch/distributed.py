"""Multi-process bootstrap over ``torch.distributed``.

PyTorch counterpart of ``mxnet_tpu/distributed.py``.  The reference boots
a cluster with dmlc-tracker: ``tools/launch.py`` spawns the processes and
wires them with ``DMLC_*`` environment variables (reference:
tools/launch.py:64-80, src/kvstore/kvstore_dist.h:51-61).
:func:`initialize` reads the same variables and forms a **gloo** process
group over a TCP rendezvous:

* ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` -> ``tcp://uri:port``
* ``DMLC_NUM_WORKER``                          -> world size
* ``DMLC_WORKER_ID``                           -> this process's rank

``allreduce_sum`` and ``broadcast_from_root`` work on host values with
the JAX package's semantics: an all-gather, then a sum in rank order, so
every rank gets the identical total, bit for bit (``kvstore``
``dist_sync``'s aggregation).  Gloo moves host tensors; NCCL, which two
ranks on one card cannot form, waits for multi-GPU (ROADMAP D1).
Without :func:`initialize` every call degrades to one process.
"""
from __future__ import annotations

import atexit
import os
from typing import Optional

import numpy as np

from .base import MXNetError

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> None:
    """Join the process group (idempotent).  The arguments default from
    the DMLC-shaped environment ``tools/launch.py`` sets;
    ``local_device_ids`` is accepted for the JAX package's signature and
    unused (each process names its own card)."""
    global _initialized
    if _initialized:
        return
    import torch.distributed as tdist
    env = os.environ
    if coordinator_address is None and "DMLC_PS_ROOT_URI" in env:
        coordinator_address = "%s:%s" % (
            env["DMLC_PS_ROOT_URI"], env.get("DMLC_PS_ROOT_PORT", "9091"))
    if num_processes is None:
        num_processes = int(env.get("DMLC_NUM_WORKER", "1"))
    if process_id is None:
        process_id = int(env.get("DMLC_WORKER_ID", "0"))
    if coordinator_address is None:
        raise MXNetError(
            "distributed.initialize: no coordinator address (pass one, "
            "or launch with tools/launch.py, which sets DMLC_PS_ROOT_URI "
            "and DMLC_PS_ROOT_PORT)")
    tdist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id))
    _initialized = True
    atexit.register(shutdown)


def is_initialized() -> bool:
    return _initialized


def rank() -> int:
    """This process's id (reference: KVStore::get_rank, kvstore_dist.h:98)."""
    if not _initialized:
        return 0
    import torch.distributed as tdist
    return tdist.get_rank()


def size() -> int:
    """Number of processes (reference: get_group_size, kvstore_dist.h:100)."""
    if not _initialized:
        return 1
    import torch.distributed as tdist
    return tdist.get_world_size()


def barrier(name: str = "mxnet_tpu_barrier") -> None:
    """Block until every process arrives (reference: Postoffice::Barrier).
    ``name`` is accepted for the JAX package's signature."""
    if size() > 1:
        import torch.distributed as tdist
        tdist.barrier()


def _allgather(value):
    """Every rank's copy of ``value`` (a numpy array or a CPU tensor), in
    rank order, as CPU tensors; counts this rank's bytes under the
    profiler's "allgather" family."""
    import torch
    import torch.distributed as tdist
    from . import profiler as _prof
    t = value if isinstance(value, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(value))
    t = t.detach().cpu().contiguous()
    _prof.record_channel_bytes("allgather",
                               int(t.numel() * t.element_size()))
    parts = [torch.empty_like(t) for _ in range(size())]
    tdist.all_gather(parts, t)
    return parts


def allreduce_sum(value):
    """Sum a per-process host value (numpy array or CPU tensor) across all
    processes; every process gets the total, summed in rank order (JAX
    package: ``process_allgather(arr).sum(axis=0)``), so the ranks agree
    bit for bit.  Returns the kind it was given."""
    if size() == 1:
        return value if not isinstance(value, (list, tuple)) else \
            np.asarray(value)
    parts = _allgather(value)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total if not isinstance(value, np.ndarray) else total.numpy()


def broadcast_from_root(value):
    """Every process gets rank 0's value (reference: the first worker's
    init wins, kvstore_dist_server.h DataHandleDefault init path)."""
    if size() == 1:
        return value
    root = _allgather(value)[0]
    return root if not isinstance(value, np.ndarray) else root.numpy()


# Liveness sources: objects exposing num_dead_nodes() (dist_async
# kvstores register their heartbeat monitors here).  Weakrefs — a
# forgotten store must not pin itself alive or keep reporting.
_dead_node_sources: list = []


def _register_dead_node_source(obj) -> None:
    import weakref
    _dead_node_sources.append(weakref.ref(obj))


def _live_sources():
    """The registry's still-alive objects, pruning dead weakrefs as a
    side effect — the one deref/prune loop every aggregate reads
    through."""
    for ref in list(_dead_node_sources):
        obj = ref()
        if obj is None:
            try:
                _dead_node_sources.remove(ref)
            except ValueError:
                pass
            continue
        yield obj


def num_dead_nodes() -> int:
    """Reference parity: KVStore::get_num_dead_node (kvstore.h:328).
    The gloo group has no partial-failure mode of its own (a dead rank
    fails the collective); the ``dist_async`` parameter servers do: each
    worker-server channel runs a low-rate heartbeat, every open
    dist_async store registers itself here, and a server whose channel
    has gone silent past ``MXNET_KVSTORE_HEARTBEAT_TIMEOUT`` counts as a
    dead node."""
    total = 0
    for obj in _live_sources():
        try:
            total += obj.num_dead_nodes()
        except Exception:  # noqa: BLE001 — a broken source is not a death
            pass
    return total


def roster_generation() -> int:
    """The elastic roster generation this process's stores converged on:
    0, the static roster (elastic membership is ROADMAP E2)."""
    return 0


def coordinator_failovers() -> int:
    """Coordinator successions ridden through: 0 until elastic
    membership (ROADMAP E2)."""
    return 0


def cluster_stats(compact: bool = False) -> dict:
    """One dict of cluster-wide observability counters
    (docs/OBSERVABILITY.md): this process's own profiler snapshot under
    ``workers[<rank>]``, every live parameter server's ``("stats",)``
    reply under ``servers[<uri>]`` — swept through the same weakref
    registry as :func:`num_dead_nodes`, so a GC'd store stops being
    consulted — and ``stats_bank``, the newest-beat-wins merge of the
    servers' last-known-counters banks, which still names members that
    have DIED (the bank outlives eviction, like the elastic state
    snapshots).  ``compact=True`` trims each entry to the transport
    families (what bench.py banks into its one-line JSON row).

    A server whose channel fails mid-sweep is skipped rather than
    failing the whole sweep: its last-known counters are usually still
    in the surviving servers' banks — that is the bank's whole point."""
    from . import profiler as _prof
    from . import tracing as _tr
    _role, rank = _tr.role_rank()   # the shared DMLC-label derivation
    out: dict = {
        "workers": {str(rank): _prof.snapshot(compact=compact)},
        "servers": {},
        "stats_bank": {},
    }
    for obj in _live_sources():
        conns = getattr(obj, "_conns", None)
        server_stats = getattr(obj, "server_stats", None)
        if conns is None or server_stats is None:
            continue
        if getattr(obj, "_closed", False):
            # a closed store lingering until gc must not be swept: its
            # channels answer nothing (request() fails fast post-close,
            # but skipping is cheaper than 2N raised errors)
            continue
        for i, c in enumerate(list(conns)):
            uri = str(getattr(c, "_uri", i))
            if uri in out["servers"]:
                continue
            try:
                st = server_stats(i)
            except MXNetError:
                continue   # dead mid-sweep: the bank below may cover it
            if not isinstance(st, dict):
                continue
            bank = st.pop("stats_bank", None) or {}
            if compact:
                st = {k: st[k] for k in ("channel", "channel_bytes",
                                         "wire", "server", "health")
                      if k in st}
            out["servers"][uri] = st
            for u, entry in bank.items():
                if not isinstance(entry, dict):
                    continue
                prev = out["stats_bank"].get(u)
                if prev is None or int(entry.get("beat_seq", 0)) >= \
                        int(prev.get("beat_seq", 0)):
                    out["stats_bank"][u] = entry
    return out


def cluster_health() -> dict:
    """One cluster-wide health verdict (docs/OBSERVABILITY.md health
    section): per-node ``OK``/``DEGRADED``/``CRITICAL`` statuses — this
    process's own, every live server's (from the health block its
    ``("stats",)`` reply carries), and the banked last-known status of
    members only the stats bank still remembers — rolled up to the
    WORST observed.  A bank member absent from the live server sweep is
    listed under ``dead`` and floors the cluster at DEGRADED (it was a
    beating member once; now nobody answers for it), as does a nonzero
    local ``num_dead_nodes()``.  Peer entries without a self-reported
    health block are evaluated against the local SLO rule thresholds
    (``health.evaluate``) so an old or minimal snapshot still gets a
    verdict instead of a silent OK.  Self-reported verdicts carry a
    wall-clock ``ts`` stamp: one older than ``MXNET_HEALTH_STALE_S``
    no longer earns an OK (``health.discount_stale``) — the discounted
    nodes are listed under ``stale``."""
    from . import health as _health
    order = {"OK": 0, "DEGRADED": 1, "CRITICAL": 2}
    # compact sweep: the health block (and the channel/wire families
    # the evaluate() fallback reads) ride the compact form — full
    # snapshots would ship every server's latency tables and event
    # rings per poll for nothing
    stats = cluster_stats(compact=True)
    nodes: dict = {}
    dead: list = []
    stale: list = []
    worst = "OK"

    def verdict(snap, name=None):
        h = snap.get("health") if isinstance(snap, dict) else None
        if isinstance(h, dict) and h.get("status") in order:
            st = h["status"]
            # discount a stale verdict: a banked block whose ts stamp
            # is past MXNET_HEALTH_STALE_S no longer earns an OK — the
            # member went silent, and silence is not health
            age = _health.verdict_age_s(h)
            discounted = _health.discount_stale(st, age)
            if discounted != st and name is not None:
                stale.append(name)
            return discounted
        st, _failed = _health.evaluate(snap if isinstance(snap, dict)
                                       else {})
        return st

    def fold(name, snap):
        nonlocal worst
        st = verdict(snap, name=name)
        nodes[name] = st
        if order[st] > order[worst]:
            worst = st

    for rank, snap in stats["workers"].items():
        fold("worker-%s" % rank, snap)
    for uri, snap in stats["servers"].items():
        fold("server-%s" % uri, snap)
    live_uris = set(stats["servers"])
    for uri, entry in stats["stats_bank"].items():
        if uri in live_uris:
            continue
        # a member the bank remembers but the live sweep cannot reach:
        # dead (or partitioned).  Its last-known status is FORENSICS
        # (shown per node), never a live verdict — a stale banked
        # CRITICAL must not escalate a repaired cluster forever, so a
        # dead member contributes exactly the DEGRADED floor
        dead.append(uri)
        nodes["dead-%s" % uri] = verdict(entry, name="dead-%s" % uri)
        if order[worst] < order["DEGRADED"]:
            worst = "DEGRADED"
    n_dead = num_dead_nodes()
    if n_dead and order[worst] < order["DEGRADED"]:
        worst = "DEGRADED"
    return {"status": worst, "nodes": nodes, "dead": sorted(dead),
            "stale": sorted(stale), "num_dead_nodes": n_dead}


def shutdown() -> None:
    global _initialized
    if not _initialized:
        return
    import torch.distributed as tdist
    try:
        tdist.destroy_process_group()
    except Exception:  # noqa: BLE001 — already torn down at interpreter exit
        pass
    _initialized = False
