"""Elastic membership: a versioned roster for the dist_async cluster.

The port's copy of ``mxnet_tpu/membership.py`` (it imports nothing of
JAX).  The distributed store uses its routing math (``stripe_plan``,
``server_index``, ``stripe_server_index``, ``wire_layout``,
``base_key``, ``sparse_route``), and elastic membership the roster,
the coordinator's ledger and the handoff arithmetic.

The transport already had every primitive needed to survive roster
churn — heartbeat liveness (``num_dead_nodes()``), deterministic
row-striping (``KVStoreDistAsync._stripe_plan``), exactly-once
envelopes with full-window replay — without ever ACTING on them: a dead
server was only *named* in a barrier failure (reference: the fixed
ps-lite roster, arXiv:1512.01274).  This module is the acting-on-them
layer, the dynamic-membership trait TensorFlow's production experience
(arXiv:1605.08695) showed separates a lab parameter server from one
that rides preemptible capacity:

* **Roster** — an epoch-numbered generation, the ordered server URI
  tuple (order IS the stripe-slot mapping) and the live worker-rank
  tuple.  Negotiated over the existing control channel; the
  COORDINATOR is slot 0 of the current generation
  (:func:`coordinator_uri` — the single source of truth both the
  server's and the worker's address derivation route through).
  Coordinator death is itself a survivable membership event: on
  coordinator silence every observer independently elects
  :func:`elect_successor` — pure arithmetic over the ordered roster,
  no votes, the same determinism trick ``stripe_plan`` uses — and the
  elected survivor rebuilds the ledger with :func:`rebuild_ledger`
  from the reports and snapshot bank it already holds.
* **Pure roster arithmetic** (this module, no sockets): stripe-plan
  derivation, wire-key layouts per server set, handoff planning
  between generations, per-stripe optimizer-state restriping.  Every
  worker computes the identical layout from the same roster with no
  coordination — determinism is the correctness argument, and
  ``tests/test_membership.py`` pins it as pure units.
* **Coordinator state machine** (:class:`MembershipCoordinator`):
  join/leave/evict with generation bumps only on actual change, so
  duplicate reports (every surviving worker races to report the same
  dead server) are idempotent.

The kvstore client (``kvstore.KVStoreDistAsync``) and server
(``kvstore_server.KVStoreServer``) own the socket halves: roster ops
ride the ordinary exactly-once envelopes, handoff values ride the same
zero-copy frames as pushes, and the server dedups handoffs
per-(wire key, generation) so duplicate delivery — the quorum re-push
by ALL workers, or a replay through a connection kill — applies once.
See docs/ROBUSTNESS.md (elastic membership) for the full protocol.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .analysis import hb as _hb

#: stripe-suffix separator, shared with the kvstore wire protocol
STRIPE_SEP = "@s"


def bank_newest(bank: Dict[str, tuple], uri: str, seq, snapshot) -> None:
    """THE snapshot-banking rule, in one place: keep the newest-seq
    snapshot per uri (ties re-bank — a re-sent equal seq is the same
    beat).  Used by the ledger bank (``note_server_beat`` /
    ``preload_snapshot``) and every server's local peer bank
    (``kvstore_server._bank_peer_snapshot``) so the three banks can
    never diverge on the tie-break or seq coercion.  Caller holds
    whatever lock guards ``bank``; a None snapshot banks nothing."""
    if snapshot is None or seq is None:
        return
    have = bank.get(uri)
    if have is None or int(seq) >= have[0]:
        bank[uri] = (int(seq), snapshot)


# ---------------------------------------------------------------------------
# Pure roster arithmetic — no sockets, no state.  Every function is
# deterministic from its arguments so every observer of the same roster
# generation derives the identical layout.
# ---------------------------------------------------------------------------
def stripe_plan(key: str, shape, num_servers: int,
                bigarray_bound: int) -> Optional[List[int]]:
    """Row boundaries for a striped key, or None for an unstriped one.
    Deterministic from (key, shape, num_servers, bound) — the single
    source of truth behind ``KVStoreDistAsync._stripe_plan`` and every
    handoff computation; two generations with the same server COUNT
    always yield the same plan."""
    if num_servers <= 1 or not shape or len(shape) == 0 \
            or int(np.prod(shape)) <= bigarray_bound or shape[0] < 2:
        return None
    parts = min(num_servers, shape[0])
    return [shape[0] * i // parts for i in range(parts + 1)]


def coordinator_uri(servers: Optional[Sequence[str]]) -> Optional[str]:
    """The coordinator of a roster: slot 0 of the CURRENT generation's
    server order (removal preserves survivor order, so succession walks
    the roster deterministically).  The single source of truth behind
    ``kvstore_server._coordinator_addr`` and the worker's
    ``_coordinator_conn`` — both used to hardcode bootstrap slot 0,
    which goes stale the moment a failover re-seats the roster."""
    if not servers:
        return None
    for u in servers:
        if u:
            return u
    return None


def elect_successor(servers: Optional[Sequence[str]],
                    dead) -> Optional[str]:
    """Deterministic coordinator succession: the first roster slot not
    known dead.  Pure arithmetic over the same ordered roster every
    observer already holds — no votes, no extra protocol (the
    ``stripe_plan`` determinism trick applied to leadership): any two
    observers of the same (roster, dead set) elect the SAME successor,
    and observers with momentarily different dead sets converge through
    the ``roster_dead`` / :func:`rebuild_ledger` path.  None when every
    server is dead (nothing left to elect)."""
    dead = set(dead or ())
    for u in servers or ():
        if u and u not in dead:
            return u
    return None


def roster_diff(old: Optional[Sequence[str]],
                new: Optional[Sequence[str]]) -> Tuple[List[str],
                                                       List[str]]:
    """``(added, removed)`` between two ordered server rosters, order-
    preserving and duplicate-free — the pure arithmetic behind roster
    OBSERVATION: the serving fleet reconciles its replica set against
    each observed generation (a removed uri gets drained, an added one
    becomes routable) without ever joining the roster itself."""
    old_set = {u for u in (old or ()) if u}
    new_set = {u for u in (new or ()) if u}
    added = [u for u in (new or ()) if u and u not in old_set]
    removed = [u for u in (old or ()) if u and u not in new_set]
    return added, removed


def host_groups(workers: Sequence[int],
                workers_per_host: int) -> List[Tuple[int, ...]]:
    """Partition worker ranks into per-host mesh groups — the pure
    arithmetic behind the hierarchical kvstore tier
    (``MXNET_KVSTORE_HIERARCHY``).  Launchers place consecutive ranks
    on one host (tools/launch.py fills each host's slots in order), so
    rank ``r`` lives in group ``r // workers_per_host``; groups come
    back sorted by their leader (lowest) rank.  Deterministic from
    (workers, per_host) with no coordination — the same trick
    :func:`stripe_plan` and :func:`elect_successor` use, applied to
    host topology."""
    per = max(1, int(workers_per_host))
    groups: Dict[int, List[int]] = {}
    for r in sorted(int(w) for w in workers):
        groups.setdefault(r // per, []).append(r)
    return [tuple(groups[g]) for g in sorted(groups)]


def mesh_group(rank: int, workers: Sequence[int],
               workers_per_host: int) -> Tuple[int, Tuple[int, ...], int]:
    """``(leader_rank, members, group_index)`` of ``rank``'s host group
    (:func:`host_groups`).  The leader — the lowest rank on the host —
    is the ONLY member that ships gradients over the TCP wire; the
    rest reduce into it in-mesh.  Raises when ``rank`` is not in
    ``workers`` (a roster that does not know this rank cannot place
    it)."""
    for gi, members in enumerate(host_groups(workers, workers_per_host)):
        if int(rank) in members:
            return members[0], members, gi
    raise ValueError(
        f"mesh_group: rank {rank} not in worker set {tuple(workers)}")


def server_index(key: str, num_servers: int) -> int:
    """crc32 routing of an unstriped key to a server slot."""
    return zlib.crc32(key.encode()) % num_servers


def stripe_server_index(key: str, i: int, num_servers: int) -> int:
    """Server slot owning stripe ``i`` of ``key``: consecutive stripes
    land on consecutive servers, offset by the key hash."""
    return (zlib.crc32(key.encode()) + i) % num_servers


def wire_layout(key: str, shape, servers: Sequence[str],
                bigarray_bound: int) -> Dict[str, Tuple[str, int, int]]:
    """The full wire placement of one logical key against one server
    set: ``{wire_key: (server_uri, row_start, row_stop)}``.  For an
    unstriped key the row span is the whole leading axis (or (0, 0)
    for scalars)."""
    n = len(servers)
    plan = stripe_plan(key, shape, n, bigarray_bound)
    if plan is None:
        rows = int(shape[0]) if shape else 0
        return {key: (servers[server_index(key, n)], 0, rows)}
    out = {}
    for i in range(len(plan) - 1):
        out[f"{key}{STRIPE_SEP}{i}"] = (
            servers[stripe_server_index(key, i, n)], plan[i], plan[i + 1])
    return out


def base_key(wire_key: str) -> str:
    """The logical key behind a wire key (stripe suffix stripped)."""
    if STRIPE_SEP in wire_key:
        base, _, idx = wire_key.rpartition(STRIPE_SEP)
        if idx.isdigit():
            return base
    return wire_key


def sparse_route(plan: List[int], indices: np.ndarray
                 ) -> List[Tuple[int, np.ndarray, np.ndarray]]:
    """Route sorted row ids onto a stripe plan: ``[(stripe_index,
    local_ids, positions)]`` for the NON-empty stripes only — a sparse
    push/pull skips every stripe its batch never touched, which is the
    whole wire win.  ``local_ids`` are the ids rebased to the stripe's
    row 0; ``positions`` index back into ``indices`` (and the caller's
    row block).  Deterministic from (plan, indices) under the same
    contract as :func:`stripe_plan`."""
    idx = np.asarray(indices, dtype=np.int64)
    stripe_of = np.searchsorted(plan, idx, side="right") - 1
    out = []
    for i in range(len(plan) - 1):
        pos = np.nonzero(stripe_of == i)[0]
        if pos.size:
            out.append((i, idx[pos] - plan[i], pos))
    return out


def moved_row_spans(key: str, shape, old_servers: Sequence[str],
                    new_servers: Sequence[str],
                    bigarray_bound: int) -> List[Tuple[int, int]]:
    """The row spans of ``key`` whose OWNING server changes between two
    rosters: merged, sorted, half-open ``[(lo, hi)]``.  The pure
    arithmetic behind per-row residual invalidation — a restripe must
    drop exactly the error-feedback rows that moved to a different
    server (their un-drained error belongs to the OLD owner's applied
    history) and keep every row that stayed put."""
    old = wire_layout(key, shape, old_servers, bigarray_bound)
    new = wire_layout(key, shape, new_servers, bigarray_bound)
    rows = int(shape[0]) if shape else 0
    cuts = {0, rows}
    for _, lo, hi in list(old.values()) + list(new.values()):
        cuts.add(min(max(lo, 0), rows))
        cuts.add(min(max(hi, 0), rows))
    cuts = sorted(cuts)

    def owner_at(layout, row):
        for uri, lo, hi in layout.values():
            if lo <= row < hi:
                return uri
        return None

    moved: List[Tuple[int, int]] = []
    for lo, hi in zip(cuts, cuts[1:]):
        if lo >= hi:
            continue
        if owner_at(old, lo) != owner_at(new, lo):
            if moved and moved[-1][1] == lo:
                moved[-1] = (moved[-1][0], hi)
            else:
                moved.append((lo, hi))
    return moved


def plan_handoff(key_shapes: Dict[str, tuple], old_servers: Sequence[str],
                 new_servers: Sequence[str],
                 bigarray_bound: int) -> List[str]:
    """The logical keys whose wire layout CHANGES between two server
    sets — the keys that need a state handoff on this roster bump.  A
    key whose every wire key maps to the same URI with the same row
    span needs nothing (its owning server survived in the same slot
    role); everything else is re-pushed under the new layout."""
    moved = []
    for key, shape in key_shapes.items():
        old = wire_layout(key, shape, old_servers, bigarray_bound)
        new = wire_layout(key, shape, new_servers, bigarray_bound)
        if old != new:
            moved.append(key)
    return moved


def restripe_value(key: str, value: np.ndarray, servers: Sequence[str],
                   bigarray_bound: int) -> List[Tuple[str, str, np.ndarray]]:
    """Slice one full key value into its new-layout handoff pushes:
    ``[(wire_key, server_uri, row_slice)]`` in stripe order."""
    out = []
    layout = wire_layout(key, value.shape, servers, bigarray_bound)
    for wk, (uri, lo, hi) in layout.items():
        out.append((wk, uri,
                    value if wk == key else value[lo:hi]))
    return out


def _concat_states(parts):
    """Concatenate per-stripe optimizer states along axis 0.  States are
    the shapes ``optimizer.create_state`` produces: an ndarray shaped
    like the weight stripe, a tuple/list of those (momentum pairs), or
    None (stateless).  Anything else is not row-decomposable and maps
    to None (the optimizer re-creates fresh state — the documented
    restriping caveat for non-elementwise state)."""
    if all(p is None for p in parts):
        return None
    if all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts, axis=0)
    if all(isinstance(p, (tuple, list)) for p in parts) \
            and len({len(p) for p in parts}) == 1:
        cols = []
        for items in zip(*parts):
            cols.append(_concat_states(list(items)))
        return tuple(cols)
    return None


def _slice_state(state, lo, hi):
    if state is None:
        return None
    if isinstance(state, np.ndarray):
        return state[lo:hi]
    if isinstance(state, (tuple, list)):
        return tuple(_slice_state(s, lo, hi) for s in state)
    return None


def restripe_states(key: str, per_wire_states: Dict[str, object],
                    old_plan: Optional[List[int]],
                    new_plan: Optional[List[int]]):
    """Re-key per-stripe optimizer state from one plan to another:
    merge the old stripes' states (concatenating leading-axis arrays),
    then re-slice along the NEW plan.  Returns ``{wire_key: state}``
    under the new plan, or {} when the old stripes don't cover the full
    key (a partial snapshot cannot be restriped soundly — the optimizer
    re-creates state for the missing rows instead of training on a
    silently misaligned merge).

    Elementwise optimizers (SGD/Adam: state shaped like the weight)
    restripe EXACTLY; per-layer state (LARS/LAMB norms) is not
    row-decomposable and comes back None per stripe — the same caveat
    striping itself carries."""
    if old_plan is None:
        parts = [per_wire_states.get(key)]
        spans = [(0, None)]
    else:
        parts, spans = [], []
        for i in range(len(old_plan) - 1):
            wk = f"{key}{STRIPE_SEP}{i}"
            if wk not in per_wire_states:
                return {}
            parts.append(per_wire_states[wk])
            spans.append((old_plan[i], old_plan[i + 1]))
    merged = _concat_states(parts)
    if new_plan is None:
        return {key: merged}
    out = {}
    for i in range(len(new_plan) - 1):
        out[f"{key}{STRIPE_SEP}{i}"] = _slice_state(
            merged, new_plan[i], new_plan[i + 1])
    return out


# ---------------------------------------------------------------------------
# Coordinator state machine (lives inside server 0 of the roster)
# ---------------------------------------------------------------------------
class Roster:
    """One immutable roster generation."""

    __slots__ = ("generation", "servers", "workers")

    def __init__(self, generation: int, servers: Tuple[str, ...],
                 workers: Tuple[int, ...]):
        self.generation = int(generation)
        self.servers = tuple(servers)
        self.workers = tuple(sorted(workers))

    def as_wire(self):
        return (self.generation, list(self.servers), list(self.workers))

    def __repr__(self):
        return (f"Roster(gen={self.generation}, servers={self.servers}, "
                f"workers={self.workers})")


class MembershipCoordinator:
    """Epoch-numbered membership ledger (server 0 owns one instance).

    Every mutation bumps the generation ONLY on actual change, so the
    surviving workers' racing reports of the same dead server collapse
    into one bump; removal preserves the surviving servers' relative
    order, so every observer of generation G derives the identical
    stripe-slot mapping.  Thread-safe; the lock is a leaf (no calls out
    while held) so it can never join a lock cycle with the server's
    store lock or barrier condition."""

    def __init__(self, servers: Sequence[str], workers: Sequence[int]):
        self._lock = threading.Lock()
        self._generation = 0
        self._servers: List[str] = list(dict.fromkeys(servers))
        self._workers = set(int(w) for w in workers)
        self._server_seen: Dict[str, float] = _hb.track(
            {}, "MembershipCoordinator._server_seen")
        # uri -> (seq, blob); hb-tracked like the server-side banks
        self._snapshots: Dict[str, tuple] = _hb.track(
            {}, "MembershipCoordinator._snapshots")
        # last-known compact profiler counters per server, piggybacked
        # on beats (kvstore_server beat loop) — same newest-seq-wins
        # rule and same outlives-eviction contract as the state
        # snapshots: the counters of a SIGKILLed member stay readable
        # through the coordinator's "stats" envelope
        self._stats: Dict[str, tuple] = _hb.track(
            {}, "MembershipCoordinator._stats")   # uri -> (seq, counters)
        self.evictions = 0
        self.failovers = 0   # ledgers this one succeeded (rebuild_ledger)

    # -- views ---------------------------------------------------------------
    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def roster(self) -> Roster:
        with self._lock:
            return Roster(self._generation, tuple(self._servers),
                          tuple(self._workers))

    def workers_snapshot(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._workers))

    # -- mutations (generation bumps only on change) -------------------------
    def join_server(self, uri: str) -> int:
        with self._lock:
            if uri not in self._servers:
                self._servers.append(uri)
                self._generation += 1
            self._server_seen[uri] = time.monotonic()
            return self._generation

    def leave_server(self, uri: str) -> int:
        return self._remove_server(uri, evict=False)

    def report_dead_server(self, uri: str) -> int:
        return self._remove_server(uri, evict=True)

    def _remove_server(self, uri: str, evict: bool) -> int:
        with self._lock:
            if uri in self._servers:
                if len(self._servers) <= 1:
                    raise RuntimeError(
                        "cannot remove the last server (the coordinator "
                        "itself) from the roster")
                self._servers.remove(uri)
                self._server_seen.pop(uri, None)
                self._generation += 1
                if evict:
                    self.evictions += 1
            return self._generation

    def join_worker(self, rank: int) -> int:
        with self._lock:
            rank = int(rank)
            if rank not in self._workers:
                self._workers.add(rank)
                self._generation += 1
            return self._generation

    def leave_worker(self, rank: int) -> int:
        return self._remove_worker(rank, evict=False)

    def evict_worker(self, rank: int) -> int:
        return self._remove_worker(rank, evict=True)

    def _remove_worker(self, rank: int, evict: bool) -> int:
        with self._lock:
            rank = int(rank)
            if rank in self._workers:
                self._workers.discard(rank)
                self._generation += 1
                if evict:
                    self.evictions += 1
            return self._generation

    # -- server liveness + state snapshots -----------------------------------
    def note_server_beat(self, uri: str, seq: Optional[int] = None,
                         snapshot=None, stats=None) -> None:
        with self._lock:
            if uri in self._servers:
                self._server_seen[uri] = time.monotonic()
            bank_newest(self._snapshots, uri, seq, snapshot)
            bank_newest(self._stats, uri, seq, stats)

    def preload_snapshot(self, uri: str, seq: int, snapshot) -> None:
        """Seed the snapshot bank without touching liveness — the
        failover path: the elected successor promotes its LOCAL peer
        bank (grown from the beat fan-out) into the rebuilt ledger.
        Same newest-seq-wins rule as :meth:`note_server_beat`
        (:func:`bank_newest` is the one implementation both share)."""
        with self._lock:
            bank_newest(self._snapshots, uri, seq, snapshot)

    def snapshot_of(self, uri: str):
        """The last state snapshot a (possibly now-dead) server shipped,
        or None.  Snapshots OUTLIVE eviction on purpose — they are the
        killed-server recovery source."""
        with self._lock:
            have = self._snapshots.get(uri)
            return None if have is None else have[1]

    def stats_of(self, uri: str):
        """The last compact counter snapshot a (possibly now-dead)
        server piggybacked on a beat, or None.  Outlives eviction like
        :meth:`snapshot_of` — the forensic record of what a killed
        member was doing when it died."""
        with self._lock:
            have = self._stats.get(uri)
            return None if have is None else have[1]

    def stats_bank(self) -> Dict[str, tuple]:
        """The whole stats bank, ``{uri: (beat_seq, counters)}`` — what
        the coordinator folds into its ``("stats",)`` reply so a
        cluster sweep sees dead members' last-known counters too."""
        with self._lock:
            return dict(self._stats)

    def silent_servers(self, timeout: float) -> List[str]:
        """Non-coordinator servers heard from at least once and then
        silent past ``timeout`` (same never-heard-never-dead contract as
        worker liveness)."""
        if timeout <= 0:
            return []
        now = time.monotonic()
        with self._lock:
            return [u for u in self._servers[1:]
                    if u in self._server_seen
                    and now - self._server_seen[u] > timeout]


def rebuild_ledger(servers: Sequence[str], workers: Sequence[int],
                   reports: Sequence[dict],
                   snapshots: Optional[Dict[str, tuple]] = None
                   ) -> MembershipCoordinator:
    """Rebuild the coordinator ledger on the elected successor — pure
    merge over the three sources the successor already has or can
    demand: its own last-seen roster (``servers``/``workers``, carried
    on every beat reply and barrier exchange), the ``ledger_report``
    sweep of the survivors (each ships its last-known generation, beat
    seq and live key set), and the local peer snapshot bank (grown from
    the beat fan-out, so it outlives server 0).

    Merge rules (pinned socket-free by tests/test_membership.py) — the
    ONLY report field the merge consumes is ``generation``; beat seqs
    and key sets ride the full (non-slim) report for operator
    forensics, never as merge inputs:

    * the generation resumes at ``max(reported generations) + 1`` —
      every envelope a stale coordinator (or a worker still converged
      on its roster) stamped with an older generation is rejected by
      the EXISTING per-generation staleness checks (handoff dedup,
      barrier-reply bump discovery), no new wire checks needed;
    * duplicate reports are idempotent (the merge is a max over a set —
      every survivor racing to report changes nothing twice);
    * reports never ADD servers the successor's roster view lacks: an
      unknown reporter re-joins through the ordinary join path, it is
      not grandfathered into slot arithmetic mid-rebuild;
    * missing snapshots stay missing — the bank never invents state, so
      a later restripe of an unbanked dead server degrades to fresh
      state exactly like :func:`restripe_states`' partial-snapshot
      refusal, instead of training on fabricated momentum."""
    gen = 0
    for r in reports or ():
        try:
            gen = max(gen, int(r.get("generation", 0)))
        except (AttributeError, TypeError, ValueError):
            continue
    m = MembershipCoordinator(servers, workers)
    with m._lock:
        m._generation = gen + 1
    m.failovers = 1
    for uri, entry in (snapshots or {}).items():
        if entry is None:
            continue
        seq, snap = entry
        m.preload_snapshot(uri, seq, snap)
    return m
