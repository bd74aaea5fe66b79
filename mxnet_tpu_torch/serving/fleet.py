"""Fleet-grade serving: a health-routed replica-set client.

PyTorch counterpart of ``mxnet_tpu/serving/fleet.py`` (pure Python over
the port's client; the replicas it routes to may be of either package,
since both speak the same frames).

One :class:`FleetClient` over N :class:`~mxnet_tpu_torch.serving.
ServingReplica`s makes replica death, degradation and overload
invisible to callers — the TF-Serving shape (arXiv:1605.08695: cheap
stateless routing over health-checked model servers with versioned
canary/rollback) built on the parameter-server transport this package
already made fault tolerant.

**Scoreboard.**  Every replica has a scoreboard entry fed by three
existing signals, none invented for routing:

* the transport heartbeat (``ServingClient.is_dead()`` — silence past
  ``MXNET_KVSTORE_HEARTBEAT_TIMEOUT``),
* the ``serving_stats`` reply's health verdict (OK/DEGRADED/CRITICAL
  with hysteresis) + queue depth + draining flag, discounted by
  the verdict's wall-clock ``ts`` age (``health.discount_stale`` — a
  silent replica's last OK is not a live OK),
* per-request evidence: typed BUSY sheds, connection failures, and
  reply TIMEOUTS — the only signal that catches a gray-failed replica
  that accepts requests, acks heartbeats, and never answers.

A replica whose probe/attempt failed is QUARANTINED (ineligible) until
a scoreboard poll reaches it again — routing never waits on a corpse
to prove itself dead twice.

**Routing.**  Weighted least-loaded: score = (client in-flight +
replica queue depth + 1), multiplied by
``MXNET_SERVING_FLEET_DEGRADED_PENALTY`` for DEGRADED replicas (they
still serve, just less), ties broken round-robin.  CRITICAL, dead,
quarantined and draining replicas are excluded outright.

**Retries.**  Predict is PURE (the replica runs it outside the
exactly-once dedup window for the same reason), so a cross-replica
retry can never double-apply.  BusyError, connection failures and
reply timeouts retry against a DIFFERENT replica under a per-request
deadline (``MXNET_SERVING_FLEET_DEADLINE_S``) and retry budget
(``MXNET_SERVING_FLEET_RETRIES``) with capped, jittered exponential
backoff.  Budget exhaustion surfaces the LAST error, naming every
attempted replica.  The clock, sleep and RNG are injectable, so the
backoff schedule is testable without a single real sleep.

**Drain.**  ``drain(uri)`` sends the operator ``("drain",)`` envelope
and stops routing there (in-flight work completes);
``observe_roster(servers)`` reconciles against an observed membership
roster via :func:`mxnet_tpu_torch.membership.roster_diff` — a departed uri
drains, a joined one becomes routable.

**Canary.**  ``start_canary([uri], fraction)`` refreshes the canary
cohort to the newly published weight version (serve N-1 while N warms)
and routes the configured fraction of requests there with the
canary-tagged predict op.  Every completed attempt lands a
(latency, ok) sample in its cohort's sliding window; once both cohorts
have ``MXNET_SERVING_FLEET_CANARY_MIN_N`` samples, a canary p99 above
baseline x ``_CANARY_P99_X`` — or a canary error rate above baseline x
``_CANARY_ERR_X`` (+1% absolute) — AUTO-ROLLS BACK: the canary cohort
drains, traffic returns to N-1, and the rollback lands in the health
flight recorder (``canary_rollback``) with both cohorts' numbers.
``promote_canary()`` is the happy path: refresh everyone to N.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from ..analysis import hb as _hb
from ..base import MXNetError, env
from .. import health as _health
from .. import profiler as _prof
from ..membership import roster_diff
from .batcher import BusyError
from .client import PredictTimeout, ServingClient

#: scoreboard states (health verdicts plus the fleet-only lifecycle
#: states — DEAD covers heartbeat silence, quarantine and dial failure)
OK, DEGRADED, CRITICAL = "OK", "DEGRADED", "CRITICAL"
DEAD, DRAINING = "DEAD", "DRAINING"


class FleetError(MXNetError):
    """A fleet predict that exhausted its retry budget or deadline —
    the message names every attempted replica and carries the LAST
    underlying error (also chained as ``__cause__``)."""


class _Replica:
    """One scoreboard entry (mutated under FleetClient._lock)."""

    def __init__(self, uri: str):
        self.uri = uri
        self.client: Optional[ServingClient] = None
        self.inflight = 0          # this client's outstanding attempts
        self.routes = 0            # attempts routed here (lifetime)
        self.busy = 0              # BUSY sheds observed
        self.timeouts = 0          # reply timeouts observed
        self.conn_errors = 0       # dial/transport failures observed
        self.verdict = OK          # last health verdict (stale-discounted)
        self.verdict_age_s = None  # age of that verdict's ts stamp
        self.queue_depth = 0
        self.queue_limit = 1
        self.version = None
        self.draining = False      # operator/roster drain (no NEW work)
        self.remote_draining = False   # replica's own advisory flag,
        #                                synced (both ways) by the poll
        self.quarantined = False   # failed attempt/probe; poll clears
        self.canary = False        # member of the canary cohort

    def is_draining(self) -> bool:
        return self.draining or self.remote_draining

    def state(self) -> str:
        if self.quarantined or (self.client is not None
                                and self.client.is_dead()):
            return DEAD
        if self.is_draining():
            return DRAINING
        return self.verdict


class FleetClient:
    """Health-routed client over N serving replicas (module docstring
    has the full policy).  ``clock``/``sleep``/``rng`` are injectable
    for deterministic retry/backoff tests."""

    def __init__(self, uris: Sequence[str], window=None,
                 connect_timeout: float = 10.0, retries=None,
                 deadline_s=None, attempt_s=None, backoff_ms=None,
                 backoff_max_ms=None, jitter=None, stats_interval=None,
                 stale_s=None, degraded_penalty=None,
                 canary_fraction=None, canary_min_n=None,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 rng: Optional[random.Random] = None):
        if not uris:
            raise MXNetError("a serving fleet needs at least one "
                             "replica uri")
        self._window = window
        self._connect_timeout = float(connect_timeout)
        self._retries = int(env("MXNET_SERVING_FLEET_RETRIES", 3)
                            if retries is None else retries)
        self._deadline_s = float(
            env("MXNET_SERVING_FLEET_DEADLINE_S", 30.0)
            if deadline_s is None else deadline_s)
        self._attempt_s = float(
            env("MXNET_SERVING_FLEET_ATTEMPT_S", 5.0)
            if attempt_s is None else attempt_s)
        self._backoff_s = float(
            env("MXNET_SERVING_FLEET_BACKOFF_MS", 10.0)
            if backoff_ms is None else backoff_ms) / 1000.0
        self._backoff_cap_s = float(
            env("MXNET_SERVING_FLEET_BACKOFF_MAX_MS", 500.0)
            if backoff_max_ms is None else backoff_max_ms) / 1000.0
        self._jitter = float(env("MXNET_SERVING_FLEET_JITTER", 0.5)
                             if jitter is None else jitter)
        self._stats_s = float(env("MXNET_SERVING_FLEET_STATS_S", 1.0)
                              if stats_interval is None
                              else stats_interval)
        self._stale_s = (None if stale_s is None else float(stale_s))
        self._penalty = float(
            env("MXNET_SERVING_FLEET_DEGRADED_PENALTY", 4.0)
            if degraded_penalty is None else degraded_penalty)
        self._canary_fraction = float(
            env("MXNET_SERVING_FLEET_CANARY_FRACTION", 0.1)
            if canary_fraction is None else canary_fraction)
        self._canary_min_n = int(
            env("MXNET_SERVING_FLEET_CANARY_MIN_N", 32)
            if canary_min_n is None else canary_min_n)
        self._canary_p99_x = float(
            env("MXNET_SERVING_FLEET_CANARY_P99_X", 2.0))
        self._canary_err_x = float(
            env("MXNET_SERVING_FLEET_CANARY_ERR_X", 2.0))
        self._clock = clock
        self._sleep = sleep
        self._rng = rng if rng is not None else random.Random()
        self._lock = threading.Lock()
        # the scoreboard is read by every route() and mutated by the
        # poll loop + roster updates: identity in production, a
        # race-checked wrapper under the hb shim
        self._entries: Dict[str, _Replica] = _hb.track(
            {str(u): _Replica(str(u)) for u in uris},
            "fleet.HealthRoutedClient._entries")
        self._rr = 0               # round-robin tie-breaker
        self._canary_active = False
        self._cohorts = {c: {"lat": deque(maxlen=512), "n": 0, "err": 0}
                         for c in ("canary", "baseline")}
        self.last_rollback: Optional[dict] = None
        self._stop = threading.Event()
        self._poll_thread = None
        if self._stats_s > 0:
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True)
            self._poll_thread.start()

    # -- scoreboard ----------------------------------------------------------
    def _client_for(self, entry: _Replica) -> ServingClient:
        """Dial lazily; a dial failure quarantines the entry (the poll
        loop re-probes) and surfaces as a retryable conn error."""
        with self._lock:
            if entry.client is not None:
                return entry.client
        client = ServingClient(entry.uri, window=self._window,
                               connect_timeout=self._connect_timeout)
        with self._lock:
            if entry.client is None:
                entry.client = client
                return client
        client.close()          # lost the race; one client per replica
        return entry.client

    def poll_once(self) -> dict:
        """One scoreboard sweep: every replica answers serving_stats
        (bounded by the per-attempt timeout) or gets quarantined.
        Returns {uri: state} after the sweep — the deterministic form
        of the background poll, and the only way a quarantined replica
        re-earns eligibility."""
        for entry in list(self._entries.values()):
            try:
                st = self._client_for(entry).stats(
                    timeout=self._attempt_s)
            except (MXNetError, ConnectionError, OSError):
                with self._lock:
                    entry.quarantined = True
                    poisoned, entry.client = entry.client, None
                if poisoned is not None:
                    try:
                        poisoned.abort()
                    except (MXNetError, OSError):
                        pass
                continue
            block = st.get("health")
            age = _health.verdict_age_s(block)
            verdict = (block or {}).get("status", OK)
            if verdict not in (OK, DEGRADED, CRITICAL):
                verdict = OK
            verdict = _health.discount_stale(verdict, age, self._stale_s)
            with self._lock:
                entry.quarantined = False
                entry.verdict = verdict
                entry.verdict_age_s = age
                entry.queue_depth = int(st.get("queue_depth", 0))
                entry.queue_limit = int(st.get("queue_limit", 1))
                entry.version = st.get("version")
                # the replica's own advisory drain flag: an operator
                # (possibly on ANOTHER fleet) drained or undrained it
                # directly — every poll observes the current truth
                entry.remote_draining = bool(st.get("draining"))
        return {u: e.state() for u, e in self._entries.items()}

    def _poll_loop(self):
        while not self._stop.wait(self._stats_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poll must survive
                _prof.record_channel_event("fleet.poll_error")

    def scoreboard(self) -> dict:
        """{uri: entry dict} — the routing view, for operators and
        tests (states: OK/DEGRADED/CRITICAL/DEAD/DRAINING)."""
        with self._lock:
            return {u: {
                "state": e.state(),
                "verdict": e.verdict,
                "verdict_age_s": e.verdict_age_s,
                "queue_depth": e.queue_depth,
                "inflight": e.inflight,
                "routes": e.routes,
                "busy": e.busy,
                "timeouts": e.timeouts,
                "conn_errors": e.conn_errors,
                "draining": e.is_draining(),
                "quarantined": e.quarantined,
                "canary": e.canary,
                "version": e.version,
            } for u, e in self._entries.items()}

    # -- routing -------------------------------------------------------------
    def _eligible(self, cohort: Optional[str]) -> List[_Replica]:
        """Routable replicas (caller holds _lock): never CRITICAL,
        dead, quarantined or draining; restricted to the request's
        cohort while a canary is active and the cohort has survivors."""
        out = []
        for e in self._entries.values():
            st = e.state()
            if st in (DEAD, DRAINING, CRITICAL):
                continue
            out.append(e)
        if cohort is not None:
            want = cohort == "canary"
            cohort_live = [e for e in out if e.canary == want]
            if cohort_live:
                return cohort_live
            # the whole cohort is sick: availability beats the split —
            # fall through to anyone eligible
        return out

    def _route(self, exclude, cohort: Optional[str]) -> _Replica:
        """Weighted-least-loaded pick.  ``exclude`` holds the uris this
        request already failed on — preferred away from, but allowed
        again when they are the only survivors (a retry against the
        same replica still beats a guaranteed failure)."""
        with self._lock:
            cands = self._eligible(cohort)
            fresh = [e for e in cands if e.uri not in exclude]
            pool = fresh or cands
            if not pool:
                raise FleetError(
                    "no eligible serving replica (states: %s)"
                    % {u: e.state() for u, e in self._entries.items()})

            def score(e):
                s = float(e.inflight + e.queue_depth + 1)
                if e.verdict == DEGRADED:
                    s *= self._penalty
                return s

            best = min(score(e) for e in pool)
            tied = [e for e in pool if score(e) == best]
            self._rr += 1
            entry = tied[self._rr % len(tied)]
            entry.inflight += 1
            entry.routes += 1
        _prof.record_channel_event("fleet.route")
        _prof.record_channel_event("fleet.route:%s" % entry.uri)
        return entry

    # -- the request path ----------------------------------------------------
    def predict(self, data, name: str = "data"):
        """Routed, retried, deadline-bounded predict; returns the
        output list.  BusyError / connection failure / reply timeout
        retries on a different replica (predict is pure); budget or
        deadline exhaustion raises :class:`FleetError` naming every
        attempted replica with the LAST error chained."""
        deadline = self._clock() + self._deadline_s
        cohort = None
        if self._canary_active:
            cohort = ("canary"
                      if self._rng.random() < self._canary_fraction
                      else "baseline")
        attempted: List[str] = []
        last_exc: Optional[BaseException] = None
        attempt = 0
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                raise self._exhausted("deadline %.3fs" % self._deadline_s,
                                      attempted, last_exc)
            try:
                entry = self._route(set(attempted), cohort)
            except FleetError:
                if not attempted:
                    raise      # nothing routable from the start
                # mid-retry the pool dried up (e.g. the last survivor
                # was just quarantined): still name the attempts and
                # chain what actually went wrong
                raise self._exhausted("eligible-replica pool",
                                      attempted, last_exc)
            sample_cohort = ("canary" if entry.canary else "baseline") \
                if self._canary_active else None
            t0 = self._clock()
            try:
                fut = self._client_for(entry).predict_async(
                    data, name=name, canary=entry.canary)
                outs = fut.get(timeout=min(self._attempt_s, remaining))
            except BusyError as exc:
                self._attempt_failed(entry, exc, sample_cohort, t0)
            except PredictTimeout as exc:
                self._attempt_failed(entry, exc, sample_cohort, t0,
                                     quarantine=True)
            except (MXNetError, ConnectionError, OSError) as exc:
                self._attempt_failed(entry, exc, sample_cohort, t0,
                                     quarantine=True)
            else:
                dur = self._clock() - t0
                with self._lock:
                    entry.inflight -= 1
                _prof.record_latency("fleet.request", dur)
                if sample_cohort is not None:
                    self._note_sample(sample_cohort, dur, ok=True)
                return outs
            last_exc = self._last_exc
            attempted.append(entry.uri)
            attempt += 1
            if attempt > self._retries:
                raise self._exhausted(
                    "retry budget (%d retries)" % self._retries,
                    attempted, last_exc)
            # capped exponential backoff with jitter, never past the
            # deadline; with jitter=0 and an injected clock the sleep
            # schedule is EXACTLY base * 2^k capped — what the
            # determinism tests pin
            delay = min(self._backoff_s * (2.0 ** (attempt - 1)),
                        self._backoff_cap_s)
            if self._jitter > 0:
                delay *= 1.0 + self._jitter * (2.0 * self._rng.random()
                                               - 1.0)
            delay = max(0.0, min(delay, deadline - self._clock()))
            _prof.record_channel_event("fleet.retry")
            if delay > 0:
                self._sleep(delay)

    def _attempt_failed(self, entry: _Replica, exc, sample_cohort, t0,
                        quarantine: bool = False):
        dur = self._clock() - t0
        poisoned = None
        with self._lock:
            entry.inflight -= 1
            if isinstance(exc, BusyError):
                entry.busy += 1
            elif isinstance(exc, PredictTimeout):
                entry.timeouts += 1
            else:
                entry.conn_errors += 1
            if quarantine and not entry.quarantined:
                entry.quarantined = True
                # a conn that timed out or faulted is suspect for good:
                # a swallowed reply misaligns its FIFO ack window, so
                # REPLACE it — the probe that lifts the quarantine
                # re-dials fresh (ServingClient.abort docstring)
                poisoned, entry.client = entry.client, None
                _health.note("fleet_quarantine", uri=entry.uri,
                             error=type(exc).__name__)
        if poisoned is not None:
            try:
                poisoned.abort()
            except (MXNetError, OSError):
                pass
        kind = ("fleet.busy" if isinstance(exc, BusyError)
                else "fleet.timeout" if isinstance(exc, PredictTimeout)
                else "fleet.conn_error")
        _prof.record_channel_event(kind)
        if sample_cohort is not None:
            self._note_sample(sample_cohort, dur, ok=False)
        self._last_exc = exc

    def _exhausted(self, what: str, attempted: List[str],
                   last_exc) -> FleetError:
        tried = ", ".join(attempted) or "<none>"
        if last_exc is None:
            return FleetError(
                f"fleet predict exhausted its {what} before any "
                f"replica could be attempted (tried: {tried})")
        err = FleetError(
            f"fleet predict exhausted its {what} after "
            f"{len(attempted)} attempt(s) across replicas [{tried}]; "
            f"last error from {attempted[-1]}: "
            f"{type(last_exc).__name__}: {last_exc}")
        err.__cause__ = last_exc
        return err

    # -- drain / roster observation ------------------------------------------
    def drain(self, uri: str, wire: bool = True,
              timeout: Optional[float] = None) -> None:
        """Operator drain: stop routing NEW work to ``uri`` (in-flight
        completes).  ``wire=True`` also flips the replica's advisory
        drain flag so every other fleet observes it on its next poll."""
        entry = self._require(uri)
        with self._lock:
            entry.draining = True
        _prof.record_channel_event("fleet.drain")
        _health.note("fleet_drain", uri=uri)
        if wire:
            try:
                self._client_for(entry).drain(
                    True, timeout=timeout or self._attempt_s)
            except (MXNetError, ConnectionError, OSError):
                pass   # the local exclusion already holds

    def undrain(self, uri: str, wire: bool = True,
                timeout: Optional[float] = None) -> None:
        """Return a drained replica to the routable pool."""
        entry = self._require(uri)
        with self._lock:
            entry.draining = False
        _prof.record_channel_event("fleet.undrain")
        if wire:
            try:
                self._client_for(entry).drain(
                    False, timeout=timeout or self._attempt_s)
            except (MXNetError, ConnectionError, OSError):
                pass

    def observe_roster(self, servers: Sequence[str]) -> dict:
        """Reconcile the fleet against an observed membership roster
        (:func:`membership.roster_diff`): a uri that LEFT the roster is
        drained (no wire op — it is leaving or gone), a new one becomes
        a routable entry.  Returns {"added": [...], "removed": [...]}."""
        with self._lock:
            current = [u for u, e in self._entries.items()
                       if not e.draining]
        added, removed = roster_diff(current, servers)
        for uri in removed:
            entry = self._entries.get(uri)
            if entry is not None:
                with self._lock:
                    entry.draining = True
                _prof.record_channel_event("fleet.drain")
                _health.note("fleet_drain", uri=uri,
                             reason="roster_departure")
        for uri in added:
            with self._lock:
                if uri not in self._entries:
                    self._entries[uri] = _Replica(uri)
        return {"added": added, "removed": removed}

    def _require(self, uri: str) -> _Replica:
        entry = self._entries.get(str(uri))
        if entry is None:
            raise MXNetError(f"replica {uri!r} is not part of this "
                             f"fleet: {sorted(self._entries)}")
        return entry

    # -- canary / rollback ---------------------------------------------------
    @property
    def canary_active(self) -> bool:
        return self._canary_active

    def start_canary(self, uris: Sequence[str], fraction=None,
                     refresh: bool = True,
                     timeout: Optional[float] = None) -> dict:
        """Designate ``uris`` as the canary cohort and (by default)
        force their weight refresh NOW, so they serve the newly
        published version N while the baseline keeps N-1.  The
        configured fraction of requests routes to the cohort with the
        canary-tagged predict op; both cohorts' SLO windows restart
        empty.  Returns {uri: refresh reply | None}."""
        uris = [str(u) for u in uris]
        for u in uris:
            self._require(u)
        if fraction is not None:
            self._canary_fraction = float(fraction)
        replies = {}
        for u in uris:
            entry = self._entries[u]
            if refresh:
                replies[u] = self._client_for(entry).refresh(
                    timeout=timeout or self._attempt_s)
            else:
                replies[u] = None
        with self._lock:
            for e in self._entries.values():
                e.canary = e.uri in uris
            for c in self._cohorts.values():
                c["lat"].clear()
                c["n"] = 0
                c["err"] = 0
            self._canary_active = True
            self.last_rollback = None
        _prof.record_channel_event("fleet.canary_start")
        _health.note("canary_start", uris=uris,
                     fraction=self._canary_fraction)
        return replies

    def _note_sample(self, cohort: str, dur_s: float, ok: bool):
        with self._lock:
            if not self._canary_active:
                return
            c = self._cohorts[cohort]
            c["n"] += 1
            if ok:
                c["lat"].append(float(dur_s))
            else:
                c["err"] += 1
            regression = (cohort == "canary"
                          and self._canary_regressed())
        if regression:
            self._rollback()

    def _canary_regressed(self) -> Optional[dict]:
        """Caller holds _lock.  The SLO comparison: canary vs baseline
        cohort, only once BOTH have the minimum sample count."""
        can, base = self._cohorts["canary"], self._cohorts["baseline"]
        if can["n"] < self._canary_min_n or \
                base["n"] < self._canary_min_n:
            return None
        can_err = can["err"] / can["n"]
        base_err = base["err"] / base["n"]
        can_p99 = _p99(can["lat"])
        base_p99 = _p99(base["lat"])
        reasons = []
        if can_err > base_err * self._canary_err_x + 0.01:
            reasons.append("error_rate")
        if base_p99 is not None and can_p99 is not None \
                and can_p99 > base_p99 * self._canary_p99_x:
            reasons.append("p99")
        if not reasons:
            return None
        return {"reasons": reasons,
                "canary_p99_ms": _ms(can_p99),
                "baseline_p99_ms": _ms(base_p99),
                "canary_err_rate": round(can_err, 4),
                "baseline_err_rate": round(base_err, 4),
                "canary_n": can["n"], "baseline_n": base["n"]}

    def _rollback(self):
        """Auto-rollback: drain the canary cohort, return all traffic
        to the N-1 baseline, and put the event on the flight recorder
        with both cohorts' numbers — the forensics a paged operator
        reads first."""
        with self._lock:
            detail = self._canary_regressed()
            if not self._canary_active or detail is None:
                return
            self._canary_active = False
            self.last_rollback = detail
            rolled = [e.uri for e in self._entries.values() if e.canary]
            for e in self._entries.values():
                if e.canary:
                    e.draining = True
                    e.canary = False
        _prof.record_channel_event("fleet.rollback")
        _health.note("canary_rollback", uris=rolled, **detail)

    def promote_canary(self, timeout: Optional[float] = None,
                       refresh: bool = True) -> dict:
        """The canary held: refresh every baseline replica to the new
        version and dissolve the cohorts.  Returns {uri: refresh
        reply}.  ``refresh=False`` skips the wire refresh (mirroring
        ``start_canary`` — for fleets whose replicas pick the version
        up on their own poll, or have no parameter servers to pull
        from) and only dissolves the cohorts."""
        with self._lock:
            if not self._canary_active:
                raise MXNetError("no active canary to promote")
            baseline = [e.uri for e in self._entries.values()
                        if not e.canary]
        replies = {}
        if refresh:
            for u in baseline:
                entry = self._entries[u]
                replies[u] = self._client_for(entry).refresh(
                    timeout=timeout or self._attempt_s)
        with self._lock:
            for e in self._entries.values():
                e.canary = False
            self._canary_active = False
        _prof.record_channel_event("fleet.canary_promote")
        _health.note("canary_promote", uris=baseline)
        return replies

    def canary_report(self) -> dict:
        """Both cohorts' live SLO numbers (tests and operators)."""
        with self._lock:
            out = {}
            for name, c in self._cohorts.items():
                out[name] = {
                    "n": c["n"], "err": c["err"],
                    "err_rate": round(c["err"] / c["n"], 4)
                    if c["n"] else 0.0,
                    "p99_ms": _ms(_p99(c["lat"]))}
            out["active"] = self._canary_active
            out["last_rollback"] = self.last_rollback
            return out

    # -- lifecycle -----------------------------------------------------------
    def close(self):
        self._stop.set()
        if self._poll_thread is not None:
            self._poll_thread.join(timeout=10.0)
        for entry in self._entries.values():
            client = entry.client
            if client is None:
                continue
            try:
                if entry.quarantined or client.is_dead():
                    client.abort()    # never drain against a corpse
                else:
                    client.close()
            except (MXNetError, OSError):
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _p99(samples) -> Optional[float]:
    vals = sorted(samples)
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(0.99 * (len(vals) - 1)))]


def _ms(v) -> Optional[float]:
    return None if v is None else round(v * 1000.0, 3)
