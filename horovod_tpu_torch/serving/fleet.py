"""Fleet serving tier: replica failover, hedged routing, coordinated rollout.

Counterpart of ``horovod_tpu/serving/fleet.py``: the multi-replica
control plane over the single-process serving stack (the engine, the
SLO registry). N
:class:`~horovod_tpu_torch.serving.engine.InferenceEngine` replicas, each
riding its OWN :class:`~horovod_tpu_torch.serving.subscriber.WeightSubscriber`
off the same publication chain, sit behind a :class:`FleetRouter`:

- **Routing** scores live queue depth + page-pool occupancy per replica
  (published through the same metrics plane ``/fleet`` aggregates), with
  a stale replica (subscriber ``stale()`` true, or a ``replica_stale``
  chaos charge) demoted to *last resort*: the router never picks it
  while any fresh replica has capacity, and the staleness→health
  path keeps firing underneath — each pump feeds the *worst* replica's
  staleness view to the health plane, so ``/health`` answers 503 while
  ANY replica serves stale weights.
- **Retry / hedging** ride the shared
  :class:`~horovod_tpu_torch.resilience.retry.RetryPolicy` under the ``ROUTE``
  scope (``HOROVOD_RETRY_ROUTE_*``: exp backoff + jitter + total
  deadline), seeded per request from the same crc32 the canary router
  hashes — a given rid's retry schedule is deterministic and replayable.
  A request in flight longer than ``HOROVOD_FLEET_HEDGE_AFTER`` seconds
  grows a duplicate copy on the next-best replica
  (``fleet_requests_hedged``); a request whose every copy rode a dead
  replica is resubmitted (``fleet_requests_failed_over``). The first
  completion wins, losers are cancelled at a pump boundary — exactly
  once, never double-completed, request ids stable throughout.
- **Drain** quiesces a replica (no new routes), finishes its in-flight
  work, then deregisters it by *tombstoning* its rendezvous-KV TTL lease
  (the elastic heartbeat pattern): an expired lease means "vanished", a
  tombstone means "left cleanly".
- **Fleet-wide rollout** (:class:`FleetRollout`) promotes the per-engine
  canary state machine from per-engine to one generation-fenced decision
  log in the rendezvous KV, committed decision-record-first and head
  pointer last (the :class:`~horovod_tpu_torch.serving.publisher
  .WeightPublisher` commit-last idiom): replicas apply decisions in
  epoch order, the gate judges the SLO registry's
  :meth:`~horovod_tpu_torch.observability.slo.SLORegistry.judge_canary` over
  *fleet-merged* per-arm windows, and a vetoed generation can never be
  serving on replica 2 after replica 1 rolled it back — there is no
  per-replica verdict to disagree about.

Chaos drills: ``replica_kill=<i>[:<at_pump>]`` kills replica `i`
mid-decode at a pump boundary (the router must re-route with
exactly-once completion); ``replica_stale=<i>:<s>`` forces replica `i`
stale; ``slow_decode=<s>:<arm>@<replica>`` scopes the latency regression
to one replica's arm.

Env knobs: ``HOROVOD_FLEET_HEDGE_AFTER`` (seconds in flight before a
request is hedged to a second replica; 0 disables, default 0.25) and
``HOROVOD_FLEET_STATUS_TTL`` (TTL on each replica's KV lease + status
blob, default 10, the elastic heartbeat default).

stdlib-only at module level; everything torch stays inside the engines.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import zlib
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import reqtrace as _reqtrace
from horovod_tpu_torch.observability import trace as _trace
from horovod_tpu_torch.resilience import chaos as _chaos
from horovod_tpu_torch.resilience import health as _health
from horovod_tpu_torch.resilience.retry import RetryError, policy_from_env
from horovod_tpu_torch.serving.engine import note_subscriber_health
from horovod_tpu_torch.serving.rollout import judge_window
from horovod_tpu_torch.serving.rollout import (
    CANARY_FRACTION_ENV,
    CANARY_MIN_REQUESTS_ENV,
)
from horovod_tpu_torch.serving.scheduler import (
    QueueFull,
    Request,
    prefix_digests,
)

__all__ = [
    "FleetSaturated",
    "FleetReplica",
    "FleetRequest",
    "FleetRouter",
    "FleetRollout",
    "HEDGE_AFTER_ENV",
    "STATUS_TTL_ENV",
]

logger = logging.getLogger("horovod_tpu_torch.serving")

HEDGE_AFTER_ENV = "HOROVOD_FLEET_HEDGE_AFTER"
STATUS_TTL_ENV = "HOROVOD_FLEET_STATUS_TTL"

#: fleet_serving_replica_state encoding
STATE_HEALTHY = 0
STATE_STALE = 1
STATE_DRAINING = 2
STATE_DEAD = 3
STATE_DRAINED = 4

_STATE_NAMES = {
    STATE_HEALTHY: "healthy",
    STATE_STALE: "stale",
    STATE_DRAINING: "draining",
    STATE_DEAD: "dead",
    STATE_DRAINED: "drained",
}


class FleetSaturated(QueueFull):
    """Every live replica rejected the request and the ROUTE retry
    budget (attempts + deadline) is spent. Inherits the
    ``retry_after_s`` hint — the *minimum* backlog estimate across the
    fleet, since the caller's retry only needs ONE replica to clear."""


class FleetReplica:
    """One engine + its own subscriber, registered under a fleet id.

    Liveness is a rendezvous-KV TTL lease
    (``/<scope>/replica/<id>``, the elastic heartbeat pattern) the
    router refreshes every pump; a compact status blob
    (``/<scope>/status/<id>``) rides the same store so scoring works
    across processes through the same KV the weights travel on.
    Deregistration *tombstones* the lease — an observer can tell
    "drained cleanly" from "lease expired, replica vanished".

    The replica also quacks like a subscriber (``lag()`` /
    ``staleness_seconds()`` / ``stale()``) so the staleness→health
    bridge (:func:`~horovod_tpu_torch.serving.engine.note_subscriber_health`)
    can consume it, with the ``replica_stale`` chaos charge layered on
    top of the real subscriber watermark. The router runs that bridge
    ONCE per pump against the stalest live replica — the health monitor
    is process-global, so per-replica calls would let a fresh replica
    polled last clear a degradation a stale sibling still owns.
    """

    def __init__(self, replica_id: str, engine, subscriber=None, *,
                 store=None, scope: str = "fleetserve",
                 lease_ttl: Optional[float] = None):
        self.id = str(replica_id)
        self.engine = engine
        self.subscriber = subscriber
        engine.replica = self.id
        self._store = store
        self._scope = scope.strip("/")
        self.lease_ttl = float(
            lease_ttl if lease_ttl is not None
            else os.environ.get(STATUS_TTL_ENV, "10.0"))
        #: fleet-assigned position — chaos charges target this index
        self.index: int = -1
        self.draining = False
        self.dead = False
        self.deregistered = False
        self.stable_generation: Optional[int] = None
        self.canary_generation: Optional[int] = None
        #: rollout-decision fence: epochs <= this have been applied
        self.applied_epoch = 0

    # ------------------------------------------------------------- lease

    @property
    def lease_key(self) -> str:
        return f"/{self._scope}/replica/{self.id}"

    @property
    def status_key(self) -> str:
        return f"/{self._scope}/status/{self.id}"

    def heartbeat(self) -> None:
        if self._store is None or self.dead or self.deregistered:
            return
        self._store.put(self.lease_key, b"1", ttl=self.lease_ttl)

    def deregister(self) -> None:
        """Clean exit: tombstone the lease (distinct from expiry) and
        drop the status blob."""
        self.deregistered = True
        if self._store is not None:
            self._store.delete(self.lease_key, tombstone=True)
            self._store.delete(self.status_key)

    def kill(self) -> None:
        """Fail the replica where it stands: lease tombstoned, in-flight
        sequences abandoned mid-decode (their requests never complete
        here — the router re-routes them)."""
        self.dead = True
        if self._store is not None:
            self._store.delete(self.lease_key, tombstone=True)
            self._store.delete(self.status_key)

    # --------------------------------------------------- staleness facade

    def forced_stale_seconds(self) -> Optional[float]:
        charge = _chaos.replica_stale()
        if charge is None or int(charge[0]) != self.index:
            return None
        return float(charge[1])

    def lag(self) -> int:
        if self.subscriber is None:
            return 0
        return int(self.subscriber.lag())

    def staleness_seconds(self) -> Optional[float]:
        forced = self.forced_stale_seconds()
        if forced is not None:
            return forced
        if self.subscriber is None:
            return None
        return self.subscriber.staleness_seconds()

    def stale(self) -> bool:
        if self.dead:
            return True
        if self.forced_stale_seconds() is not None:
            return True
        if self.subscriber is None:
            return False
        return bool(self.subscriber.stale())

    def poll(self) -> None:
        """Advance the subscriber; the router's fleet-level health
        bridge (one call per pump, stalest replica wins) handles the
        503/DEGRADED path."""
        if self.dead or self.subscriber is None:
            return
        self.subscriber.poll()

    # ------------------------------------------------------------- status

    def state_code(self) -> int:
        if self.dead:
            return STATE_DEAD
        if self.deregistered:
            return STATE_DRAINED
        if self.draining:
            return STATE_DRAINING
        if self.stale():
            return STATE_STALE
        return STATE_HEALTHY

    def queue_depth(self) -> int:
        return int(self.engine.scheduler.queue_depth())

    def pages_in_use(self) -> int:
        return int(self.engine.scheduler.pages_in_use())

    def active_sequences(self) -> int:
        return len(self.engine.scheduler.active())

    def prefix_summary(self) -> List[str]:
        """Content block digests of this replica's resident prefix
        cache — the locality signal the router scores against."""
        return list(self.engine.scheduler.prefix_summary())

    def status(self) -> Dict[str, Any]:
        age = self.staleness_seconds()
        return {
            "id": self.id,
            "index": self.index,
            "state": _STATE_NAMES[self.state_code()],
            "queue_depth": self.queue_depth(),
            "active": self.active_sequences(),
            "pages_in_use": self.pages_in_use(),
            "free_pages": int(self.engine.scheduler.free_page_count()),
            "stale": self.stale(),
            "staleness_seconds": None if age is None else float(age),
            "lag": self.lag(),
            "stable_generation": self.stable_generation,
            "canary_generation": self.canary_generation,
            "applied_epoch": self.applied_epoch,
            # prefix-cache advertisement: page granularity + resident
            # block hashes, so any router (in- or out-of-process) can
            # fold prefix locality into its scoring
            "prefix_page_size": int(self.engine.page_size),
            "prefix_blocks": self.prefix_summary(),
        }

    def publish_status(self) -> None:
        """One pump's worth of liveness + scoring signal: refresh the
        TTL lease, write the status blob, land the per-replica gauges
        (which ride the ``/fleet`` aggregation plane like every other
        metric)."""
        if self.dead or self.deregistered:
            return
        if self.forced_stale_seconds() is not None:
            _chaos.record_injection("replica_stale")
        self.heartbeat()
        st = self.status()
        if self._store is not None:
            self._store.put(self.status_key,
                            json.dumps(st).encode(),
                            ttl=self.lease_ttl)
        if _metrics.enabled():
            _metrics.gauge(
                "fleet_serving_replica_queue_depth",
                help="requests queued on each fleet replica",
                replica=self.id,
            ).set(st["queue_depth"])
            _metrics.gauge(
                "fleet_serving_replica_pages_in_use",
                help="kv-cache pages reserved on each fleet replica",
                replica=self.id,
            ).set(st["pages_in_use"])
            if st["staleness_seconds"] is not None:
                _metrics.gauge(
                    "fleet_serving_replica_staleness_seconds",
                    help="wall-clock age of the weights each fleet "
                         "replica serves",
                    replica=self.id,
                ).set(st["staleness_seconds"])
            _metrics.gauge(
                "fleet_serving_replica_state",
                help="0 healthy, 1 stale, 2 draining, 3 dead, 4 drained",
                replica=self.id,
            ).set(self.state_code())


class FleetRequest:
    """One fleet-level request: a stable rid, one or more engine-level
    copies (the primary, hedges, failover resubmissions), and exactly
    one completion — the first copy to finish wins, the rest are
    cancelled at a pump boundary."""

    def __init__(self, rid, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, arm: str = "stable"):
        self.rid = rid
        self.prompt = prompt
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.arm = arm
        self.submitted_at = time.monotonic()
        #: (replica, engine-level Request) per copy, submission order
        self.copies: List[Tuple[FleetReplica, Request]] = []
        self.hedged = False
        self.failovers = 0
        self.result: Optional[Request] = None
        self.error: Optional[str] = None
        self.finished_at: Optional[float] = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def tokens(self):
        return None if self.result is None else self.result.tokens

    @property
    def generated(self):
        return None if self.result is None else self.result.generated

    @property
    def replica(self) -> Optional[str]:
        """Id of the replica whose copy won (None until completion)."""
        if self.result is None:
            return None
        return str(getattr(self.result, "replica", "") or "") or None

    def latency_seconds(self) -> Optional[float]:
        if self.finished_at is None:
            return None
        return self.finished_at - self.submitted_at

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)


class FleetRouter:
    """Health-aware router over N engine replicas.

    Scoring is a lexicographic tuple per live (not dead, not draining)
    replica: ``(stale-tier, queue_depth + active + pages_fraction,
    index)`` — a stale replica only ever takes traffic when every fresh
    replica rejected (last resort), load balances within a tier, and the
    index breaks ties deterministically. One submission *attempt* sweeps
    the candidates in score order; all-rejected attempts retry under the
    shared ROUTE :class:`~horovod_tpu_torch.resilience.retry.RetryPolicy`
    (``HOROVOD_RETRY_ROUTE_*``), seeded from the rid's crc32 so the
    backoff schedule is per-request deterministic. Exhaustion raises
    :class:`FleetSaturated` carrying the fleet-minimum
    ``retry_after_s`` backpressure hint.

    :meth:`pump` is the serving loop turn: fire chaos, step every live
    engine, harvest completions (first copy wins, losers cancelled),
    fail over requests stranded on dead replicas, hedge slow ones,
    advance the attached :class:`FleetRollout`, publish statuses.
    """

    def __init__(self, *, store=None, scope: str = "fleetserve",
                 retry_policy=None, hedge_after: Optional[float] = None,
                 lease_ttl: Optional[float] = None):
        self._store = store
        self._scope = scope
        self._lease_ttl = lease_ttl
        self._policy = retry_policy if retry_policy is not None \
            else policy_from_env("route", max_attempts=3,
                                 base_delay=0.02, max_delay=0.5,
                                 deadline=2.0)
        self.hedge_after = float(
            hedge_after if hedge_after is not None
            else os.environ.get(HEDGE_AFTER_ENV, "0.25"))
        self._replicas: Dict[str, FleetReplica] = {}
        self._order: List[str] = []
        self._outstanding: List[FleetRequest] = []
        #: id(engine Request) → (fleet request, replica that ran it)
        self._by_copy: Dict[int, Tuple[FleetRequest, FleetReplica]] = {}
        #: replica id → arm → bounded completion entries (the fleet
        #: rollout's gate windows, fed by the reqtrace observer)
        self._windows: Dict[str, Dict[str, deque]] = {}
        self._rollout: Optional["FleetRollout"] = None
        self._pump_count = 0
        _reqtrace.add_completion_observer(self._on_completion)

    # ------------------------------------------------------------ fleet

    def add_replica(self, replica_id: str, engine, subscriber=None,
                    **kw) -> FleetReplica:
        """Register a replica (engine + its own subscriber); the fleet
        index it gets is what ``replica_kill=<i>`` / ``replica_stale=<i>``
        chaos charges target."""
        r = FleetReplica(replica_id, engine, subscriber,
                         store=self._store, scope=self._scope,
                         lease_ttl=kw.get("lease_ttl", self._lease_ttl))
        r.index = len(self._order)
        self._replicas[r.id] = r
        self._order.append(r.id)
        r.heartbeat()
        if self._rollout is not None:
            self._rollout.catch_up(r)
        return r

    @property
    def replicas(self) -> List[FleetReplica]:
        return [self._replicas[rid] for rid in self._order]

    def replica(self, replica_id: str) -> FleetReplica:
        return self._replicas[str(replica_id)]

    def live_replicas(self, include_draining: bool = False
                      ) -> List[FleetReplica]:
        return [r for r in self.replicas
                if not r.dead and not r.deregistered
                and (include_draining or not r.draining)]

    def attach_rollout(self, rollout: "FleetRollout") -> None:
        self._rollout = rollout

    def close(self) -> None:
        """Detach from the reqtrace observer list (tests / shutdown)."""
        _reqtrace.remove_completion_observer(self._on_completion)

    # ---------------------------------------------------------- scoring

    def _score(self, r: FleetReplica,
               affinity: int = 0) -> Tuple[int, float, int, int]:
        """Lexicographic routing score (lower is better): staleness
        tier, load, then prefix affinity (negated: more matched blocks
        ranks earlier), then the stable index tiebreak. Affinity is
        DEMOTED below staleness and load by construction — a cache-warm
        but stale or overloaded replica never beats a healthy one."""
        pool = max(1, int(r.engine.num_pages) - 1)
        load = (r.queue_depth() + r.active_sequences()
                + r.pages_in_use() / pool)
        return (1 if r.stale() else 0, load, -int(affinity), r.index)

    def _affinity(self, digests: List[str], r: FleetReplica) -> int:
        """Consecutive leading prompt blocks resident in `r`'s prefix
        cache — the run length is what an admission hit could alias."""
        if not digests:
            return 0
        resident = set(r.prefix_summary())
        n = 0
        for d in digests:
            if d not in resident:
                break
            n += 1
        return n

    def candidates(self, arm: str = "stable",
                   prompt=None) -> List[FleetReplica]:
        """Live replicas in routing order for `arm` — canary traffic
        only goes where the fleet's canary generation is actually
        installed. With `prompt`, replicas already holding its prefix
        blocks sort earlier within a staleness/load tier (requests
        sharing prefixes land where the pages live)."""
        out = self.live_replicas()
        if arm == "canary":
            want = None if self._rollout is None \
                else self._rollout.canary_generation
            out = [r for r in out
                   if want is not None
                   and r.engine.arm_generation("canary") == want]
        aff: Dict[str, int] = {}
        if prompt is not None:
            digs: Dict[int, List[str]] = {}
            for r in out:
                ps = int(r.engine.page_size)
                if ps not in digs:
                    digs[ps] = prefix_digests(prompt, ps)
                aff[r.id] = self._affinity(digs[ps], r)
        return sorted(
            out, key=lambda r: self._score(r, aff.get(r.id, 0)))

    # ---------------------------------------------------------- intake

    def route(self, rid) -> str:
        """Deterministic arm split — the fleet rollout's canary slice
        (crc32, same hash as the per-engine router) or stable."""
        if self._rollout is None:
            return "stable"
        return self._rollout.route(rid)

    def submit(self, rid, prompt, max_new_tokens: int,
               temperature: float = 0.0) -> FleetRequest:
        """Route one request into the fleet; raises
        :class:`FleetSaturated` (with a ``retry_after_s`` hint) only
        after the ROUTE retry budget is spent against a fully saturated
        fleet."""
        freq = FleetRequest(rid, prompt, max_new_tokens,
                            temperature=temperature,
                            arm=self.route(rid))
        policy = dataclasses.replace(
            self._policy, seed=zlib.crc32(str(rid).encode()))

        def attempt() -> FleetReplica:
            cands = self.candidates(freq.arm, prompt=freq.prompt)
            if not cands and freq.arm == "canary":
                # no replica holds the canary generation (yet): the
                # stable arm serves the request rather than dropping it
                freq.arm = "stable"
                cands = self.candidates("stable", prompt=freq.prompt)
            if not cands:
                raise QueueFull("no live replica in the fleet")
            last: Optional[QueueFull] = None
            for r in cands:
                try:
                    self._submit_copy(freq, r)
                    return r
                except QueueFull as e:
                    last = e
            assert last is not None
            raise last

        try:
            chosen = policy.call(attempt, retriable=(QueueFull,))
        except RetryError as e:
            hints = [r.engine.scheduler.backpressure_hint()
                     for r in self.live_replicas()]
            hint = min(hints) if hints else None
            freq.error = (f"rejected: fleet saturated "
                          f"(route retries exhausted: {e})")
            freq.finished_at = time.monotonic()
            freq._done.set()
            if _metrics.enabled():
                _metrics.counter(
                    "fleet_requests",
                    help="fleet-level requests completed, by arm and "
                         "outcome",
                    arm=freq.arm, outcome="rejected",
                ).inc()
            raise FleetSaturated(
                f"every live replica rejected request {rid!r}; retry "
                + (f"in ~{hint:.3f}s" if hint is not None else "later"),
                retry_after_s=hint) from e
        self._outstanding.append(freq)
        self._span("route", rid, replica=chosen.id, arm=freq.arm)
        return freq

    def _submit_copy(self, freq: FleetRequest, r: FleetReplica) -> None:
        req = Request(freq.rid, freq.prompt, freq.max_new_tokens,
                      temperature=freq.temperature, arm=freq.arm)
        # stamped BEFORE submit so reqtrace's req_begin carries it
        req.replica = r.id
        r.engine.submit(req)
        freq.copies.append((r, req))
        self._by_copy[id(req)] = (freq, r)

    # --------------------------------------------------------- the loop

    def pump(self) -> bool:
        """One fleet serving-loop turn. Returns True while any engine
        made progress."""
        self._pump_count += 1
        self._chaos_kill()
        ran = False
        for r in self.live_replicas(include_draining=True):
            if self._rollout is None:
                r.poll()
            ran = bool(r.engine.step()) or ran
        self._harvest()
        self._hedge()
        if self._rollout is not None:
            self._rollout.advance()
        self._note_fleet_health()
        for r in self.replicas:
            r.publish_status()
        return ran

    def _note_fleet_health(self) -> None:
        """One staleness→health bridge call per pump, fed the
        STALEST live replica: ``/health`` answers 503 while any replica
        serves stale weights, and recovers only once none does (the
        health monitor is process-global — per-replica calls would let
        the last-polled fresh replica clear a stale sibling's
        degradation)."""
        live = self.live_replicas(include_draining=True)
        if not live:
            return
        stale = [r for r in live if r.stale()]
        pick = max(stale, key=lambda r: r.staleness_seconds() or 0.0) \
            if stale else live[0]
        note_subscriber_health(pick)

    def drain(self, max_iters: int = 10000) -> None:
        """Pump until every outstanding fleet request completed."""
        for _ in range(max_iters):
            self._outstanding = [f for f in self._outstanding
                                 if not f.done]
            if not self._outstanding:
                return
            self.pump()
        raise RuntimeError(
            f"fleet did not drain within {max_iters} iterations")

    def drain_replica(self, replica_id: str,
                      max_iters: int = 10000) -> None:
        """Graceful exit for one replica: quiesce (no new routes),
        finish its in-flight work, deregister (tombstoned lease)."""
        r = self._replicas[str(replica_id)]
        r.draining = True
        for _ in range(max_iters):
            if r.engine.scheduler.idle():
                break
            self.pump()
        else:
            raise RuntimeError(
                f"replica {replica_id!r} did not quiesce within "
                f"{max_iters} iterations")
        r.deregister()
        logger.info("fleet: replica %s drained and deregistered", r.id)

    def kill_replica(self, replica_id: str,
                     reason: str = "killed") -> None:
        r = self._replicas[str(replica_id)]
        if r.dead:
            return
        r.kill()
        # close the victim's in-flight copies in reqtrace (host-side
        # bookkeeping only — the dead engine never steps again). In a
        # real fleet the dead process takes its trace table with it;
        # in-process the abandoned rids would sit in live_requests()
        # forever. Cancelled completions never reach the gate windows.
        for freq in self._outstanding:
            for rep, copy in freq.copies:
                if rep is r and not copy.done:
                    r.engine.scheduler.cancel(
                        copy, reason="cancelled: replica dead")
        _health.record_replica_lost(r.id, reason)
        _flight.record("fleet", what="replica_dead", replica=r.id,
                       reason=reason)
        logger.warning("fleet: replica %s lost (%s); re-routing its "
                       "in-flight requests", r.id, reason)

    def _chaos_kill(self) -> None:
        idx = _chaos.take_replica_kill(self._pump_count)
        if idx is None:
            return
        victim = next((r for r in self.replicas
                       if r.index == idx and not r.dead), None)
        if victim is not None:
            self.kill_replica(victim.id, reason="chaos replica_kill")

    # -------------------------------------------------------- completion

    def _on_completion(self, req, summary: Dict[str, Any]) -> None:
        """reqtrace completion observer: feed the per-replica gate
        windows (cancelled hedge losers excluded — they were never a
        served outcome)."""
        entry = self._by_copy.get(id(req))
        if entry is None or summary.get("cancelled"):
            return
        _freq, r = entry
        per_arm = self._windows.setdefault(r.id, {})
        win = per_arm.get(summary["arm"])
        if win is None:
            win = deque(maxlen=_reqtrace.window_size())
            per_arm[summary["arm"]] = win
        win.append({
            "generation": int(summary["generation"]),
            "error": summary["error"],
            "e2e": summary["e2e"],
            "ttft": summary["ttft"],
            "tpot_mean": summary["tpot_mean"],
        })

    def merged_window(self, arm: str,
                      generation: Optional[int] = None
                      ) -> Dict[str, object]:
        """Fleet-merged completion window for `arm` (all replicas,
        optionally generation-filtered) in the
        :func:`~horovod_tpu_torch.observability.reqtrace.arm_window` dict
        shape — what the fleet rollout gate judges."""
        entries: List[dict] = []
        for per_arm in self._windows.values():
            entries.extend(
                e for e in per_arm.get(arm, ())
                if generation is None
                or e["generation"] == int(generation))
        e2e = [e["e2e"] for e in entries if e["e2e"] is not None]
        return {
            "done": len(entries),
            "errors": sum(1 for e in entries if e["error"]),
            "latency_sum": float(sum(e2e)),
            "e2e": e2e,
            "ttft": [e["ttft"] for e in entries
                     if e["ttft"] is not None],
            "tpot": [e["tpot_mean"] for e in entries
                     if e["tpot_mean"] is not None],
        }

    def reset_windows(self) -> None:
        """Fresh gate windows (a new canary epoch starts its own
        evaluation, the per-engine ``_reset_window`` idiom)."""
        self._windows.clear()

    def _harvest(self) -> None:
        still: List[FleetRequest] = []
        for freq in self._outstanding:
            if freq.done:
                continue
            winner: Optional[Tuple[FleetReplica, Request]] = None
            errored: Optional[Tuple[FleetReplica, Request]] = None
            live_copies = 0
            for r, c in freq.copies:
                if r.dead:
                    continue
                if not c.done:
                    live_copies += 1
                    continue
                if c.error is None:
                    winner = (r, c)
                    break
                if not str(c.error).startswith("cancelled"):
                    errored = (r, c)
            if winner is not None:
                self._complete(freq, *winner)
                continue
            if live_copies == 0:
                if errored is not None:
                    # a genuine engine error (not a dead replica): the
                    # same weights serve everywhere, re-routing would
                    # reproduce it — the error IS the result
                    self._complete(freq, *errored)
                    continue
                self._failover(freq)
                if not freq.done:
                    still.append(freq)
                continue
            still.append(freq)
        self._outstanding = still

    def _complete(self, freq: FleetRequest, r: FleetReplica,
                  copy: Request) -> None:
        freq.result = copy
        freq.error = copy.error
        freq.finished_at = time.monotonic()
        freq._done.set()
        for other_r, other_c in freq.copies:
            if other_c is copy or other_c.done or other_r.dead:
                continue
            other_r.engine.scheduler.cancel(
                other_c, reason="cancelled: superseded by "
                f"replica {r.id}")
        # release the copy table entries — the request is settled
        for _r2, c2 in freq.copies:
            self._by_copy.pop(id(c2), None)
        if _metrics.enabled():
            _metrics.counter(
                "fleet_requests",
                help="fleet-level requests completed, by arm and "
                     "outcome",
                arm=freq.arm,
                outcome="error" if freq.error else "ok",
            ).inc()
        self._span("complete", freq.rid, replica=r.id,
                   outcome="error" if freq.error else "ok")

    def _failover(self, freq: FleetRequest) -> None:
        """Every copy of `freq` rode a dead replica: resubmit to the
        best live one (exactly-once is preserved — dead copies can
        never complete)."""
        cands = self.candidates(freq.arm)
        if not cands and freq.arm == "canary":
            freq.arm = "stable"
            cands = self.candidates("stable")
        for r in cands:
            try:
                self._submit_copy(freq, r)
            except QueueFull:
                continue
            freq.failovers += 1
            if _metrics.enabled():
                _metrics.counter(
                    "fleet_requests_failed_over",
                    help="requests re-routed off a dead replica",
                ).inc()
            self._span("failover", freq.rid, replica=r.id)
            logger.info("fleet: request %r failed over to replica %s",
                        freq.rid, r.id)
            return
        if not cands:
            freq.error = "rejected: no live replica to re-route to"
            freq.finished_at = time.monotonic()
            freq._done.set()
            if _metrics.enabled():
                _metrics.counter(
                    "fleet_requests",
                    help="fleet-level requests completed, by arm and "
                         "outcome",
                    arm=freq.arm, outcome="rejected",
                ).inc()
        # all candidates full: leave outstanding, next pump retries

    def _hedge(self) -> None:
        if self.hedge_after <= 0:
            return
        now = time.monotonic()
        for freq in self._outstanding:
            if freq.done or freq.hedged:
                continue
            if now - freq.submitted_at < self.hedge_after:
                continue
            riding = {r.id for r, c in freq.copies
                      if not r.dead and not c.done}
            if not riding:
                continue  # the failover path owns this one
            for r in self.candidates(freq.arm):
                if r.id in riding:
                    continue
                try:
                    self._submit_copy(freq, r)
                except QueueFull:
                    continue
                freq.hedged = True
                if _metrics.enabled():
                    _metrics.counter(
                        "fleet_requests_hedged",
                        help="requests duplicated onto a second "
                             "replica after the hedge deadline",
                    ).inc()
                self._span("hedge", freq.rid, replica=r.id)
                break

    # ---------------------------------------------------------- plumbing

    def _span(self, what: str, rid, **args) -> None:
        if not _reqtrace.enabled() or not _trace.enabled():
            return
        _trace.add_raw({
            "ph": "i", "s": "t", "pid": "fleet-router", "tid": "route",
            "name": f"{what}:{rid}",
            "ts": round(_trace.rel_us(time.monotonic()), 1),
            "args": args,
        })


class FleetRollout:
    """Fleet-wide canary state machine: ONE generation-fenced decision,
    coordinated through the rendezvous KV.

    Decisions (``bootstrap`` / ``canary`` / ``promote`` / ``rollback``)
    are a monotone epoch log under ``/<scope>/rollout/decision/<epoch>``
    with a head pointer at ``/<scope>/rollout/epoch`` written LAST (the
    WeightPublisher commit-last idiom): a reader that sees the head sees
    the whole decision. Replicas apply decisions strictly in epoch order
    behind their own ``applied_epoch`` fence — a replica that cannot yet
    apply (its subscriber hasn't caught up to the decision's generation)
    blocks there rather than skipping ahead, so no interleaving leaves
    two replicas serving different verdicts about the same generation.

    The gate is :func:`horovod_tpu_torch.serving.rollout.judge_window` — the
    SAME error-rate / latency-ratio /
    :meth:`~horovod_tpu_torch.observability.slo.SLORegistry.judge_canary`
    logic the per-engine rollout uses — judged over the router's
    *fleet-merged* per-arm windows, so one slow replica's canary burn
    rolls the generation back everywhere and a vetoed generation can
    never be serving on any replica afterwards.
    """

    def __init__(self, router: FleetRouter, store=None, *,
                 scope: str = "fleetserve",
                 canary_fraction: Optional[float] = None,
                 min_canary_requests: Optional[int] = None,
                 max_error_rate: float = 0.0,
                 max_latency_ratio: Optional[float] = 3.0,
                 slo=None,
                 on_event: Optional[Callable[[str, int], None]] = None):
        self._router = router
        self._store = store if store is not None \
            else router._store
        self._mem: Dict[str, bytes] = {}
        self._scope = scope.strip("/")
        self.canary_fraction = float(
            canary_fraction if canary_fraction is not None
            else os.environ.get(CANARY_FRACTION_ENV, "0.25"))
        self.min_canary_requests = int(
            min_canary_requests if min_canary_requests is not None
            else os.environ.get(CANARY_MIN_REQUESTS_ENV, "8"))
        self.max_error_rate = float(max_error_rate)
        self.max_latency_ratio = max_latency_ratio
        self._slo = slo
        self._on_event = on_event
        self._stable_gen: Optional[int] = None
        self._canary_gen: Optional[int] = None
        self._vetoed: set = set()
        self._epoch = 0
        router.attach_rollout(self)
        self._record_state()

    # ------------------------------------------------------------ views

    @property
    def stable_generation(self) -> Optional[int]:
        return self._stable_gen

    @property
    def canary_generation(self) -> Optional[int]:
        return self._canary_gen

    @property
    def vetoed(self) -> frozenset:
        return frozenset(self._vetoed)

    @property
    def epoch(self) -> int:
        return self._epoch

    def route(self, rid) -> str:
        """The per-engine deterministic slice, fleet-wide: same crc32 hash,
        same fraction, one decision for every replica."""
        if self._canary_gen is None:
            return "stable"
        h = zlib.crc32(str(rid).encode()) % 10000
        return ("canary" if h < int(self.canary_fraction * 10000)
                else "stable")

    # --------------------------------------------------------- decisions

    def _kv_put(self, key: str, rec: Dict[str, Any]) -> None:
        blob = json.dumps(rec).encode()
        full = f"/{self._scope}/rollout/{key}"
        if self._store is not None:
            self._store.put(full, blob)
        else:
            self._mem[full] = blob

    def _kv_get(self, key: str) -> Optional[Dict[str, Any]]:
        full = f"/{self._scope}/rollout/{key}"
        blob = self._store.get(full) if self._store is not None \
            else self._mem.get(full)
        if blob is None:
            return None
        return json.loads(blob.decode())

    def head_epoch(self) -> int:
        head = self._kv_get("epoch")
        return 0 if head is None else int(head["epoch"])

    def _commit(self, action: str, generation: int) -> None:
        """Commit-last: the decision record lands before the head
        pointer moves, so no replica can observe a half-written
        decision."""
        self._epoch += 1
        self._kv_put(f"decision/{self._epoch}", {
            "epoch": self._epoch, "action": action,
            "generation": int(generation),
        })
        self._kv_put("epoch", {"epoch": self._epoch})
        if _metrics.enabled():
            _metrics.counter(
                "fleet_serving_decisions",
                help="fleet rollout decisions committed, by action",
                action=action,
            ).inc()
            _metrics.gauge(
                "fleet_serving_rollout_epoch",
                help="head of the fleet rollout decision log",
            ).set(self._epoch)
        _flight.record("fleet", what="rollout_decision", action=action,
                       generation=int(generation), epoch=self._epoch)
        self._apply_all()

    def _apply_all(self) -> None:
        for r in self._router.live_replicas(include_draining=True):
            self.apply(r)

    def apply(self, replica: FleetReplica) -> None:
        """Advance `replica` through the decision log, strictly in
        epoch order behind its ``applied_epoch`` fence."""
        head = self.head_epoch()
        while replica.applied_epoch < head:
            rec = self._kv_get(f"decision/{replica.applied_epoch + 1}")
            if rec is None or not self._apply_one(replica, rec):
                return
            replica.applied_epoch = int(rec["epoch"])

    def _apply_one(self, replica: FleetReplica,
                   rec: Dict[str, Any]) -> bool:
        action = rec["action"]
        gen = int(rec["generation"])
        eng = replica.engine
        if action in ("bootstrap", "canary"):
            sub = replica.subscriber
            if sub is None:
                return False
            if sub.generation < gen:
                sub.poll()
            if sub.generation == gen and sub.weights() is not None:
                arm = "stable" if action == "bootstrap" else "canary"
                eng.set_weights(sub.weights(), generation=gen, arm=arm)
                if action == "bootstrap":
                    replica.stable_generation = gen
                else:
                    replica.canary_generation = gen
                return True
            if sub.generation > gen:
                # the subscriber chain marched past this decision's
                # generation (GC'd); the arm stays un-installed here and
                # the router keeps this replica out of that arm's
                # candidates
                logger.warning(
                    "fleet: replica %s cannot install generation %d "
                    "(subscriber is at %d); skipping epoch %d",
                    replica.id, gen, sub.generation, rec["epoch"])
                return True
            return False  # not yet published this far: wait, fenced
        if action == "promote":
            if eng.arm_generation("canary") == gen:
                eng.promote_canary()
            replica.stable_generation = gen
            replica.canary_generation = None
            return True
        if action == "rollback":
            eng.retire_arm("canary")
            replica.canary_generation = None
            return True
        logger.warning("fleet: unknown rollout action %r", action)
        return True

    def catch_up(self, replica: FleetReplica) -> None:
        """A replica joining mid-history replays the decision log from
        epoch 0 (its fence starts there)."""
        self.apply(replica)

    # ---------------------------------------------------------- the loop

    def advance(self) -> None:
        """One coordinator turn (called from the router's pump): poll
        every replica's subscriber (running the per-replica health
        bridge), open a canary on the newest non-vetoed generation,
        apply any pending decisions, and judge the fleet-merged gate."""
        live = self._router.live_replicas(include_draining=True)
        for r in live:
            r.poll()
        gens = [int(r.subscriber.generation) for r in live
                if r.subscriber is not None
                and r.subscriber.weights() is not None]
        newest = max(gens, default=0)
        if newest > 0 and newest not in self._vetoed:
            if self._stable_gen is None:
                self._stable_gen = newest
                logger.info("fleet rollout: stable bootstrap at "
                            "generation %d", newest)
                self._commit("bootstrap", newest)
            elif (newest > self._stable_gen
                    and newest != self._canary_gen):
                # a newer candidate supersedes a half-evaluated canary,
                # exactly like the per-engine rollout
                self._canary_gen = newest
                self._router.reset_windows()
                logger.info(
                    "fleet rollout: canarying generation %d on %.0f%% "
                    "of traffic (stable %d)", newest,
                    100 * self.canary_fraction, self._stable_gen)
                self._emit("canary_started", newest)
                self._commit("canary", newest)
        self._apply_all()
        self._evaluate()
        self._record_state()

    def _evaluate(self) -> None:
        if self._canary_gen is None:
            return
        c = self._router.merged_window("canary",
                                       generation=self._canary_gen)
        s = self._router.merged_window("stable")
        verdict = judge_window(
            c, s, min_requests=self.min_canary_requests,
            max_error_rate=self.max_error_rate,
            max_latency_ratio=self.max_latency_ratio, slo=self._slo)
        if verdict is None:
            return
        action, why, objective = verdict
        gen = self._canary_gen
        if action == "promote":
            self._stable_gen = gen
            self._canary_gen = None
            self._router.reset_windows()
            logger.info("fleet rollout: promoted generation %d to "
                        "stable fleet-wide", gen)
            self._count_outcome("promoted")
            self._emit("promoted", gen)
            self._commit("promote", gen)
            return
        self._vetoed.add(gen)
        self._canary_gen = None
        self._router.reset_windows()
        if objective is not None:
            _health.record_slo_burn(
                objective, f"canary generation {gen} (fleet)")
        logger.warning(
            "fleet rollout: generation %d rolled back to %s "
            "fleet-wide (%s)", gen, self._stable_gen, why)
        self._count_outcome("rolled_back")
        self._emit("rolled_back", gen)
        self._commit("rollback", gen)

    # ---------------------------------------------------------- plumbing

    def _count_outcome(self, outcome: str) -> None:
        if _metrics.enabled():
            _metrics.counter(
                "fleet_serving_rollouts",
                help="fleet-wide canary evaluations concluded, by "
                     "outcome",
                outcome=outcome,
            ).inc()

    def _emit(self, event: str, generation: int) -> None:
        if self._on_event is None:
            return
        try:
            self._on_event(event, generation)
        except Exception as e:  # noqa: BLE001 - observer, best-effort
            logger.debug("fleet on_event callback failed: %s", e)

    def _record_state(self) -> None:
        if not _metrics.enabled():
            return
        _metrics.gauge(
            "fleet_serving_rollout_state",
            help="0 = fleet serving stable only, 1 = canary in flight",
        ).set(0 if self._canary_gen is None else 1)
        if self._stable_gen is not None:
            _metrics.gauge(
                "fleet_serving_stable_generation",
                help="generation the fleet's stable arm serves",
            ).set(self._stable_gen)
        _metrics.gauge(
            "fleet_serving_canary_generation",
            help="generation under fleet-wide canary (-1 = none)",
        ).set(-1 if self._canary_gen is None else self._canary_gen)
