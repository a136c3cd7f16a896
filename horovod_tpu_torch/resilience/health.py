"""Process-wide health state machine: ``HEALTHY → SUSPECT → DEGRADED → FATAL``.

Counterpart of ``horovod_tpu/resilience/health.py``, copied whole: the
``record_*`` feeds whose producers are not ported yet (serving, data)
are here already, so every layer that comes later feeds the same
monitor. Every transition is mirrored into the flight ring
(:mod:`horovod_tpu_torch.observability.flight`).

The reference's only health signal is the stall inspector's log line; here
every failure-handling layer *feeds* one shared monitor and every consumer
(exceptions, the metrics endpoint, callbacks, the preemption loop) *reads*
it, so a stall is attributable from any vantage point:

- the native core's execute callback calls :func:`beat` each negotiation
  cycle and :func:`record_stall` when the C stall inspector warns
  (``core.py::_on_log``);
- the retry layer calls :func:`record_retry` / :func:`record_retry_exhausted`
  (``resilience.retry``);
- ``CoreHandle.wait(timeout=...)`` expiry calls :func:`record_timeout` and
  embeds the current state in its ``TimeoutError``.

Transitions (forward on evidence, backward on sustained progress):

- ``HEALTHY → SUSPECT``: first stall warning or bounded-wait timeout.
- ``SUSPECT → DEGRADED``: :data:`HealthMonitor.escalate_after` stall/timeout
  reports without an intervening progress beat, or any exhausted retry.
- ``DEGRADED → HEALTHY``: :data:`HealthMonitor.recovery_beats` consecutive
  progress beats (``SUSPECT`` recovers after one).
- ``* → FATAL``: :func:`record_fatal`; terminal, never recovers.

stdlib-only (imported by the launcher and by ``core.py``'s callback thread);
all methods are lock-safe. State is mirrored into the metrics registry as
the ``resilience_health_state`` gauge plus a labeled
``resilience_health_transitions`` counter, so the rank-0 endpoint exports it
without extra plumbing.
"""

from __future__ import annotations

import enum
import threading
import time
from typing import Optional

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "HealthState",
    "HealthMonitor",
    "MONITOR",
    "health_state",
    "beat",
    "record_stall",
    "record_timeout",
    "record_rank_lost",
    "record_replica_lost",
    "record_serving_stale",
    "record_serving_fresh",
    "record_straggler",
    "record_schedule_divergence",
    "record_numeric_corruption",
    "record_data_corruption",
    "record_input_stall",
    "record_slo_burn",
    "record_hang",
    "record_retry",
    "record_retry_exhausted",
    "record_fatal",
    "snapshot",
    "reset",
]


class HealthState(enum.IntEnum):
    """Ordered severity; comparisons (``state >= DEGRADED``) are meaningful."""

    HEALTHY = 0
    SUSPECT = 1
    DEGRADED = 2
    FATAL = 3


class HealthMonitor:
    """One process's health; see the module docstring for the transitions."""

    #: stall/timeout reports without a progress beat before SUSPECT escalates
    escalate_after = 3
    #: consecutive beats required to recover from DEGRADED
    recovery_beats = 3

    def __init__(self):
        self._lock = threading.Lock()
        self._state = HealthState.HEALTHY
        self._reason = ""
        self._since = time.monotonic()
        self._strikes = 0  # stall/timeout reports since the last beat
        self._good_beats = 0  # consecutive beats while DEGRADED
        self._last_beat: Optional[float] = None
        #: True while THIS monitor's DEGRADED was caused by serving-weight
        #: staleness — the one condition that clears instantly when the
        #: condition does (a fully observable state, unlike stall evidence)
        self._serving_stale = False

    # ------------------------------------------------------------- feeders

    def beat(self) -> None:
        """A unit of forward progress (negotiation cycle executed, train
        step completed). Clears strikes and walks SUSPECT/DEGRADED back to
        HEALTHY; FATAL is terminal."""
        with self._lock:
            self._last_beat = time.monotonic()
            self._strikes = 0
            if self._state == HealthState.SUSPECT:
                self._transition(HealthState.HEALTHY, "progress resumed")
            elif self._state == HealthState.DEGRADED:
                self._good_beats += 1
                if self._good_beats >= self.recovery_beats:
                    self._transition(
                        HealthState.HEALTHY,
                        f"{self._good_beats} consecutive beats",
                    )

    def record_stall(self, tensor: str, seconds: float = 0.0) -> None:
        """A stall-inspector warning for `tensor` (coordinator rank)."""
        self._strike(f"stalled collective '{tensor}'"
                     + (f" ({seconds:.0f}s)" if seconds else ""))
        if _metrics.enabled():
            _metrics.counter(
                "resilience_stalls", help="stall-inspector warnings observed"
            ).inc()

    def record_timeout(self, tensor: str) -> None:
        """A bounded wait (``CoreHandle.wait(timeout=...)``) expired."""
        self._strike(f"wait timeout on '{tensor}'")
        if _metrics.enabled():
            _metrics.counter(
                "resilience_wait_timeouts", help="bounded collective waits "
                "that expired"
            ).inc()

    def record_rank_lost(self, rank: int) -> None:
        """A peer rank's heartbeat expired (elastic membership loss). One
        strike — the elastic coordinator's successful re-form then beats the
        machine back toward HEALTHY; a coordinator that *cannot* re-form
        keeps striking until DEGRADED."""
        self._strike(f"rank {rank} heartbeat lost")
        if _metrics.enabled():
            _metrics.counter(
                "resilience_rank_lost",
                help="peer ranks whose heartbeats expired",
            ).inc()

    def record_replica_lost(self, replica, reason: str = "") -> None:
        """A serving replica dropped out of the fleet (killed, lease
        expired, or failed mid-decode). One strike — the fleet router's
        successful re-route of its in-flight requests then leaves the
        machine to recover on forward progress; a fleet that keeps
        losing replicas escalates like any other stall source."""
        self._strike(
            f"serving replica {replica} lost"
            + (f" ({reason})" if reason else ""))
        if _metrics.enabled():
            _metrics.counter(
                "resilience_replicas_lost",
                help="serving replicas dropped from the fleet",
            ).inc()

    def record_schedule_divergence(
        self, rank: int, op: str, step: Optional[int] = None
    ) -> None:
        """The schedule sanitizer caught `rank` issuing a different
        collective sequence (first divergent op `op`). One strike —
        HEALTHY goes SUSPECT with the rank AND op named in the reason; a
        rank that keeps diverging escalates like any other stall source.
        This is the failure mode the reference's negotiation protocol
        exists to prevent (PAPER.md L4) — left unflagged it is a silent
        deadlock or corruption."""
        self._strike(
            f"rank {rank} diverged collective schedule at '{op}'"
            + (f" (step {step})" if step is not None else "")
        )
        if _metrics.enabled():
            _metrics.counter(
                "resilience_schedule_divergences",
                help="cross-rank schedule mismatches fed to the health "
                     "machine by the sanitizer",
            ).inc()

    def record_numeric_corruption(
        self, rank: int, step: Optional[int] = None
    ) -> None:
        """The numerics fingerprint cross-check caught `rank` publishing a
        gradient fingerprint that is non-finite or wildly outside the
        fleet's family while the collective schedule matches — the silent
        data corruption (SDC) signature. One strike — HEALTHY goes SUSPECT
        with the rank named in the reason; the elastic coordinator reads
        the quarantine set (:func:`horovod_tpu_torch.resilience.numerics
        .take_corrupt_ranks`) and evicts the rank."""
        self._strike(
            f"rank {rank} numerically corrupt gradient fingerprint"
            + (f" (step {step})" if step is not None else "")
        )
        if _metrics.enabled():
            _metrics.counter(
                "resilience_numeric_corruptions",
                help="corrupt-gradient fingerprints fed to the health "
                     "machine by the numerics cross-check",
            ).inc()

    def record_hang(self, rank, sig=None, *,
                    kind: str = "rank_missing") -> None:
        """The hang watchdog's verdict
        (:mod:`horovod_tpu_torch.observability.flight`): the mesh made no
        collective/step progress for ``HOROVOD_HANG_TIMEOUT`` and the
        cross-rank diagnosis named `rank` (None: every rank parked — an
        external stall) at collective signature `sig` ``(step, gen,
        seq)``. Goes straight to DEGRADED — a hang IS sustained
        no-progress, the condition strikes exist to accumulate toward —
        with the rank and signature in the reason; never overrides FATAL
        or steals another subsystem's DEGRADED reasonlessly (it claims
        the reason, like an exhausted retry)."""
        key = tuple(sig) if sig else None
        if rank is None:
            reason = f"mesh hung at collective {key} (all ranks parked)"
        elif kind == "schedule_divergence":
            reason = (f"rank {rank} hung the mesh: schedule diverged at "
                      f"collective {key}")
        else:
            reason = f"rank {rank} hung the mesh: missing at collective " \
                     f"{key}"
        with self._lock:
            if self._state < HealthState.DEGRADED:
                self._transition(HealthState.DEGRADED, reason)
            elif self._state == HealthState.DEGRADED:
                self._serving_stale = False
                self._reason = reason
            self._good_beats = 0
        if _metrics.enabled():
            _metrics.counter(
                "resilience_hangs",
                help="hang-watchdog verdicts fed to the health machine",
                rank=-1 if rank is None else int(rank),
            ).inc()

    def record_serving_stale(self, lag: int,
                             seconds: Optional[float] = None) -> None:
        """The serving subscriber's staleness watermark tripped
        (``stale()``): the weights this process serves are `lag`
        generations behind the observed head (`seconds` old). Goes
        straight to DEGRADED with the lag in the reason — the ``/health``
        endpoint answers 503 and the balancer sheds traffic — but never
        overrides a DEGRADED/FATAL some other subsystem owns."""
        with self._lock:
            if self._state >= HealthState.DEGRADED:
                # refresh OUR reason only while we own a DEGRADED state;
                # a FATAL (or someone else's degradation) keeps its own
                # cause on /health
                if (self._serving_stale
                        and self._state == HealthState.DEGRADED):
                    self._reason = self._stale_reason(lag, seconds)
                return
            self._serving_stale = True
            self._transition(
                HealthState.DEGRADED, self._stale_reason(lag, seconds))
        if _metrics.enabled():
            _metrics.counter(
                "resilience_serving_stale",
                help="serving-staleness degradations fed to the health "
                     "machine by the subscriber watermark",
            ).inc()

    @staticmethod
    def _stale_reason(lag: int, seconds: Optional[float]) -> str:
        age = "unknown age" if seconds is None else f"{seconds:.0f}s old"
        return (f"serving weights stale: {lag} generation(s) behind head "
                f"({age})")

    def record_serving_fresh(self) -> None:
        """The staleness condition cleared (a poll caught up). Recovery is
        immediate — but ONLY when serving staleness owns the degradation
        outright: evidence earned since (exhausted retries drop the
        ownership flag, stall/timeout strikes accumulate in ``_strikes``)
        means some other subsystem is unhealthy and still needs its
        beats."""
        with self._lock:
            if not self._serving_stale:
                return
            self._serving_stale = False
            if self._state == HealthState.DEGRADED and self._strikes == 0:
                self._transition(
                    HealthState.HEALTHY, "serving weights fresh again")

    def record_straggler(self, rank: int, spread: float = 0.0,
                         cause: Optional[str] = None) -> None:
        """A persistent straggler: `rank` trailed every other rank at
        ``HOROVOD_STRAGGLER_PERSIST`` consecutive correlated collectives
        (:func:`horovod_tpu_torch.observability.straggler.attribute`). One
        strike — HEALTHY goes SUSPECT with the rank named in the reason;
        a straggler that keeps striking without progress escalates like
        any other stall source. `cause` (``"input"``/``"compute"``, from
        the input-side attribution) lands in the reason so the operator
        reads "slow disk" vs "slow chip" straight off ``/health``."""
        detail = ""
        if spread:
            detail = f" ({spread * 1e3:.0f} ms behind"
            if cause:
                detail += f", {cause}-bound"
            detail += ")"
        elif cause:
            detail = f" ({cause}-bound)"
        self._strike(f"rank {rank} straggling collectives{detail}")
        if _metrics.enabled():
            _metrics.counter(
                "resilience_stragglers",
                help="persistent-straggler reports fed to the health "
                     "machine",
            ).inc()

    def record_data_corruption(self, shard: str,
                               detail: Optional[str] = None) -> None:
        """The data store quarantined a corrupt shard (CRC mismatch that
        survived the retry budget — :class:`horovod_tpu_torch.data
        .ArrayShardStore`). One strike — HEALTHY goes SUSPECT with the
        shard named in the reason, and training continues past the
        quarantine (degrade-don't-crash, the subscriber-staleness
        contract applied to the input plane)."""
        self._strike(
            f"corrupt data shard '{shard}' quarantined"
            + (f" ({detail})" if detail else "")
        )
        if _metrics.enabled():
            _metrics.counter(
                "resilience_data_corruptions",
                help="corrupt data shards quarantined by the input plane",
            ).inc()

    def record_input_stall(self, seconds: float = 0.0) -> None:
        """The input-pipeline watchdog expired: the prefetch thread
        produced no batch for ``HOROVOD_DATA_WATCHDOG`` seconds while the
        step loop was waiting. One strike per watchdog interval — the
        stall-warning cadence — so a stuck disk walks the machine toward
        DEGRADED instead of silently freezing the step loop."""
        self._strike(
            "input pipeline stalled"
            + (f" ({seconds:.0f}s without a batch)" if seconds else "")
        )
        if _metrics.enabled():
            _metrics.counter(
                "resilience_input_stalls",
                help="input-pipeline watchdog expiries fed to the health "
                     "machine",
            ).inc()

    def record_slo_burn(self, objective: str, window: str = "") -> None:
        """An SLO objective is burning its error budget
        (:mod:`horovod_tpu_torch.observability.slo`'s multi-window verdict).
        One strike per evaluator cadence with the objective named —
        HEALTHY goes SUSPECT immediately and a burn that persists
        without progress escalates to DEGRADED like every other stall
        source, so ``/health`` names the objective an operator should
        chase."""
        self._strike(
            f"slo objective '{objective}' burning its error budget"
            + (f" ({window})" if window else "")
        )
        if _metrics.enabled():
            _metrics.counter(
                "resilience_slo_burns",
                help="SLO burn-rate verdicts fed to the health machine",
                objective=objective,
            ).inc()

    def record_retry(self, scope: str) -> None:
        """One retried transient failure (informational; no transition)."""
        if _metrics.enabled():
            _metrics.counter(
                "resilience_retries",
                help="transient failures retried by a RetryPolicy",
                scope=scope,
            ).inc()

    def record_retry_exhausted(self, scope: str) -> None:
        """A RetryPolicy gave up: the failure was not transient after all."""
        with self._lock:
            if self._state < HealthState.DEGRADED:
                self._transition(
                    HealthState.DEGRADED, f"retries exhausted in {scope}"
                )
            else:
                # already DEGRADED (possibly owned by serving staleness):
                # this evidence claims the degradation too — a catching-up
                # subscriber must NOT clear it back to HEALTHY
                self._serving_stale = False
                self._reason = f"retries exhausted in {scope}"
            self._good_beats = 0
        if _metrics.enabled():
            _metrics.counter(
                "resilience_retry_exhausted",
                help="RetryPolicy attempts exhausted without success",
                scope=scope,
            ).inc()

    def record_fatal(self, reason: str) -> None:
        """Unrecoverable failure; terminal."""
        with self._lock:
            if self._state != HealthState.FATAL:
                self._transition(HealthState.FATAL, reason)

    # ------------------------------------------------------------- readers

    def state(self) -> HealthState:
        return self._state

    def reason(self) -> str:
        return self._reason

    def snapshot(self) -> dict:
        """JSON-able view (what the ``/health`` endpoint serves)."""
        with self._lock:
            return {
                "state": self._state.name,
                "value": int(self._state),
                "reason": self._reason,
                "since_seconds": round(time.monotonic() - self._since, 3),
                "strikes": self._strikes,
                "last_beat_age_seconds": (
                    None
                    if self._last_beat is None
                    else round(time.monotonic() - self._last_beat, 3)
                ),
            }

    def reset(self) -> None:
        """Back to a fresh HEALTHY monitor (tests / per-run isolation)."""
        with self._lock:
            self._state = HealthState.HEALTHY
            self._reason = ""
            self._since = time.monotonic()
            self._strikes = 0
            self._good_beats = 0
            self._last_beat = None
            self._serving_stale = False
            if _metrics.enabled():
                _metrics.gauge(
                    "resilience_health_state",
                    help="0=HEALTHY 1=SUSPECT 2=DEGRADED 3=FATAL",
                ).set(0)

    # ------------------------------------------------------------ internal

    def _strike(self, reason: str) -> None:
        with self._lock:
            if self._state == HealthState.FATAL:
                return
            self._strikes += 1
            self._good_beats = 0
            if self._state == HealthState.HEALTHY:
                self._transition(HealthState.SUSPECT, reason)
            elif (
                self._state == HealthState.SUSPECT
                and self._strikes >= self.escalate_after
            ):
                self._transition(
                    HealthState.DEGRADED,
                    f"{self._strikes} strikes without progress "
                    f"(last: {reason})",
                )
            else:
                self._reason = reason

    def _transition(self, new: HealthState, reason: str) -> None:
        """Caller holds the lock."""
        old = self._state
        self._state = new
        self._reason = reason
        self._since = time.monotonic()
        if new != HealthState.DEGRADED:
            # serving-staleness ownership is meaningful only while
            # DEGRADED: leaving it (beats, FATAL) must drop the claim or
            # a later record_serving_fresh could clear a degradation some
            # OTHER subsystem earns afterwards
            self._serving_stale = False
        if new == HealthState.HEALTHY:
            self._strikes = 0
            self._good_beats = 0
        if _metrics.enabled():
            _metrics.gauge(
                "resilience_health_state",
                help="0=HEALTHY 1=SUSPECT 2=DEGRADED 3=FATAL",
            ).set(int(new))
            _metrics.counter(
                "resilience_health_transitions",
                help="health state-machine transitions",
                **{"from": old.name, "to": new.name},
            ).inc()
        try:
            # mirror the transition into the flight ring: health history
            # is the context a post-mortem reads first (flight flushes
            # non-collective events immediately, so the transition is on
            # disk before whatever it heralds kills the process)
            from horovod_tpu_torch.observability import flight as _flight

            _flight.record(
                "health", src=old.name, dst=new.name, reason=reason[:200],
            )
        except Exception:
            import logging

            logging.getLogger("horovod_tpu_torch.resilience").debug(
                "flight health event skipped", exc_info=True)


#: the process-wide monitor every layer feeds and reads
MONITOR = HealthMonitor()

beat = MONITOR.beat
record_stall = MONITOR.record_stall
record_timeout = MONITOR.record_timeout
record_rank_lost = MONITOR.record_rank_lost
record_replica_lost = MONITOR.record_replica_lost
record_serving_stale = MONITOR.record_serving_stale
record_serving_fresh = MONITOR.record_serving_fresh
record_straggler = MONITOR.record_straggler
record_data_corruption = MONITOR.record_data_corruption
record_input_stall = MONITOR.record_input_stall
record_slo_burn = MONITOR.record_slo_burn
record_schedule_divergence = MONITOR.record_schedule_divergence
record_hang = MONITOR.record_hang
record_numeric_corruption = MONITOR.record_numeric_corruption
record_retry = MONITOR.record_retry
record_retry_exhausted = MONITOR.record_retry_exhausted
record_fatal = MONITOR.record_fatal
health_state = MONITOR.state
snapshot = MONITOR.snapshot
reset = MONITOR.reset
