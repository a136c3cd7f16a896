"""Canary / promotion / rollback of weight generations through the engine.

Counterpart of ``horovod_tpu/serving/rollout.py``, framework-free.

The control-plane coupling this repo uniquely has (ROADMAP item 4): a new
weight generation is never flipped onto the whole fleet blind —

1. **Numerics gate, by construction.** The trainer's publish gate
   (:class:`~horovod_tpu_torch.serving.publisher.PublishRejected`) sits
   *before* any byte reaches the KV, so a generation whose gradients were
   non-finite, mid-bad-streak, or quarantine-tainted **never arrives** at
   this controller — the first line of defense costs serving nothing.
2. **Canary slice.** A generation that does arrive serves a deterministic
   slice of traffic (``canary_fraction``, hashed on the request id — the
   same request always lands in the same arm) on the engine's ``canary``
   arm while the ``stable`` arm keeps serving generation G−1.
3. **Serving-metrics gate.** After ``min_canary_requests`` completed
   canary requests, the live per-arm completion windows
   (:mod:`horovod_tpu_torch.observability.reqtrace` — the ONE observation
   path, shared with the ``reqtrace_*``/``serving_request_latency``
   histograms) decide: an error-rate excess (non-finite logits are an
   engine-detected error — the signature of weights a gate-less trainer
   would have shipped), a latency blow-up versus stable, or any
   declared SLO objective burning on the canary slice
   (:meth:`horovod_tpu_torch.observability.slo.SLORegistry.judge_canary`,
   judged against the stable arm's live baseline, with the objective
   named to the health machine) **auto-rolls back** to G−1; otherwise
   the canary **promotes**. The same completions feed the ``/fleet``
   aggregation plane, so per-generation deltas are visible fleet-wide.

A rolled-back generation is **vetoed**: the subscriber may hold it (its
chain marched on), but the engine never serves it again — the next
generation starts a fresh canary on top of the same stable weights.
In-flight canary sequences are never dropped on rollback; the canary arm
drains and only then releases its params.
"""

from __future__ import annotations

import logging
import os
import zlib
from typing import Callable, Dict, List, Optional

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import reqtrace as _reqtrace
from horovod_tpu_torch.observability import slo as _slo
from horovod_tpu_torch.resilience import health as _health
from horovod_tpu_torch.serving.engine import note_subscriber_health
from horovod_tpu_torch.serving.scheduler import Request

__all__ = [
    "GenerationRollout",
    "judge_window",
    "CANARY_FRACTION_ENV",
    "CANARY_MIN_REQUESTS_ENV",
]

logger = logging.getLogger("horovod_tpu_torch.serving")

CANARY_FRACTION_ENV = "HOROVOD_SERVING_CANARY_FRACTION"
CANARY_MIN_REQUESTS_ENV = "HOROVOD_SERVING_CANARY_MIN_REQUESTS"

#: serving_rollout_state encoding
STATE_STABLE = 0
STATE_CANARY = 1


def judge_window(canary: Dict[str, object], stable: Dict[str, object], *,
                 min_requests: int, max_error_rate: float = 0.0,
                 max_latency_ratio: Optional[float] = 3.0, slo=None):
    """The canary gate as a pure function over completion windows (the
    dict shape :func:`horovod_tpu_torch.observability.reqtrace.arm_window`
    returns), so one engine's rollout and the fleet tier's merged
    multi-replica windows judge through the SAME logic. Returns None
    while `canary` has fewer than `min_requests` completions, else
    ``("promote", "", None)`` or ``("rollback", why, objective)`` where
    `objective` names the burning SLO when that gate tripped (callers
    feed it to the health machine)."""
    done = int(canary["done"])  # type: ignore[arg-type]
    if done < min_requests:
        return None
    err_rate = int(canary["errors"]) / done  # type: ignore[arg-type]
    if err_rate > max_error_rate:
        return ("rollback",
                f"error rate {err_rate:.2f} > {max_error_rate:.2f} "
                f"over {done} canary requests", None)
    if (max_latency_ratio is not None and stable["done"] > 0
            and stable["latency_sum"] > 0):
        ratio = (canary["latency_sum"] / done) / (  # type: ignore
            stable["latency_sum"] / stable["done"])  # type: ignore
        if ratio > max_latency_ratio:
            return ("rollback",
                    f"latency ratio {ratio:.2f}x > "
                    f"{max_latency_ratio:.2f}x vs stable", None)
    registry = slo if slo is not None else _slo.default()
    verdict = registry.judge_canary(canary, stable)
    if verdict is not None:
        name, detail = verdict
        return ("rollback",
                f"slo objective '{name}' burning on canary: {detail}",
                name)
    return ("promote", "", None)


class GenerationRollout:
    """Drive an :class:`~horovod_tpu_torch.serving.engine.InferenceEngine`'s
    weight arms from a subscriber, canarying every new generation.

    - :meth:`poll` — pull the subscriber, start/refresh the canary.
    - :meth:`submit` — route a request to its arm and track it.
    - :meth:`pump` — one engine iteration + harvest finished requests +
      evaluate the promotion/rollback gate (call in the serving loop).

    `max_error_rate` is the canary error-rate ceiling (default 0.0 — any
    engine-detected error on the canary slice rolls back; stable-arm
    errors never indict the canary). `max_latency_ratio` (default 3.0)
    bounds canary/stable mean request latency once both arms have a
    window. `slo` is the objective evaluator the canary gate judges
    through (default: the process-wide
    :func:`horovod_tpu_torch.observability.slo.default` registry — any
    declared serving-side objective burning on the canary slice, judged
    against the stable arm's live baseline, rolls back with the
    objective named). `on_event(event, generation)` observes
    ``canary_started`` / ``promoted`` / ``rolled_back``.
    """

    def __init__(self, engine, subscriber, *,
                 canary_fraction: Optional[float] = None,
                 min_canary_requests: Optional[int] = None,
                 max_error_rate: float = 0.0,
                 max_latency_ratio: Optional[float] = 3.0,
                 slo=None,
                 on_event: Optional[Callable[[str, int], None]] = None):
        self._engine = engine
        self._sub = subscriber
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
        self._outstanding: List[Request] = []
        # per-arm completion-window marks into the reqtrace series,
        # re-taken when a canary starts (the gate reads "what completed
        # since")
        self._marks: Dict[str, int] = {}
        self._reset_window()
        self._record_state()

    # ------------------------------------------------------------- weights

    @property
    def stable_generation(self) -> Optional[int]:
        return self._stable_gen

    @property
    def canary_generation(self) -> Optional[int]:
        return self._canary_gen

    @property
    def vetoed(self) -> frozenset:
        return frozenset(self._vetoed)

    def poll(self) -> None:
        """Advance the subscriber; a new generation either bootstraps the
        stable arm (first weights) or starts/refreshes the canary. Also
        feeds the staleness health bridge every call."""
        self._sub.poll()
        note_subscriber_health(self._sub)
        gen = self._sub.generation
        tree = self._sub.weights()
        if tree is None or gen in self._vetoed:
            return
        if self._stable_gen is None:
            self._stable_gen = gen
            self._engine.set_weights(tree, generation=gen, arm="stable")
            logger.info("rollout: stable bootstrap at generation %d", gen)
            self._record_state()
            return
        if gen == self._stable_gen or gen == self._canary_gen:
            return
        # a NEWER generation while one is already canarying restarts the
        # evaluation window on the newest candidate — promoting a
        # half-evaluated middle generation would skip its own gate
        self._canary_gen = gen
        self._engine.set_weights(tree, generation=gen, arm="canary")
        # canary requests still QUEUED will decode against the NEW
        # weights (only in-flight sequences park on the old generation's
        # drain arm) — reqtrace tags every completion with the weight
        # generation that actually decoded it, so the gate's
        # generation-filtered window sorts this out by construction
        self._reset_window()
        logger.info(
            "rollout: canarying generation %d on %.0f%% of traffic "
            "(stable %d)", gen, 100 * self.canary_fraction,
            self._stable_gen)
        self._emit("canary_started", gen)
        self._record_state()

    # ------------------------------------------------------------ requests

    def route(self, rid) -> str:
        """Deterministic traffic split: the same request id always lands
        in the same arm (crc32 hash — no RNG, replayable)."""
        if self._canary_gen is None:
            return "stable"
        h = zlib.crc32(str(rid).encode()) % 10000
        return "canary" if h < int(self.canary_fraction * 10000) else "stable"

    def submit(self, rid, prompt, max_new_tokens: int,
               temperature: float = 0.0) -> Request:
        req = Request(rid, prompt, max_new_tokens,
                      temperature=temperature, arm=self.route(rid))
        self._engine.submit(req)
        self._outstanding.append(req)
        return req

    # ----------------------------------------------------------- the loop

    def pump(self) -> bool:
        """One serving-loop turn: engine iteration + evaluate the gate
        (completions accumulate in the reqtrace per-arm windows as the
        scheduler retires them — no separate harvest). Returns the
        engine's progress flag."""
        ran = self._engine.step()
        self._outstanding = [r for r in self._outstanding if not r.done]
        self._evaluate()
        return ran

    def drain(self, max_iters: int = 10000) -> None:
        """Pump until every outstanding request completed."""
        for _ in range(max_iters):
            if not self._outstanding:
                return
            self.pump()
        raise RuntimeError(
            f"rollout did not drain within {max_iters} iterations")

    # ---------------------------------------------------------- the gates

    def _evaluate(self) -> None:
        if self._canary_gen is None:
            return
        # the canary window is generation-filtered: a leftover from a
        # rolled-back / superseded canary completed under THAT
        # generation's weights and never pollutes this gate
        c = _reqtrace.arm_window(
            "canary", since=self._marks.get("canary", 0),
            generation=self._canary_gen)
        s = _reqtrace.arm_window(
            "stable", since=self._marks.get("stable", 0))
        verdict = judge_window(
            c, s, min_requests=self.min_canary_requests,
            max_error_rate=self.max_error_rate,
            max_latency_ratio=self.max_latency_ratio, slo=self._slo)
        if verdict is None:
            return
        action, why, objective = verdict
        if action == "promote":
            self._promote()
            return
        if objective is not None:
            _health.record_slo_burn(
                objective, f"canary generation {self._canary_gen}")
        self._rollback(why)

    def _promote(self) -> None:
        gen = self._canary_gen
        self._engine.promote_canary()
        self._stable_gen = gen
        self._canary_gen = None
        self._reset_window()
        logger.info("rollout: promoted generation %d to stable", gen)
        if _metrics.enabled():
            _metrics.counter(
                "serving_rollouts",
                help="canary evaluations concluded, by outcome",
                outcome="promoted",
            ).inc()
        self._emit("promoted", gen)
        self._record_state()

    def _rollback(self, why: str) -> None:
        gen = self._canary_gen
        self._vetoed.add(gen)
        self._engine.retire_arm("canary")
        self._canary_gen = None
        self._reset_window()
        logger.warning(
            "rollout: generation %d rolled back to %d (%s)",
            gen, self._stable_gen, why)
        if _metrics.enabled():
            _metrics.counter(
                "serving_rollouts",
                help="canary evaluations concluded, by outcome",
                outcome="rolled_back",
            ).inc()
        self._emit("rolled_back", gen)
        self._record_state()

    # ------------------------------------------------------------ plumbing

    def _reset_window(self) -> None:
        self._marks = {
            arm: _reqtrace.arm_mark(arm) for arm in ("stable", "canary")
        }

    def _emit(self, event: str, generation: int) -> None:
        if self._on_event is None:
            return
        try:
            self._on_event(event, generation)
        except Exception as e:
            logger.debug("rollout on_event callback failed: %s", e)

    def _record_state(self) -> None:
        if not _metrics.enabled():
            return
        _metrics.gauge(
            "serving_rollout_state",
            help="0 = serving stable only, 1 = canary in flight",
        ).set(STATE_CANARY if self._canary_gen is not None
              else STATE_STABLE)
        if self._stable_gen is not None:
            _metrics.gauge(
                "serving_stable_generation",
                help="generation the stable arm serves",
            ).set(self._stable_gen)
        _metrics.gauge(
            "serving_canary_generation",
            help="generation under canary (-1 = none)",
        ).set(-1 if self._canary_gen is None else self._canary_gen)
