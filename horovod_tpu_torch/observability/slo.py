"""Declarative SLO registry with deterministic burn-rate math.

Objectives are declared in ``HOROVOD_SLO`` (or programmatically via
:func:`configure`) as comma-separated ``name<threshold`` pairs::

    HOROVOD_SLO="ttft_p99<0.5s,step_time_p99<2.0,error_rate<0.01"

An objective name is a **series** plus an optional quantile suffix:

- series: ``ttft`` / ``tpot`` / ``e2e`` / ``queue_wait`` (fed per
  request/token by :mod:`~horovod_tpu_torch.observability.reqtrace`),
  ``step_time`` (fed per dispatched step by the training-step wrapper),
  ``error_rate`` (fed per completed request: 1.0 on error, 0.0 on ok),
  ``staleness`` / ``data_wait`` (sampled from the metrics-registry
  gauges ``serving_staleness_seconds`` / ``data_wait_seconds_recent``
  by :func:`sample_gauges`, called once per training step).
- quantile suffix ``_p50``/``_p90``/``_p99``/``_p999`` sets the error
  **budget**: ``ttft_p99<0.5`` means "at most 1% of requests may take
  longer than 0.5 s". Without a suffix the budget is 1% ; for
  ``error_rate`` the budget IS the threshold (``error_rate<0.01`` =
  at most 1% of requests may error) and a sample violates when it is
  an error.

**Burn-rate math is counted in observations (steps/requests), never
wall clock**, so drills pin exactly: each objective keeps a fast window
(``HOROVOD_SLO_FAST_WINDOW``, default 16 observations) and a slow
window (``HOROVOD_SLO_SLOW_WINDOW``, default 64) of violation bits.
``burn = violating_fraction / budget`` per window (the standard
multi-window burn-rate alerting shape); the objective **burns** when
the fast window is full and BOTH windows' burn rates reach
``HOROVOD_SLO_BURN_THRESHOLD`` (default 1.0 — consuming budget exactly
at the sustainable rate). A burning objective feeds
:func:`horovod_tpu_torch.resilience.health.record_slo_burn` (HEALTHY →
SUSPECT with the objective named, escalating to DEGRADED like every
other strike source) and the ``slo_burn_rate{objective=}`` /
``slo_budget_remaining{objective=}`` gauges that ride the ``/fleet``
plane.

:meth:`SLORegistry.judge_canary` is the rollout controller's gate: the
canary arm's completion window is evaluated against every serving-side
objective, judged **relative to the stable arm's live baseline** (a
globally slow system does not indict the canary) — replacing the
rollout's bespoke error-rate/latency-ratio pair.

stdlib-only; all registry state is lock-guarded.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "SLO_ENV",
    "FAST_WINDOW_ENV",
    "SLOW_WINDOW_ENV",
    "BURN_THRESHOLD_ENV",
    "SERIES",
    "Objective",
    "SLORegistry",
    "parse_spec",
    "configure",
    "reset",
    "default",
    "observe",
    "sample_gauges",
    "status",
]

SLO_ENV = "HOROVOD_SLO"
FAST_WINDOW_ENV = "HOROVOD_SLO_FAST_WINDOW"
SLOW_WINDOW_ENV = "HOROVOD_SLO_SLOW_WINDOW"
BURN_THRESHOLD_ENV = "HOROVOD_SLO_BURN_THRESHOLD"

#: series an objective may target, and where each is fed from
SERIES = (
    "ttft",        # reqtrace.on_first_token
    "tpot",        # reqtrace.on_token
    "e2e",         # reqtrace.on_finish
    "queue_wait",  # reqtrace.on_admit
    "step_time",   # training.InstrumentedStep
    "error_rate",  # reqtrace.on_finish / on_reject (1.0 error, 0.0 ok)
    "staleness",   # sample_gauges <- serving_staleness_seconds
    "data_wait",   # sample_gauges <- data_wait_seconds_recent
)

#: gauge families sample_gauges() polls per series (first present wins)
_GAUGE_SOURCES = {
    "staleness": ("serving_staleness_seconds",
                  "serving_subscribe_staleness_seconds"),
    "data_wait": ("data_wait_seconds_recent",),
}

_QUANTILE_BUDGETS = {"p50": 0.5, "p90": 0.1, "p99": 0.01, "p999": 0.001}


class Objective:
    """One declared objective: a violation-bit stream over two counted
    windows, with deterministic burn-rate arithmetic."""

    def __init__(self, name: str, series: str, threshold: float,
                 budget: float, *, fast: int, slow: int):
        self.name = name
        self.series = series
        self.threshold = float(threshold)
        self.budget = float(budget)
        self.fast: deque = deque(maxlen=max(1, int(fast)))
        self.slow: deque = deque(maxlen=max(1, int(slow)))

    def violates(self, value: float) -> bool:
        return float(value) > self.threshold

    def observe(self, value: float) -> None:
        bad = self.violates(value)
        self.fast.append(bad)
        self.slow.append(bad)

    def burn(self, window: deque) -> float:
        """``violating_fraction / budget`` over one window (0.0 while the
        window is empty; infinite on any violation when the budget is
        zero)."""
        if not window:
            return 0.0
        frac = sum(1 for b in window if b) / len(window)
        if self.budget <= 0.0:
            return float("inf") if frac > 0 else 0.0
        return frac / self.budget

    def budget_remaining(self) -> float:
        """Fraction of the slow window's error budget still unspent,
        clamped to [0, 1]."""
        if not self.slow:
            return 1.0
        spent = self.burn(self.slow)
        if spent == float("inf"):
            return 0.0
        return max(0.0, min(1.0, 1.0 - spent))

    def burning(self, threshold: float) -> bool:
        """Multi-window verdict: the FAST window must be full (no
        verdicts off a cold start) and both windows must burn at or past
        `threshold`."""
        return (len(self.fast) == self.fast.maxlen
                and self.burn(self.fast) >= threshold
                and self.burn(self.slow) >= threshold)


def parse_spec(spec: str, *, fast: int, slow: int) -> List[Objective]:
    """``"ttft_p99<0.5s,error_rate<0.01"`` → objectives. Unknown series
    raise ``ValueError`` (typos fail loudly, like the chaos grammar)."""
    out: List[Objective] = []
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        name, sep, thresh_s = item.partition("<")
        if not sep:
            raise ValueError(
                f"{SLO_ENV}: expected name<threshold, got {item!r}")
        name = name.strip()
        thresh_s = thresh_s.strip()
        if thresh_s.endswith("s"):
            thresh_s = thresh_s[:-1]
        threshold = float(thresh_s)
        series, budget = name, 0.01
        base, _sep2, suffix = name.rpartition("_")
        if suffix in _QUANTILE_BUDGETS and base:
            series = base
            budget = _QUANTILE_BUDGETS[suffix]
        if series == "error_rate":
            budget = threshold
            threshold = 0.5  # a sample is 1.0 (error) or 0.0 (ok)
        if series not in SERIES:
            raise ValueError(
                f"{SLO_ENV}: unknown objective series {series!r} in "
                f"{name!r} (known: {', '.join(SERIES)})")
        out.append(Objective(name, series, threshold, budget,
                             fast=fast, slow=slow))
    return out


class SLORegistry:
    """The evaluator: routes observations to objectives, publishes the
    burn gauges, strikes the health machine when an objective burns."""

    def __init__(self, spec: str = "", *,
                 fast_window: Optional[int] = None,
                 slow_window: Optional[int] = None,
                 burn_threshold: Optional[float] = None):
        self.fast_window = int(
            fast_window if fast_window is not None
            else os.environ.get(FAST_WINDOW_ENV, "16"))
        self.slow_window = int(
            slow_window if slow_window is not None
            else os.environ.get(SLOW_WINDOW_ENV, "64"))
        self.burn_threshold = float(
            burn_threshold if burn_threshold is not None
            else os.environ.get(BURN_THRESHOLD_ENV, "1.0"))
        self._lock = threading.Lock()
        self._objectives = parse_spec(
            spec, fast=self.fast_window, slow=self.slow_window)
        self._by_series: Dict[str, List[Objective]] = {}
        for o in self._objectives:
            self._by_series.setdefault(o.series, []).append(o)
        # strike cadence: one strike on entry into burning, then one
        # every fast_window observations while it stays burning (bounded
        # and counted in observations — deterministic under drill)
        self._burning: Dict[str, bool] = {}
        self._since_strike: Dict[str, int] = {}

    @property
    def objectives(self) -> List[Objective]:
        return list(self._objectives)

    def observe(self, series: str, value: float) -> None:
        """Feed one observation to every objective on `series`."""
        targets = self._by_series.get(series)
        if not targets:
            return
        strikes: List[Tuple[str, str]] = []
        with self._lock:
            for o in targets:
                o.observe(value)
                burning = o.burning(self.burn_threshold)
                window = (f"{len(o.fast)}/{o.fast.maxlen} fast, "
                          f"{len(o.slow)}/{o.slow.maxlen} slow obs")
                if burning:
                    self._since_strike[o.name] = \
                        self._since_strike.get(o.name, 0) + 1
                    if (not self._burning.get(o.name)
                            or self._since_strike[o.name]
                            >= o.fast.maxlen):
                        self._since_strike[o.name] = 0
                        strikes.append((o.name, window))
                else:
                    self._since_strike[o.name] = 0
                self._burning[o.name] = burning
                self._publish(o)
        for name, window in strikes:
            from horovod_tpu_torch.resilience import health as _health

            _health.record_slo_burn(name, window)

    def _publish(self, o: Objective) -> None:
        # caller holds self._lock; registry children have their own lock
        if not _metrics.enabled():
            return
        burn = o.burn(o.fast)
        if burn == float("inf"):
            burn = -1.0  # JSON-safe sentinel for "budget is zero"
        _metrics.gauge(
            "slo_burn_rate",
            help="fast-window error-budget burn rate per objective "
                 "(1.0 = spending exactly the budget; -1 = zero-budget "
                 "objective violated)",
            objective=o.name,
        ).set(burn)
        _metrics.gauge(
            "slo_budget_remaining",
            help="unspent fraction of the slow-window error budget per "
                 "objective",
            objective=o.name,
        ).set(o.budget_remaining())

    def sample_gauges(self) -> None:
        """Poll the gauge-sourced series (subscriber staleness, input
        data-wait) out of the metrics registry — called once per
        training step so these objectives are counted in steps."""
        for series, sources in _GAUGE_SOURCES.items():
            if series not in self._by_series:
                continue
            for fam in sources:
                v = _metrics.value(fam)
                if isinstance(v, (int, float)):
                    self.observe(series, float(v))
                    break

    def status(self) -> List[dict]:
        """Per-objective snapshot (the live view)."""
        with self._lock:
            out = []
            for o in self._objectives:
                out.append({
                    "objective": o.name,
                    "series": o.series,
                    "threshold": o.threshold,
                    "budget": o.budget,
                    "fast_burn": o.burn(o.fast),
                    "slow_burn": o.burn(o.slow),
                    "budget_remaining": o.budget_remaining(),
                    "burning": o.burning(self.burn_threshold),
                    "observations": len(o.slow),
                })
            return out

    # -------------------------------------------------- the rollout gate

    def judge_canary(self, canary: Dict[str, object],
                     stable: Dict[str, object]) -> Optional[Tuple[str, str]]:
        """Evaluate the canary arm's completion window (an
        ``reqtrace.arm_window`` dict) against every serving-side
        objective, relative to the stable arm's live baseline. Returns
        ``(objective_name, detail)`` for the first burning objective, or
        None when the canary is clean."""
        for o in self._objectives:
            if o.series in ("ttft", "tpot", "e2e", "queue_wait"):
                values = list(canary.get(o.series) or [])
                if not values:
                    continue
                frac = sum(1 for v in values if o.violates(v)) \
                    / len(values)
                burn = (float("inf") if frac > 0 else 0.0) \
                    if o.budget <= 0 else frac / o.budget
                if burn < self.burn_threshold:
                    continue
                # live-baseline guard: only indict the canary when it is
                # actually worse than what stable serves right now
                base = list(stable.get(o.series) or [])
                if base:
                    cq = _nearest_rank(values, 1.0 - o.budget)
                    sq = _nearest_rank(base, 1.0 - o.budget)
                    if cq is not None and sq is not None and cq <= sq:
                        continue
                return (o.name,
                        f"{frac:.0%} of {len(values)} canary "
                        f"{o.series} samples over {o.threshold:g}s "
                        f"(budget {o.budget:g})")
            elif o.series == "error_rate":
                done = int(canary.get("done") or 0)
                if done <= 0:
                    continue
                rate = int(canary.get("errors") or 0) / done
                if o.budget <= 0:
                    if rate > 0:
                        return (o.name,
                                f"error rate {rate:.2f} with a zero "
                                f"error budget over {done} canary "
                                f"requests")
                    continue
                if rate / o.budget >= self.burn_threshold:
                    return (o.name,
                            f"error rate {rate:.2f} > budget "
                            f"{o.budget:g} over {done} canary requests")
        return None


def _nearest_rank(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    import math

    vs = sorted(values)
    return vs[min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))]


# ------------------------------------------------- module-level default

_default_lock = threading.Lock()
_default: Optional[SLORegistry] = None


def default() -> SLORegistry:
    """The process-wide registry, parsed lazily from ``HOROVOD_SLO``."""
    global _default
    with _default_lock:
        if _default is None:
            _default = SLORegistry(os.environ.get(SLO_ENV, ""))
        return _default


def configure(spec: Optional[str], **kwargs) -> None:
    """Install the default registry programmatically (tests, drills);
    ``configure(None)`` clears every objective regardless of the env."""
    global _default
    with _default_lock:
        _default = SLORegistry(spec or "", **kwargs)


def reset() -> None:
    """Forget the default registry; the env is re-parsed on next use."""
    global _default
    with _default_lock:
        _default = None


def observe(series: str, value: float) -> None:
    """Feed the default registry (reqtrace / training-step hot path —
    a no-op dict lookup when no objective targets `series`)."""
    default().observe(series, value)


def sample_gauges() -> None:
    """Poll gauge-sourced objectives on the default registry."""
    default().sample_gauges()


def status() -> List[dict]:
    return default().status()
