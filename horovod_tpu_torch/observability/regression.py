"""Performance-regression sentinel: rolling baselines + bench trends.

Two consumers of the same idea — "is this metric drifting from its own
history?" — at two timescales:

- **In-process** (:class:`Baseline`, :func:`track`): every tracked
  metric keeps an EWMA of its value plus an EWMA of its absolute
  deviation (a MAD proxy), warmup-guarded like the PR-9 numerics spike
  detector — the baseline absorbs only non-drifting samples, so a step
  change is flagged on EVERY sample until it is acknowledged (or
  :func:`forget`), instead of the baseline quietly chasing the
  regression. The training-step wrapper feeds step time, throughput,
  and data-wait through here; a ``drift`` verdict sets
  ``regression_drift{metric=}`` and counts
  ``regression_drift_events{metric=}``.
- **Across runs** (:func:`load_bench`, :func:`trend`): the
  ``BENCH_*.json`` trajectory finally gets a consumer —
  :func:`trend` diffs two or more bench files into a
  per-metric trend table with a deterministic regressed/ok verdict per
  row (threshold-fractional, direction inferred from the metric name:
  ``*_per_sec`` / ``*tflops`` / ``*goodput*`` / ``*gbps`` / ``*mfu*``
  are higher-is-better, everything else lower-is-better) and a nonzero
  exit on regression.

Knobs: ``HOROVOD_SLO_DRIFT_ALPHA`` (EWMA smoothing, default 0.2),
``HOROVOD_SLO_DRIFT_WARMUP`` (samples absorbed before verdicts,
default 20), ``HOROVOD_SLO_DRIFT_FACTOR`` (deviation multiple that
counts as drift, default 8.0; a relative floor of 25% of the baseline
keeps near-constant series from flagging on timer jitter).

stdlib-only.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "DRIFT_ALPHA_ENV",
    "DRIFT_WARMUP_ENV",
    "DRIFT_FACTOR_ENV",
    "Baseline",
    "track",
    "verdicts",
    "forget",
    "reset",
    "load_bench",
    "higher_is_better",
    "trend",
]

DRIFT_ALPHA_ENV = "HOROVOD_SLO_DRIFT_ALPHA"
DRIFT_WARMUP_ENV = "HOROVOD_SLO_DRIFT_WARMUP"
DRIFT_FACTOR_ENV = "HOROVOD_SLO_DRIFT_FACTOR"

#: drift needs the deviation to also exceed this fraction of the
#: baseline — an all-but-constant series (MAD -> 0) must not flag on
#: scheduler jitter
_REL_FLOOR = 0.25


class Baseline:
    """EWMA + MAD rolling baseline with warmup-guarded drift verdicts.

    The PR-9 numerics-EWMA shape: during warmup every sample absorbs
    and the verdict is ``"warmup"``; after warmup a sample whose
    absolute deviation exceeds ``factor * max(MAD, rel_floor *
    |baseline|)`` is ``"drift"`` and is NOT absorbed (the baseline
    remembers what normal looked like); everything else absorbs and is
    ``"ok"``."""

    def __init__(self, *, alpha: Optional[float] = None,
                 warmup: Optional[int] = None,
                 factor: Optional[float] = None,
                 rel_floor: float = _REL_FLOOR):
        self.alpha = float(
            alpha if alpha is not None
            else os.environ.get(DRIFT_ALPHA_ENV, "0.2"))
        self.warmup = int(
            warmup if warmup is not None
            else os.environ.get(DRIFT_WARMUP_ENV, "20"))
        self.factor = float(
            factor if factor is not None
            else os.environ.get(DRIFT_FACTOR_ENV, "8.0"))
        self.rel_floor = float(rel_floor)
        self.ewma: Optional[float] = None
        self.mad = 0.0
        self.n = 0          # absorbed (good) samples only
        self.streak = 0     # consecutive drift verdicts

    def _absorb(self, value: float, dev: float) -> None:
        if self.ewma is None:
            self.ewma = value
        else:
            self.ewma += self.alpha * (value - self.ewma)
        self.mad += self.alpha * (dev - self.mad)
        self.n += 1
        self.streak = 0

    def update(self, value: float) -> dict:
        value = float(value)
        dev = 0.0 if self.ewma is None else abs(value - self.ewma)
        if self.n < self.warmup:
            self._absorb(value, dev)
            state = "warmup"
        else:
            spread = max(self.mad,
                         self.rel_floor * abs(self.ewma or 0.0))
            if dev > self.factor * spread:
                self.streak += 1
                state = "drift"
            else:
                self._absorb(value, dev)
                state = "ok"
        return {
            "state": state,
            "value": value,
            "ewma": self.ewma,
            "mad": self.mad,
            "deviation": dev,
            "streak": self.streak,
        }


_lock = threading.Lock()
_baselines: Dict[str, Baseline] = {}
_last: Dict[str, dict] = {}


def track(name: str, value: float, **baseline_kwargs) -> dict:
    """Feed one sample of `name` through its rolling baseline and
    publish the verdict (``regression_drift{metric=}`` gauge;
    ``regression_drift_events{metric=}`` counts drifting samples)."""
    with _lock:
        b = _baselines.get(name)
        if b is None:
            b = Baseline(**baseline_kwargs)
            _baselines[name] = b
        v = b.update(value)
        _last[name] = v
    if _metrics.enabled():
        _metrics.gauge(
            "regression_drift",
            help="1 while the metric's latest sample drifts from its "
                 "rolling EWMA+MAD baseline, else 0",
            metric=name,
        ).set(1.0 if v["state"] == "drift" else 0.0)
        if v["state"] == "drift":
            _metrics.counter(
                "regression_drift_events",
                help="samples that drifted from their rolling baseline",
                metric=name,
            ).inc()
    return v


def verdicts() -> Dict[str, dict]:
    """Latest verdict per tracked metric."""
    with _lock:
        return dict(_last)


def forget(name: str) -> None:
    """Drop one metric's baseline (re-warms on next sample) — the
    acknowledge-a-regime-change path."""
    with _lock:
        _baselines.pop(name, None)
        _last.pop(name, None)


def reset() -> None:
    """Drop every baseline (tests)."""
    with _lock:
        _baselines.clear()
        _last.clear()


# ------------------------------------------------------- bench trends


def load_bench(path: str) -> Dict[str, float]:
    """Parse one ``BENCH_*.json`` / ``--serving-ab``-style file into its
    numeric fields. Tolerant of JSON-lines (every parseable line's
    numeric fields merge, later lines win) — the bench emits one flat
    JSON object per line."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                obj = json.loads(line)
            except ValueError:
                continue
            if not isinstance(obj, dict):
                continue
            for k, v in obj.items():
                if isinstance(v, bool):
                    continue
                if isinstance(v, (int, float)):
                    out[str(k)] = float(v)
    return out


_HIGHER_BETTER_MARKS = (
    "per_sec", "per_second", "tflops", "gbps", "goodput", "mfu",
    "tokens_per", "examples_per", "images_per", "throughput",
)


def higher_is_better(metric: str) -> bool:
    m = metric.lower()
    return any(mark in m for mark in _HIGHER_BETTER_MARKS)


def trend(series: List[Dict[str, float]], *,
          threshold: float = 0.05) -> dict:
    """Diff >= 2 bench snapshots (oldest first) into a per-metric trend
    table. The baseline for each metric is the EWMA of every snapshot
    but the last (alpha 0.5, seeded on the first value — deterministic);
    the last snapshot regresses when it is worse than that baseline by
    more than `threshold` (fractional), direction per
    :func:`higher_is_better`. Metrics missing from the last snapshot
    are skipped; metrics new in it have no baseline and cannot regress.
    """
    if len(series) < 2:
        raise ValueError(
            f"trend needs >= 2 bench snapshots, got {len(series)}")
    rows = []
    regressed = []
    last = series[-1]
    for metric in sorted(last):
        values = [s[metric] for s in series if metric in s]
        if len(values) < 2:
            continue
        base = values[0]
        for v in values[1:-1]:
            base += 0.5 * (v - base)
        cur = values[-1]
        if base == 0.0:
            delta = 0.0
        else:
            delta = (cur - base) / abs(base)
        better_up = higher_is_better(metric)
        bad = (-delta if better_up else delta) > threshold
        rows.append({
            "metric": metric,
            "values": values,
            "baseline": base,
            "last": cur,
            "delta_frac": delta,
            "direction": "higher_is_better" if better_up
            else "lower_is_better",
            "regressed": bad,
        })
        if bad:
            regressed.append(metric)
    return {"rows": rows, "regressed": regressed,
            "threshold": threshold}
