"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

Counterpart of ``horovod_tpu/observability/metrics.py``, copied whole (it
is stdlib-only): instrumented layers call
``counter("allreduce_bytes").inc(n)`` and anything (tests, the smoke
script, callbacks) reads a consistent snapshot. The exporters that serve
it wait for the observability port.

Design constraints, in order:

1. **stdlib only** — importing this module must never import torch or
   touch a device backend (it is imported from hot paths and from the
   launcher-side modules).
2. **near-zero cost when disabled** — ``HOROVOD_METRICS_ENABLED=0`` (or
   :func:`set_enabled`\\(False)) makes every accessor return a shared no-op
   whose ``inc``/``set``/``observe`` do nothing; the per-event cost is one
   global bool check.
3. **lock-safe** — one registry lock guards family/child creation; each
   child serializes its own updates, so concurrent ``inc`` from the core's
   cycle thread, the bucket flusher, and user threads never lose counts.

Usage::

    from horovod_tpu_torch.observability import metrics
    metrics.counter("allreduce_count").inc()
    metrics.counter("allreduce_bytes", rank=0).inc(4096)
    metrics.histogram("core_cycle_latency_seconds").observe(0.003)
    snap = metrics.snapshot()
    print(metrics.summary())
"""

from __future__ import annotations

import math
import os
import threading
from typing import Dict, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "counter",
    "gauge",
    "histogram",
    "snapshot",
    "summary",
    "value",
    "reset",
    "enabled",
    "set_enabled",
    "DEFAULT_LATENCY_BUCKETS",
    "DEFAULT_SIZE_BUCKETS",
]

#: seconds — spans 100µs cycle callbacks to multi-second stalls
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: dimensionless sizes/counts — tensors per fused plan, bytes per op
DEFAULT_SIZE_BUCKETS = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096, 16384, 65536,
    262144, 1048576, 16777216, 268435456,
)


def _env_enabled() -> bool:
    return os.environ.get(
        "HOROVOD_METRICS_ENABLED", "1"
    ).lower() not in ("0", "false", "off")


_enabled = _env_enabled()


def enabled() -> bool:
    """Global metrics switch (``HOROVOD_METRICS_ENABLED``, default on)."""
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip the global switch at runtime (tests; per-job opt-out). Metrics
    recorded before disabling remain in the registry."""
    global _enabled
    _enabled = bool(on)


class Counter:
    """Monotonically increasing value (one labeled child)."""

    __slots__ = ("_lock", "_value")

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return self._value


class Gauge:
    """Set-to-current value (one labeled child)."""

    __slots__ = ("_lock", "_value")

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._value

    def _sample(self):
        return self._value


class Histogram:
    """Fixed-bucket histogram (one labeled child). Buckets are cumulative
    upper bounds, Prometheus-style; an implicit ``+Inf`` bucket catches the
    tail. Bucket bounds are fixed at family creation so children and
    snapshots always agree."""

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    kind = "histogram"

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        if math.isnan(v):
            return  # a NaN observation would poison sum forever
        i = 0
        for bound in self.buckets:
            if v <= bound:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def _sample(self):
        with self._lock:
            cumulative, out = 0, {}
            for bound, c in zip(self.buckets, self._counts):
                cumulative += c
                out[repr(float(bound))] = cumulative
            out["+Inf"] = cumulative + self._counts[-1]
            return {"buckets": out, "sum": self._sum, "count": self._count}


class _Noop:
    """Shared do-nothing metric returned while metrics are disabled —
    quacks like Counter, Gauge, and Histogram at once."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    value = 0.0
    count = 0
    sum = 0.0


_NOOP = _Noop()

_LabelKey = Tuple[Tuple[str, str], ...]


class _Family:
    """One named metric with its labeled children. The unlabeled child has
    the empty label key (reference-free: ``counter("x")`` and
    ``counter("x", rank=0)`` coexist under one family)."""

    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name, kind, help_text, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        self.children: Dict[_LabelKey, object] = {}

    def _make_child(self):
        if self.kind == "counter":
            return Counter()
        if self.kind == "gauge":
            return Gauge()
        return Histogram(self.buckets)


def _label_key(labels: dict) -> _LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Registry:
    """Lock-safe collection of metric families."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # ------------------------------------------------------------ accessors

    def _child(self, name, kind, help_text, buckets, labels):
        if not _enabled:
            return _NOOP
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = _Family(
                    name, kind, help_text, buckets
                )
            elif fam.kind != kind:
                raise ValueError(
                    f"metric '{name}' already registered as {fam.kind}, "
                    f"requested as {kind}"
                )
            child = fam.children.get(key)
            if child is None:
                child = fam.children[key] = fam._make_child()
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        """The counter child for ``(name, labels)``, created on first use."""
        return self._child(name, "counter", help, None, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child(name, "gauge", help, None, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        """The histogram child for ``(name, labels)``. ``buckets`` applies
        on family creation only (children share the family's bounds)."""
        return self._child(
            name, "histogram", help,
            tuple(buckets) if buckets else DEFAULT_LATENCY_BUCKETS, labels,
        )

    # ------------------------------------------------------------- readers

    def snapshot(self) -> dict:
        """Point-in-time copy of every family::

            {name: {"type": "counter"|"gauge"|"histogram", "help": str,
                    "samples": {"" | "k=v,k2=v2": value-or-hist-dict}}}

        Counter/gauge samples are floats; histogram samples are
        ``{"buckets": {le: cumulative_count, ..., "+Inf": n},
        "sum": float, "count": int}``.
        """
        with self._lock:
            fams = [
                (f, list(f.children.items()))
                for f in self._families.values()
            ]
        out = {}
        for fam, children in fams:
            samples = {
                ",".join(f"{k}={v}" for k, v in key): child._sample()
                for key, child in children
            }
            out[fam.name] = {
                "type": fam.kind, "help": fam.help, "samples": samples
            }
        return out

    def value(self, name: str, **labels):
        """One sample, or None when the metric/child does not exist."""
        with self._lock:
            fam = self._families.get(name)
            child = fam.children.get(_label_key(labels)) if fam else None
        return None if child is None else child._sample()

    def summary(self, snap: Optional[dict] = None) -> str:
        """Human-readable dump (what ``MetricsCallback`` logs every N
        steps)."""
        snap = self.snapshot() if snap is None else snap
        lines = []
        for name in sorted(snap):
            fam = snap[name]
            for key in sorted(fam["samples"]):
                sample = fam["samples"][key]
                label = f"{name}{{{key}}}" if key else name
                if fam["type"] == "histogram":
                    count = sample["count"]
                    mean = sample["sum"] / count if count else 0.0
                    lines.append(
                        f"{label:<52} count={count} mean={mean:.6g} "
                        f"sum={sample['sum']:.6g}"
                    )
                else:
                    lines.append(f"{label:<52} {sample:.6g}")
        return "\n".join(lines) if lines else "(no metrics recorded)"

    def reset(self) -> None:
        """Drop every family (tests / per-run isolation)."""
        with self._lock:
            self._families.clear()


#: default process-wide registry (what ``hvd.metrics.*`` operates on)
REGISTRY = Registry()

counter = REGISTRY.counter
gauge = REGISTRY.gauge
histogram = REGISTRY.histogram
snapshot = REGISTRY.snapshot
value = REGISTRY.value
summary = REGISTRY.summary
reset = REGISTRY.reset
