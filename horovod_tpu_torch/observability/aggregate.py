"""Fleet-wide metric aggregation over the rendezvous KV plane.

The metrics registry is strictly per-process: each rank keeps its own counters
and only rank 0's view is exported. This module is the distributed half —
the rebuild of what Horovod's coordinator knows implicitly through the
negotiation protocol (it sees every rank's requests; PAPER.md L4) but never
exposes:

- :class:`MetricsPublisher` — every rank periodically publishes its
  :func:`~horovod_tpu_torch.observability.metrics.snapshot` (plus its recent
  collective-arrival ring and clock-sync info) to the rendezvous KV under
  ``/obs/snap/<rank>`` with a TTL. The WAL-backed
  :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` is the
  transport: a KV restart replays the last snapshots, and a rank that
  stops publishing *tombstones* instead of vanishing.
- :class:`FleetAggregator` — rank 0 (or any observer) merges the
  snapshots into fleet series: per-metric ``min/mean/max/p99`` across
  ranks plus ``rank``-labeled raw series; histograms merge bucket-wise.
  Dead ranks (TTL-expired snapshots, HTTP 410 / tombstone) are SURFACED
  in ``dead_ranks`` — a rank that stopped reporting is a finding, not a
  smaller denominator. Correlated collective arrivals are unioned by
  ``(step, gen, seq)`` and fed through
  :func:`horovod_tpu_torch.observability.straggler.attribute`, so the fleet view
  names the straggler.

The rank-0 HTTP endpoint grows ``/fleet`` (Prometheus exposition of the
fleet series) and ``/fleet.json`` once an aggregator is registered.

stdlib-only at import (the rendezvous client is imported lazily — this
module must stay importable from collection-time contexts, like the rest
of the package).
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from horovod_tpu_torch.observability import clock as _clock
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import straggler as _straggler

logger = logging.getLogger("horovod_tpu_torch.observability")

__all__ = [
    "MetricsPublisher",
    "FleetAggregator",
    "merge_snapshots",
    "to_prometheus_fleet",
    "set_aggregator",
    "get_aggregator",
    "fleet_json",
    "fleet_prometheus",
    "SNAP_SCOPE",
]

#: KV namespace the publishers write under (``<scope>/<rank>``)
SNAP_SCOPE = "/obs/snap"

#: default lease on a published snapshot: miss ~3 publish intervals and the
#: rank tombstones in the fleet view
DEFAULT_TTL_FACTOR = 3.0
DEFAULT_INTERVAL = 10.0


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending sequence."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return float(sorted_vals[0])
    pos = q * (len(sorted_vals) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return float(sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac)


class MetricsPublisher:
    """Publish this rank's metrics snapshot to the rendezvous KV on a
    cadence.

    `kv` is anything with ``put(key, bytes, ttl=...)`` — the in-process
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` (single-controller)
    or a :class:`~horovod_tpu_torch.run.rendezvous.KVStoreClient` (each launched
    worker builds one from ``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT``).
    :meth:`publish_once` is the deterministic spelling tests and step
    hooks use; :meth:`start` runs it on a daemon thread every `interval`
    seconds. The TTL (default ``3 × interval``) is the fleet's
    failure-detection horizon: a rank that stops publishing shows up DEAD
    in the aggregator, not absent."""

    def __init__(self, kv, rank: int, *, scope: str = SNAP_SCOPE,
                 interval: float = DEFAULT_INTERVAL,
                 ttl: Optional[float] = None,
                 arrival_window: Optional[int] = None):
        self._kv = kv
        self._rank = int(rank)
        self._scope = "/" + scope.strip("/")
        self._interval = float(interval)
        self._ttl = (
            float(ttl) if ttl is not None
            else DEFAULT_TTL_FACTOR * self._interval
        )
        self._arrival_window = arrival_window
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # sync the clock up front, not at the first publish an interval
        # away: export_recent corrects ring timestamps retroactively, but
        # an early estimate tightens the first published window too
        self._ensure_clock_sync()

    @property
    def key(self) -> str:
        return f"{self._scope}/{self._rank}"

    def _ensure_clock_sync(self) -> None:
        """First publication estimates this rank's clock offset against the
        KV it publishes through (once; elastic resizes re-estimate via the
        coordinator). Without this, multi-host arrival timestamps would
        ride raw per-host monotonic clocks — whose origins differ by host
        uptime — and attribution would flag a permanent false straggler.
        Best-effort: a failed probe leaves offset 0 rather than blocking
        publication."""
        if _clock.error_bound() is not None:
            return
        try:
            _clock.refresh_from_kv(self._kv, rank=self._rank)
        except Exception as e:
            logger.debug("clock sync against the KV failed: %s", e)

    def payload(self) -> dict:
        self._ensure_clock_sync()
        return {
            "rank": self._rank,
            "sent_monotonic": time.monotonic() + _clock.offset(),
            "clock": _clock.info(),
            "metrics": _metrics.snapshot(),
            "arrivals": _straggler.export_recent(self._arrival_window),
        }

    def publish_once(self) -> None:
        blob = json.dumps(self.payload()).encode()
        self._kv.put(self.key, blob, ttl=self._ttl)
        if _metrics.enabled():
            _metrics.counter(
                "fleet_snapshots_published",
                help="metric snapshots published to the rendezvous KV",
            ).inc()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self._interval):
                try:
                    self.publish_once()
                except Exception as e:
                    # observability must never take down training; the TTL
                    # expiring is itself the failure signal
                    logger.debug("metrics publish failed: %s", e)

        self._thread = threading.Thread(
            target=_loop, name="hvd-metrics-publish", daemon=True)
        self._thread.start()

    def stop(self, final_publish: bool = True) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=5)
            self._thread = None
        if final_publish:
            try:
                self.publish_once()
            except Exception as e:
                logger.debug("final metrics publish failed: %s", e)


def merge_snapshots(snaps: Dict[int, dict]) -> dict:
    """Fold per-rank :func:`metrics.snapshot` dicts into fleet families.

    Counters/gauges become ``{"ranks": {rank: v}, "min", "mean", "max",
    "p99"}`` per labeled child; histograms merge bucket-wise (families fix
    their bounds at creation, so same-name buckets line up) with a
    ``p99`` estimated from the merged cumulative counts (upper bucket
    bound — conservative)."""
    fleet: dict = {}
    for rank in sorted(snaps):
        for name, fam in (snaps[rank] or {}).items():
            slot = fleet.setdefault(
                name,
                {"type": fam["type"], "help": fam.get("help", ""),
                 "samples": {}},
            )
            if slot["type"] != fam["type"]:
                continue  # conflicting registration; skip rather than mix
            for key, sample in fam.get("samples", {}).items():
                if fam["type"] == "histogram":
                    h = slot["samples"].setdefault(
                        key, {"buckets": {}, "sum": 0.0, "count": 0})
                    for le, cum in sample.get("buckets", {}).items():
                        h["buckets"][le] = h["buckets"].get(le, 0) + cum
                    h["sum"] += float(sample.get("sum", 0.0))
                    h["count"] += int(sample.get("count", 0))
                else:
                    s = slot["samples"].setdefault(key, {"ranks": {}})
                    s["ranks"][str(rank)] = float(sample)
    for name, fam in fleet.items():
        for key, s in fam["samples"].items():
            if fam["type"] == "histogram":
                s["p99"] = _hist_p99(s)
            else:
                vals = sorted(s["ranks"].values())
                s["min"] = vals[0]
                s["max"] = vals[-1]
                s["mean"] = sum(vals) / len(vals)
                s["p99"] = _percentile(vals, 0.99)
    return fleet


def _hist_p99(h: dict) -> Optional[float]:
    count = h.get("count", 0)
    if not count:
        return None
    target = 0.99 * count
    finite = [
        (float(le), cum) for le, cum in h["buckets"].items() if le != "+Inf"
    ]
    for le, cum in sorted(finite):
        if cum >= target:
            return le
    # target falls in the +Inf tail: report the LARGEST finite bound (a
    # floor), not whichever bucket dict order put last
    return max(le for le, _ in finite) if finite else None


class FleetAggregator:
    """Collect every rank's published snapshot and serve the merged view.

    `kv` is the in-process :class:`KVStoreServer` (liveness read straight
    off the store: live keys + tombstones) or a :class:`KVStoreClient`
    probing ranks ``0..world-1`` (a tombstoned snapshot answers HTTP 410 →
    the rank is DEAD; 404 → never published). Pass `world` whenever more
    than one process publishes — including server-backed setups — so
    straggler attribution can defer a collective until EVERY rank's
    arrival landed (the slow rank's snapshot is the one most likely still
    in flight). Construction registers the instance as the process
    default so the rank-0 HTTP endpoint can serve
    ``/fleet``/``/fleet.json`` (``register=False`` opts out)."""

    def __init__(self, kv, *, world: Optional[int] = None,
                 scope: str = SNAP_SCOPE, register: bool = True):
        if world is None and not (
            hasattr(kv, "live_keys") and hasattr(kv, "dead_keys")
        ):
            # a probing client cannot enumerate the store: without a world
            # it would silently aggregate zero ranks forever
            raise ValueError(
                "FleetAggregator over a KV client needs world=<rank "
                "count> to know which /obs/snap/<rank> keys to probe "
                "(a KVStoreServer enumerates the store itself)"
            )
        self._kv = kv
        self._world = world
        self._scope = "/" + scope.strip("/")
        self._last: Optional[dict] = None
        if register:
            set_aggregator(self)

    # ------------------------------------------------------------- fetching

    def _rank_of(self, key: str) -> Optional[int]:
        tail = key[len(self._scope) + 1:]
        try:
            return int(tail)
        except ValueError:
            return None

    def _fetch_all(self) -> Tuple[Dict[int, dict], List[int]]:
        """{rank: payload}, dead_ranks — via store enumeration (server) or
        per-rank probing (client)."""
        from horovod_tpu_torch.run.rendezvous import DeadRankError

        snaps: Dict[int, dict] = {}
        dead: List[int] = []
        if hasattr(self._kv, "live_keys") and hasattr(self._kv, "dead_keys"):
            prefix = self._scope + "/"
            for key in self._kv.live_keys(prefix):
                rank = self._rank_of(key)
                if rank is None:
                    continue
                blob = self._kv.get(key)
                if blob is not None:
                    snaps[rank] = self._decode(blob)
            for key in self._kv.dead_keys():
                if key.startswith(prefix):
                    rank = self._rank_of(key)
                    if rank is not None and rank not in snaps:
                        dead.append(rank)
        else:
            world = self._world or 0
            for rank in range(world):
                try:
                    blob = self._kv.get(f"{self._scope}/{rank}")
                except DeadRankError:
                    dead.append(rank)
                    continue
                if blob is not None:
                    snaps[rank] = self._decode(blob)
        return snaps, sorted(dead)

    @staticmethod
    def _decode(blob: bytes) -> dict:
        try:
            return json.loads(blob)
        except ValueError:
            return {}

    # ------------------------------------------------------------ the merge

    def collect(self) -> dict:
        """One aggregation pass: fetch, merge, attribute, remember."""
        snaps, dead = self._fetch_all()
        metric_snaps = {
            r: p.get("metrics", {}) for r, p in snaps.items()
        }
        merged_arrivals = _straggler.merge_arrival_exports(
            p.get("arrivals") for p in snaps.values()
        )
        # single-controller snapshots carry COMPLETE arrival sets (one
        # process simulates every rank), so a key needs only the default
        # 2 arrivals; with several publishing processes a key is deferred
        # until the FULL world's arrivals landed — the straggler's own
        # snapshot is the one most likely still in flight, so scoring
        # against the published-so-far subset would systematically miss
        # its decisive late entry. `world` (pass it even with a
        # server-backed store) is authoritative; without it the
        # live+dead union is the best available floor.
        expected = None
        if self._world:
            expected = self._world
        elif len(snaps) > 1:
            expected = len(snaps) + len(dead)
        # per-rank input waits ride each snapshot as the
        # data_wait_seconds_recent gauge: hand them to attribution so a
        # named straggler is classified input- vs compute-bound on the
        # fleet view too
        data_waits = {}
        for r, m in metric_snaps.items():
            fam = m.get("data_wait_seconds_recent") or {}
            v = fam.get("samples", {}).get("")
            if v is not None:
                try:
                    data_waits[int(r)] = float(v)
                except (TypeError, ValueError):
                    continue
        straggler = _straggler.attribute(
            merged_arrivals, expected_ranks=expected,
            data_waits=data_waits or None,
        )
        out = {
            "collected_at": time.time(),
            "ranks": sorted(snaps),
            "dead_ranks": dead,
            "clock": {
                str(r): p.get("clock") for r, p in snaps.items()
            },
            "metrics": merge_snapshots(metric_snaps),
            "straggler": straggler,
        }
        self._last = out
        if _metrics.enabled():
            _metrics.counter(
                "fleet_aggregations",
                help="fleet aggregation passes completed",
            ).inc()
            _metrics.gauge(
                "fleet_ranks", help="ranks with a live published snapshot",
            ).set(len(snaps))
            _metrics.gauge(
                "fleet_dead_ranks",
                help="ranks whose snapshot lease expired (TTL/tombstone)",
            ).set(len(dead))
        return out

    @property
    def last(self) -> Optional[dict]:
        return self._last


def to_prometheus_fleet(agg: dict) -> str:
    """Render one :meth:`FleetAggregator.collect` result as Prometheus
    text exposition: ``fleet_<name>{stat=...}`` summary gauges +
    rank-labeled raw series per scalar family, merged ``_bucket``/``_sum``/
    ``_count`` series (with their own explicit ``# TYPE ... histogram``
    line) per histogram family, and ``fleet_rank_alive`` liveness. Every
    family — the fleet synthetics included — gets a ``# HELP`` line beside
    its ``# TYPE``, so a Prometheus UI explains the fleet series exactly
    like the per-process ones."""
    from horovod_tpu_torch.observability.exporters import (
        _fmt, _prom_labels, _prom_name,
    )

    lines: List[str] = []

    def _help(pname: str, text: str) -> None:
        if text:
            esc = text.replace("\\", "\\\\").replace("\n", "\\n")
            lines.append(f"# HELP {pname} {esc}")

    metrics = agg.get("metrics", {})
    for name in sorted(metrics):
        fam = metrics[name]
        pname = _prom_name(name)
        if fam["type"] == "histogram":
            _help(f"fleet_{pname}",
                  (fam.get("help") or "") + " (fleet-merged across ranks)")
            lines.append(f"# TYPE fleet_{pname} histogram")
            for key in sorted(fam["samples"]):
                s = fam["samples"][key]
                for le, cum in sorted(
                    s["buckets"].items(),
                    key=lambda kv: (kv[0] == "+Inf", _le_sort(kv[0])),
                ):
                    lines.append(
                        f"fleet_{pname}_bucket"
                        f"{_prom_labels(key, 'le=' + _q(le))} {cum}"
                    )
                lines.append(
                    f"fleet_{pname}_sum{_prom_labels(key)} {_fmt(s['sum'])}"
                )
                lines.append(
                    f"fleet_{pname}_count{_prom_labels(key)} {s['count']}"
                )
                if s.get("p99") is not None:
                    lines.append(
                        f"fleet_{pname}_p99{_prom_labels(key)} "
                        f"{_fmt(s['p99'])}"
                    )
        else:
            _help(f"fleet_{pname}",
                  (fam.get("help") or "")
                  + " (min/mean/max/p99 across ranks)")
            lines.append(f"# TYPE fleet_{pname} gauge")
            for key in sorted(fam["samples"]):
                s = fam["samples"][key]
                for stat in ("min", "mean", "max", "p99"):
                    lines.append(
                        f"fleet_{pname}"
                        f"{_prom_labels(key, 'stat=' + _q(stat))} "
                        f"{_fmt(s[stat])}"
                    )
            _help(pname, fam.get("help") or "")
            lines.append(f"# TYPE {pname} {fam['type']}")
            for key in sorted(fam["samples"]):
                for rank in sorted(
                    fam["samples"][key]["ranks"], key=int
                ):
                    v = fam["samples"][key]["ranks"][rank]
                    extra = None if "rank=" in key else "rank=" + _q(rank)
                    lines.append(
                        f"{pname}{_prom_labels(key, extra)} {_fmt(v)}"
                    )
    _help("fleet_rank_alive",
          "1 while the rank's published snapshot lease is live, 0 once "
          "it TTL-expired or tombstoned")
    lines.append("# TYPE fleet_rank_alive gauge")
    for r in agg.get("ranks", []):
        lines.append(f'fleet_rank_alive{{rank="{r}"}} 1')
    for r in agg.get("dead_ranks", []):
        lines.append(f'fleet_rank_alive{{rank="{r}"}} 0')
    s = agg.get("straggler")
    if s:
        # distinct family names: the aggregated per-rank `straggler_rank`
        # series above already claims that name's TYPE line
        _help("fleet_straggler_detected_rank",
              "rank the fleet-side arrival correlation currently "
              "attributes the straggler to")
        lines.append("# TYPE fleet_straggler_detected_rank gauge")
        lines.append(f"fleet_straggler_detected_rank {s['rank']}")
        _help("fleet_straggler_detected_spread_seconds",
              "arrival spread behind the rest of the fleet at the "
              "attributed collective")
        lines.append("# TYPE fleet_straggler_detected_spread_seconds gauge")
        lines.append(
            "fleet_straggler_detected_spread_seconds "
            f"{_fmt(s['spread_seconds'])}"
        )
    return "\n".join(lines) + "\n" if lines else ""


def _q(v) -> str:
    from horovod_tpu_torch.observability.exporters import _quote_label_value

    return _quote_label_value(v)


def _le_sort(le: str) -> float:
    try:
        return float(le)
    except ValueError:
        return math.inf


# ------------------------------------------------- process-default instance

_default_lock = threading.Lock()
_default: Optional[FleetAggregator] = None


def set_aggregator(agg: Optional[FleetAggregator]) -> None:
    """Register the aggregator the rank-0 HTTP endpoint serves from
    (``/fleet``, ``/fleet.json``); ``None`` unregisters."""
    global _default
    with _default_lock:
        _default = agg


def get_aggregator() -> Optional[FleetAggregator]:
    return _default


def fleet_json() -> Optional[str]:
    """Fresh aggregation pass rendered as JSON, or None without a
    registered aggregator (the ``/fleet.json`` handler)."""
    agg = get_aggregator()
    if agg is None:
        return None
    return json.dumps(agg.collect(), indent=1)


def fleet_prometheus() -> Optional[str]:
    """Fresh aggregation pass rendered as exposition text, or None without
    a registered aggregator (the ``/fleet`` handler)."""
    agg = get_aggregator()
    if agg is None:
        return None
    return to_prometheus_fleet(agg.collect())
