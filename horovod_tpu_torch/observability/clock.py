"""Cross-rank clock model: per-rank offset to the rendezvous KV server's
clock, and the skew-corrected merge of per-rank chrome-trace files.

Every rank's host spans are stamped with its OWN ``time.monotonic`` —
monotonic clocks share no origin across processes, so two ranks' views of
one collective land arbitrarily far apart when naively overlaid. The fix is
the classic NTP request/response-midpoint estimate against one shared
reference — the rendezvous KV server's clock (it is already the one process
every rank talks to):

    t0 = local monotonic          (request sent)
    ts = server monotonic         (server read, ridden back in the reply)
    t1 = local monotonic          (response received)
    offset ≈ ts - (t0 + t1) / 2   |error| ≤ (t1 - t0) / 2  (the half-RTT)

:func:`estimate_offset` takes the minimum-RTT sample of N probes (the
tightest bound); :func:`refresh` stores the estimate process-wide, mirrors
it into the ``observability_clock_offset_seconds`` /
``observability_clock_error_seconds`` gauges, and hands the metadata to
:func:`~horovod_tpu_torch.observability.trace.set_clock_info` so every flushed
trace file carries its own correction. The elastic driver re-estimates
after each resize (a new generation may migrate the KV or the host's NTP
may have stepped); on a LAN the error bound is sub-millisecond — document
any correlation tighter than one RTT as unresolvable.

:func:`merge_rank_traces` applies the corrections: each rank file's events
are shifted onto the server timebase (its ``clock_sync`` meta event carries
``epoch_monotonic_ns`` + ``offset_s``), host lanes are renamed
``rank<r>-host``, and the result is one Perfetto load where one
collective's spans — correlated by their ``(step, gen, seq)`` args — align
as a row per rank.

stdlib-only (imported by the launcher-side aggregator and by tools).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Iterable, Optional, Sequence, Tuple

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import trace as _trace

__all__ = [
    "estimate_offset",
    "refresh",
    "refresh_from_kv",
    "offset",
    "error_bound",
    "info",
    "reset",
    "merge_rank_traces",
]

#: probes per estimate; the min-RTT sample wins (NTP's discipline)
DEFAULT_SAMPLES = 5

_lock = threading.Lock()
_offset_s = 0.0
_error_s: Optional[float] = None
_generation = 0
_refreshed_at: Optional[float] = None


def estimate_offset(
    read_server_clock: Callable[[], float], samples: int = DEFAULT_SAMPLES,
) -> Tuple[float, float]:
    """``(offset_seconds, error_bound_seconds)`` between this process's
    ``time.monotonic`` and the clock behind `read_server_clock` (a callable
    returning the server's monotonic seconds). The minimum-RTT probe is
    used: its half-RTT is the tightest achievable bound on the midpoint
    estimate."""
    best: Optional[Tuple[float, float]] = None  # (half_rtt, offset)
    for _ in range(max(1, samples)):
        t0 = time.monotonic()
        ts = float(read_server_clock())
        t1 = time.monotonic()
        half_rtt = (t1 - t0) / 2.0
        off = ts - (t0 + t1) / 2.0
        if best is None or half_rtt < best[0]:
            best = (half_rtt, off)
    return best[1], best[0]


def refresh(
    read_server_clock: Callable[[], float],
    *,
    rank: int = 0,
    generation: Optional[int] = None,
    samples: int = DEFAULT_SAMPLES,
) -> Tuple[float, float]:
    """Estimate and STORE this process's offset (returns ``(offset,
    error_bound)``). Mirrors the estimate into the clock gauges and into
    the trace recorder's ``clock_sync`` metadata so subsequently flushed
    trace files are mergeable."""
    global _offset_s, _error_s, _generation, _refreshed_at
    off, err = estimate_offset(read_server_clock, samples)
    with _lock:
        _offset_s = off
        _error_s = err
        if generation is not None:
            _generation = int(generation)
        _refreshed_at = time.monotonic()
    if _metrics.enabled():
        _metrics.gauge(
            "observability_clock_offset_seconds",
            help="estimated offset of this rank's monotonic clock vs the "
                 "KV server's (request/response midpoint, min-RTT probe)",
        ).set(off)
        _metrics.gauge(
            "observability_clock_error_seconds",
            help="half-RTT error bound on the clock-offset estimate",
        ).set(err)
    _trace.set_clock_info(
        {
            "rank": int(rank),
            "epoch_monotonic_ns": _trace.epoch_ns(),
            "offset_s": off,
            "error_s": err,
            "generation": _generation,
        }
    )
    return off, err


def refresh_from_kv(kv, *, rank: int = 0,
                    generation: Optional[int] = None,
                    samples: int = DEFAULT_SAMPLES) -> Tuple[float, float]:
    """:func:`refresh` against a rendezvous KV server or client — anything
    exposing ``server_clock()`` (both
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer`, in-process, and
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreClient`, one HTTP round trip
    per probe, do)."""
    return refresh(
        kv.server_clock, rank=rank, generation=generation, samples=samples,
    )


def offset() -> float:
    """The stored offset (0.0 until the first :func:`refresh` — correct for
    the single-process case where local IS the reference clock)."""
    return _offset_s


def error_bound() -> Optional[float]:
    """Half-RTT bound of the stored estimate, or None before any refresh."""
    return _error_s


def info() -> dict:
    """JSON-able view (what the metrics publisher ships with each
    snapshot)."""
    with _lock:
        return {
            "offset_s": _offset_s,
            "error_s": _error_s,
            "generation": _generation,
            "age_s": (
                None if _refreshed_at is None
                else round(time.monotonic() - _refreshed_at, 3)
            ),
        }


def reset() -> None:
    """Back to the unsynchronized state (tests)."""
    global _offset_s, _error_s, _generation, _refreshed_at
    with _lock:
        _offset_s = 0.0
        _error_s = None
        _generation = 0
        _refreshed_at = None


# --------------------------------------------------------------- trace merge


def _load_events(path: str) -> list:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):  # chrome "object format" carries traceEvents
        data = data.get("traceEvents", [])
    return data if isinstance(data, list) else []


def _clock_meta(events: Iterable[dict]) -> Optional[dict]:
    """The LAST clock_sync in the file: ``trace.flush`` appends one per
    flush, so a sidecar reused across shutdown/init cycles (worker
    restart, elastic re-form) carries several — the newest describes the
    timebase of the newest events, which are the ones a fleet merge is
    after. (Events surviving from an earlier run in the same file keep
    that run's timebase and shift imperfectly — a file-wide correction
    cannot serve two epochs; start a fresh HOROVOD_TIMELINE per run when
    that matters.)"""
    meta = None
    for ev in events:
        if ev.get("name") == "clock_sync" and isinstance(
            ev.get("args"), dict
        ):
            meta = ev["args"]
    return meta


def merge_rank_traces(
    paths: Sequence[str],
    out_path: Optional[str] = None,
) -> list:
    """Merge per-rank chrome-trace files into ONE skew-corrected timeline.

    Each file's ``clock_sync`` meta event (written by :func:`refresh` →
    ``trace.flush``) supplies its rank and the mapping of its local
    timebase onto the KV server's clock: absolute server time of an event
    is ``epoch_monotonic_ns/1e9 + ts/1e6 + offset_s``. The earliest file
    origin becomes the merged ts=0; files WITHOUT clock metadata are taken
    at face value (offset 0, rank = position in `paths`) — right for the
    single-process case, increasingly wrong with real skew.

    Host-span lanes (pid ``python-host``) are renamed ``rank<r>-host`` so
    eight ranks' Python rows stay distinguishable; per-rank arrival lanes
    (pid ``rank<r>``) and everything else pass through. Events are sorted
    by corrected timestamp. When `out_path` is given the merged array is
    also written there as valid JSON. Returns the merged event list."""
    per_file = []
    origins = []
    for i, path in enumerate(paths):
        events = _load_events(path)
        meta = _clock_meta(events) or {}
        rank = int(meta.get("rank", i))
        origin_s = (
            float(meta.get("epoch_monotonic_ns", 0)) / 1e9
            + float(meta.get("offset_s", 0.0))
        )
        per_file.append((rank, origin_s, events))
        origins.append(origin_s)
    ref = min(origins) if origins else 0.0
    merged = []
    for rank, origin_s, events in per_file:
        shift_us = (origin_s - ref) * 1e6
        for ev in events:
            ev = dict(ev)
            if ev.get("name") == "clock_sync":
                continue  # consumed; would be misleading post-shift
            if "ts" in ev:
                try:
                    ev["ts"] = round(float(ev["ts"]) + shift_us, 1)
                except (TypeError, ValueError):
                    pass
            if ev.get("pid") == _trace.HOST_PID:
                ev["pid"] = f"rank{rank}-host"
            merged.append(ev)
    merged.sort(key=lambda e: (e.get("ts") or 0.0))
    if out_path:
        tmp = out_path + ".tmp"
        with open(tmp, "w") as f:
            # compact: at millions of events, indent would multiply the
            # file size for a file only Perfetto reads
            json.dump(merged, f)
        os.replace(tmp, out_path)
    return merged
