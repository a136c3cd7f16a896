"""Straggler attribution: correlate collective arrivals across ranks and
name the rank that everyone else is waiting for.

Horovod's coordinator stall-check is the reference instrument (PAPER.md L4:
the negotiation protocol means rank 0 KNOWS which ranks are late for which
tensor); this module rebuilds it for horovod_tpu_torch from the
observability side:

- every eager collective dispatch gets a **correlation key** ``(step,
  elastic generation, per-op seq)`` — ranks dispatch collectives in the
  same program order, so the key needs no negotiation to agree across
  processes (``seq`` resets at each step boundary, ``generation`` bumps on
  elastic resizes so keys never collide across epochs);
- each dispatch records an **arrival timestamp** on the KV-server timebase
  (local monotonic + :func:`horovod_tpu_torch.observability.clock.offset`) into a
  bounded ring, and mirrors it into the host trace as an event on the
  ``rank<r>`` pid lane carrying the key in its ``args`` — the merged
  timeline's per-rank rows;
- :func:`attribute` folds correlated arrival sets (2+ ranks) into
  ``collective_arrival_spread_seconds`` (histogram) + ``straggler_rank``
  (gauge) and, when ONE rank is last by ≥ ``HOROVOD_STRAGGLER_THRESHOLD``
  for ``HOROVOD_STRAGGLER_PERSIST`` consecutive correlated collectives,
  feeds :func:`horovod_tpu_torch.resilience.health.record_straggler` — the
  health machine goes SUSPECT with the rank named in its reason.

Topology note: in the single-controller SPMD case one process dispatches on
behalf of every rank, so per-rank arrivals are *simulated* — identical
timestamps, except a rank charged with ``HOROVOD_CHAOS=rank_slow=<rank>:<s>``
arrives ``<s>`` late (the process really sleeps, so step time moves too). Multi-process ranks each
record only their OWN arrival; the rank-0
:class:`~horovod_tpu_torch.observability.aggregate.FleetAggregator` unions the
rings by key before attribution.

stdlib-only at import (resilience/chaos/health are imported lazily at call
time; the caller passes world/rank identity in, so this module never
touches the data plane).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import trace as _trace
from horovod_tpu_torch.observability import clock as _clock

__all__ = [
    "set_step",
    "set_generation",
    "collective_begin",
    "last_key",
    "span_args",
    "export_recent",
    "attribute",
    "merge_arrival_exports",
    "note_data_wait",
    "data_waits",
    "reset",
    "threshold",
    "persist_after",
]

#: seconds of arrival spread below which nobody is called a straggler
THRESHOLD_ENV = "HOROVOD_STRAGGLER_THRESHOLD"
#: consecutive attributed collectives one rank must trail before the
#: health machine is fed (SUSPECT)
PERSIST_ENV = "HOROVOD_STRAGGLER_PERSIST"
#: arrival-ring capacity (recent collectives kept for aggregation)
WINDOW_ENV = "HOROVOD_STRAGGLER_WINDOW"

_lock = threading.Lock()
_step = 0
_generation = 0
_seq = 0
_last_key: Optional[Tuple[int, int, int]] = None
_window_cache: Optional[int] = None
_ring: "collections.deque" = collections.deque(maxlen=256)

# attribution state (lives on whichever process runs attribute(), rank 0).
# Its own lock: attribute() is reachable concurrently from the rank-0
# aggregation loop AND ThreadingHTTPServer /fleet handler threads — an
# unsynchronized race would double-strike health for one key.
_attr_lock = threading.Lock()
_seen_keys: "collections.OrderedDict" = collections.OrderedDict()
_streak_rank: Optional[int] = None
_streak = 0
_current: Optional[dict] = None  # latest attribution, sticky until contradicted


_threshold_cache: Optional[float] = None
_persist_cache: Optional[int] = None

# input-side attribution: the data plane notes each rank's most
# recent input-pipeline wait here; collective_begin folds it into the
# simulated arrivals (single-controller) and attribute() classifies a
# named straggler as input-bound when its wait explains the spread —
# "slow disk" vs "slow chip", today's blind spot
_data_wait: Dict[int, float] = {}


def note_data_wait(rank: int, seconds: float) -> None:
    """The input pipeline feeding `rank` made its step loop wait `seconds`
    for the latest batch (:class:`horovod_tpu_torch.data.ResumableLoader` calls
    this per consumed batch). Zero/near-zero waits overwrite older stalls,
    so a recovered pipeline stops being attributed immediately."""
    with _lock:
        _data_wait[int(rank)] = max(0.0, float(seconds))


def data_waits() -> Dict[int, float]:
    """Most recent per-rank input waits (a copy)."""
    with _lock:
        return dict(_data_wait)


def threshold() -> float:
    """Env read cached (attribution loops call this per record while
    holding the attribution lock); :func:`reset` re-reads."""
    global _threshold_cache
    if _threshold_cache is None:
        _threshold_cache = float(os.environ.get(THRESHOLD_ENV, "0.05"))
    return _threshold_cache


def persist_after() -> int:
    global _persist_cache
    if _persist_cache is None:
        _persist_cache = max(1, int(os.environ.get(PERSIST_ENV, "3")))
    return _persist_cache


def _window() -> int:
    global _window_cache
    if _window_cache is None:
        _window_cache = max(8, int(os.environ.get(WINDOW_ENV, "256")))
    return _window_cache


def set_step(step: int) -> None:
    """Open step `step`'s correlation scope (resets the per-op seq).
    ``InstrumentedStep`` calls this per dispatched train step; explicit
    loops (tests, serving drivers) call it themselves."""
    global _step, _seq
    with _lock:
        _step = int(step)
        _seq = 0


def set_generation(gen: int) -> None:
    """Record the elastic generation (the middle key component): the
    elastic driver calls this after every resize so correlation keys never
    collide across membership epochs."""
    global _generation, _seq
    with _lock:
        _generation = int(gen)
        _seq = 0


def generation() -> int:
    """The elastic generation :func:`set_generation` last recorded."""
    return _generation


def last_key() -> Optional[Tuple[int, int, int]]:
    """The key assigned by the most recent :func:`collective_begin` (what
    the dispatch site stamps onto its trace span)."""
    return _last_key


def span_args() -> dict:
    """``last_key`` spelled as chrome-trace span args ({} before any
    dispatch)."""
    k = _last_key
    if k is None:
        return {}
    return {"step": k[0], "gen": k[1], "seq": k[2]}


def _chaos_mod():
    from horovod_tpu_torch.resilience import chaos

    return chaos


def _health_mod():
    from horovod_tpu_torch.resilience import health

    return health


def collective_begin(
    op: str,
    *,
    world: int = 1,
    process_rank: int = 0,
    process_size: int = 1,
) -> Tuple[int, int, int]:
    """One eager collective is about to dispatch: assign its correlation
    key, apply any ``rank_slow`` chaos charge, and record arrivals.

    `world` is the collective's rank count (mesh data-axis size),
    `process_rank`/`process_size` the process identity — the caller
    (``ops/collective.py``) supplies them so this module stays free of the
    data plane. Returns the key."""
    global _seq, _last_key
    with _lock:
        key = (_step, _generation, _seq)
        _seq += 1
        _last_key = key
    chaos = _chaos_mod()
    slow: Optional[Tuple[int, float]] = None
    if chaos.enabled():
        slow = chaos.rank_slow()
    # _data_wait is consumed ONLY by the single-controller simulated
    # arrivals below — multi-process ranks record their real (already
    # delayed) dispatch time, and their loaders note waits every batch,
    # so probing here would permanently defeat the hot-path early
    # return. The unlocked truthiness probe keeps the common case (no
    # loader, or no stall) at one lock acquisition.
    waits: Dict[int, float] = {}
    if process_size == 1 and _data_wait:
        with _lock:
            waits = {r: w for r, w in _data_wait.items() if w > 0}
    if slow is None and not waits and not (
            _metrics.enabled() or _trace.enabled()):
        # nothing can consume an arrival record (no aggregation plane, no
        # trace) and no chaos charge to apply: keep only the seq
        # discipline — ranks must agree on keys even when one has
        # observability off — and stay off the eager hot path
        return key
    # timestamps are stored RAW-LOCAL (time.monotonic); the server-clock
    # offset is applied at export time (export_recent), so records
    # captured before the first clock sync are corrected retroactively
    # rather than baking a 0 offset in forever
    now_local = time.monotonic()
    if process_size > 1:
        # each process knows only its own arrival; the aggregator unions
        if slow is not None and slow[0] == process_rank and slow[1] > 0:
            chaos.record_injection("rank_slow")
            time.sleep(slow[1])
            now_local = time.monotonic()
        record = {"key": key, "op": op,
                  "arrivals": {process_rank: now_local}}
    else:
        # single-controller SPMD: one host dispatches for every rank.
        # Simulated arrivals are identical but for the chaos charge, so
        # the record is COMPACT — base time + late exceptions — instead
        # of an O(world) dict per dispatch (expanded only at
        # attribution/merge time)
        late = {}
        # input-side lateness: a rank whose latest batch made it wait is
        # marked that much late at the collective — NO extra sleep (the
        # loader's wall time already passed); the simulated arrival just
        # reflects where it went. Real multi-process ranks need none of
        # this: their loader's sleep delays their real dispatch.
        for r, w in waits.items():
            if 0 <= r < max(1, world):
                late[r] = now_local + w
        if slow is not None and 0 <= slow[0] < max(1, world) and slow[1] > 0:
            chaos.record_injection("rank_slow")
            time.sleep(slow[1])
            late[slow[0]] = time.monotonic()
        record = {"key": key, "op": op, "base": now_local,
                  "late": late, "world": max(1, world)}
    with _lock:
        if _ring.maxlen != _window():
            _resize_ring_locked()
        _ring.append(record)
    _emit_arrival_events(op, key, _expand_arrivals(record))
    return key


def _expand_arrivals(record: dict) -> Dict[int, float]:
    """Per-rank arrival map of a ring record (compact single-controller
    records expand to world entries; multi-process records pass
    through)."""
    if "arrivals" in record:
        return dict(record["arrivals"])
    out = {r: record["base"] for r in range(record["world"])}
    out.update(record["late"])
    return out


def _resize_ring_locked() -> None:
    global _ring
    _ring = collections.deque(_ring, maxlen=_window())


#: above this world size, simulated per-rank trace rows collapse to one
#: shared lane + the late ranks (256 identical rows per collective would
#: churn the span ring and be unreadable in Perfetto anyway)
MAX_TRACE_RANK_LANES = 64


def _emit_arrival_events(op: str, key, arrivals: Dict[int, float]) -> None:
    """Mirror the arrivals into the host trace as per-rank rows. Each
    rank's bar runs from its arrival to the LAST arrival — the time it
    (would have) spent waiting for the straggler — so the merged timeline
    shows one collective as an aligned row per rank. Timestamps are
    raw-local (the merge tool applies the clock correction file-wide)."""
    if not _trace.enabled():
        return
    t_last = max(arrivals.values())
    if len(arrivals) > MAX_TRACE_RANK_LANES:
        base_t = min(arrivals.values())
        distinct = {r: t for r, t in arrivals.items() if t != base_t}
        arrivals = dict(distinct)
        arrivals[-1] = base_t  # lane "rank-1": the on-time cohort
    for r, t in arrivals.items():
        ts = _trace.rel_us(t)
        _trace.add_raw(
            {
                "ph": "X",
                "pid": f"{_trace.RANK_PID_PREFIX}{r}",
                "tid": op,
                "name": f"{op} s{key[0]}.{key[2]}",
                "ts": round(ts, 1),
                "dur": round(max(0.0, (t_last - t)) * 1e6, 1),
                "args": {
                    "step": key[0], "gen": key[1], "seq": key[2],
                    "op": op, "rank": r,
                },
            }
        )


def export_recent(n: Optional[int] = None) -> List[dict]:
    """JSON-able copy of the arrival ring (newest last) — what
    :class:`~horovod_tpu_torch.observability.aggregate.MetricsPublisher` ships in
    each snapshot. Keys become lists, ranks become strings (JSON object
    keys), and the CURRENT clock offset is applied here — export time, not
    capture time — so arrivals recorded before the first clock sync are
    corrected retroactively. Compact single-controller records stay
    compact on the wire (base + late exceptions, not world entries)."""
    with _lock:
        records = list(_ring)
    if n is not None:
        records = records[-n:]
    off = _clock.offset()
    out = []
    for rec in records:
        e = {"key": list(rec["key"]), "op": rec["op"]}
        if "arrivals" in rec:
            e["arrivals"] = {
                str(r): t + off for r, t in rec["arrivals"].items()
            }
        else:
            e["base"] = rec["base"] + off
            e["late"] = {str(r): t + off for r, t in rec["late"].items()}
            e["world"] = rec["world"]
        out.append(e)
    return out


def merge_arrival_exports(exports: Iterable[List[dict]]) -> List[dict]:
    """Union per-rank arrival exports by correlation key (the fleet-side
    correlation step): records with the same ``(step, gen, seq)`` from
    different ranks' snapshots fold into one arrival map."""
    merged: Dict[Tuple[int, int, int], dict] = {}
    for export in exports:
        for rec in export or ():
            try:
                key = tuple(int(k) for k in rec["key"])
                if "arrivals" in rec:
                    norm = {"arrivals": {
                        int(r): float(t)
                        for r, t in rec["arrivals"].items()
                    }}
                else:  # compact single-controller record
                    norm = {
                        "base": float(rec["base"]),
                        "world": int(rec["world"]),
                        "late": {
                            int(r): float(t)
                            for r, t in rec["late"].items()
                        },
                    }
                arrivals = _expand_arrivals(norm)
            except (KeyError, TypeError, ValueError):
                continue
            slot = merged.setdefault(
                key, {"key": key, "op": rec.get("op", "?"), "arrivals": {}}
            )
            slot["arrivals"].update(arrivals)
    return [merged[k] for k in sorted(merged)]


def attribute(
    records: Optional[Iterable[dict]] = None,
    *,
    expected_ranks: Optional[int] = None,
    data_waits: Optional[Dict[int, float]] = None,
) -> Optional[dict]:
    """Fold correlated arrival records into straggler metrics + the health
    feed; returns the current attribution or None. Lock-safe — the rank-0
    aggregation loop and the ``/fleet`` HTTP handler threads can race a
    call without double-striking health for one key.

    `records` defaults to this process's own ring (the single-controller
    case); the fleet aggregator passes :func:`merge_arrival_exports`
    output with `expected_ranks` = the live-rank count. A key is only
    FINALIZED (attributed + remembered, so repeated passes never
    double-count) once its arrival set reaches `expected_ranks` (default:
    2, the single-controller case where arrivals are complete at birth):
    a partial set — one rank's snapshot lagging, most likely the
    straggler's own — is deferred to a later pass instead of being scored
    without its decisive arrival. Each finalized key observes
    ``collective_arrival_spread_seconds``; when the spread clears
    ``HOROVOD_STRAGGLER_THRESHOLD`` the last rank is the collective's
    straggler (``straggler_rank`` gauge, ``straggler_collectives``
    counter) and from ``HOROVOD_STRAGGLER_PERSIST`` consecutive
    attributions of the SAME rank onward, EVERY further attribution
    strikes the health machine (SUSPECT). Re-striking per collective —
    the same cadence as stall warnings — matters in a live loop:
    completed steps beat the machine back to HEALTHY, so a one-shot
    strike would make a persistent-but-progressing straggler invisible
    after one step.

    The returned attribution is STICKY: a pass that sees no new records
    (an HTTP ``/fleet`` scrape between publishes) reports the latest one
    instead of flickering to None; a new under-threshold collective — the
    straggler caught up — clears it.

    `data_waits` (``{rank: recent input wait seconds}``; default: this
    process's own :func:`note_data_wait` map, the single-controller case —
    the fleet aggregator passes per-rank waits it pulled from the merged
    snapshots) classifies a named straggler's **cause**: when the rank's
    input wait explains the arrival spread it is ``"input"``-bound (slow
    disk), otherwise ``"compute"``-bound (slow chip) — the distinction the
    health reason surface."""
    if records is None:
        with _lock:
            raw = list(_ring)
        records = [
            dict(rec, arrivals=_expand_arrivals(rec)) for rec in raw
        ]
    if data_waits is None:
        with _lock:
            data_waits = dict(_data_wait)
    with _attr_lock:
        return _attribute_locked(records, expected_ranks, data_waits)


def _temporal(key: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Keys in wall-clock order: the elastic generation outranks the step
    (a resize rolls the step back while time moves forward)."""
    return (key[1], key[0], key[2])


def _attribute_locked(records, expected_ranks: Optional[int],
                      data_waits: Optional[Dict[int, float]] = None):
    global _streak_rank, _streak, _current
    need = max(2, expected_ranks or 2)
    current: Optional[dict] = None
    # process in TEMPORAL order (generation outranks step): merged records
    # arrive key-sorted, which puts post-resize (higher-gen, step-rolled-
    # back) keys BEFORE leftover pre-resize ones — an old healthy key
    # processed last would wipe the attribution the newer keys just built
    records = sorted(records, key=lambda r: _temporal(tuple(r["key"])))
    for rec in records:
        key = tuple(rec["key"])
        arrivals = rec["arrivals"]
        if len(arrivals) < need or key in _seen_keys:
            continue
        _seen_keys[key] = True
        while len(_seen_keys) > 4 * _window():
            _seen_keys.popitem(last=False)
        ts = sorted(arrivals.items(), key=lambda kv: kv[1])
        spread = ts[-1][1] - ts[0][1]
        if _metrics.enabled():
            _metrics.histogram(
                "collective_arrival_spread_seconds",
                help="latest minus earliest rank arrival per correlated "
                     "collective",
            ).observe(spread)
        if spread >= threshold():
            rank = int(ts[-1][0])
            # input-vs-compute attribution: the rank's recent input wait
            # explains the spread when it covers at least half of it (and
            # clears the threshold itself) — then the disk, not the chip,
            # is the bottleneck
            wait = float((data_waits or {}).get(rank, 0.0))
            cause = (
                "input"
                if wait >= max(threshold(), 0.5 * spread)
                else "compute"
            )
            current = {
                "rank": rank,
                "spread_seconds": spread,
                "key": list(key),
                "op": rec.get("op", "?"),
                "cause": cause,
            }
            if _metrics.enabled():
                _metrics.gauge(
                    "straggler_rank",
                    help="rank last to arrive at the most recent "
                         "over-threshold collective (-1: none)",
                ).set(rank)
                _metrics.counter(
                    "straggler_collectives",
                    help="correlated collectives attributed to a straggler",
                    rank=rank,
                ).inc()
            if rank == _streak_rank:
                _streak += 1
            else:
                _streak_rank, _streak = rank, 1
            if _streak >= persist_after():
                _health_mod().record_straggler(rank, spread, cause=cause)
        else:
            if _current is not None and _temporal(key) < _temporal(
                tuple(_current["key"])
            ):
                # an OLDER deferred key finalizing late (its last arrival
                # just landed) says nothing about the straggler every
                # NEWER collective is still naming — don't let it clear
                # the streak/attribution out of order
                continue
            _streak_rank, _streak = None, 0
            current = None
            _current = None
            if _metrics.enabled():
                _metrics.gauge(
                    "straggler_rank",
                    help="rank last to arrive at the most recent "
                         "over-threshold collective (-1: none)",
                ).set(-1)
    if current is not None:
        current["streak"] = _streak
        _current = current
    return _current


def reset() -> None:
    """Forget correlation + attribution state (tests / per-run
    isolation)."""
    global _step, _generation, _seq, _last_key, _window_cache
    global _threshold_cache, _persist_cache
    global _streak_rank, _streak, _current
    _threshold_cache = None
    _persist_cache = None
    with _lock:
        _step = 0
        _generation = 0
        _seq = 0
        _last_key = None
        _window_cache = None
        _ring.clear()
        _data_wait.clear()
    with _attr_lock:
        _seen_keys.clear()
        _streak_rank, _streak, _current = None, 0, None
