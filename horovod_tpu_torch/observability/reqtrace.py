"""Per-request span lifecycle for the serving engine.

The serving stack's request-level observability: every request the
continuous-batching engine touches is followed queue → admission →
chunked prefill → first token → per-token decode → completion (or
rejection, or canary relabel), and each transition lands in three places
at once:

- **Chrome-trace lanes** — the existing ``HOROVOD_TIMELINE`` host ring
  gains one ``req:<rid>`` pid lane per request, with a ``queue_wait``
  span, an ``admit`` instant (slot + reserved pages), one span per
  prefill chunk iteration, a ``first_token`` instant (TTFT), one span
  per decoded token (TPOT cadence), and a whole-request span at
  completion.
- **Flight-recorder events** —``req_begin`` / ``req_end`` /
  ``req_relabel`` events on the ``serve`` kind carry the SAME request
  id, so the offline analysis can group a dead job's sidecars per
  request and say which in-flight requests a hang stranded.
- **Histograms** — TTFT / TPOT / queue-wait / e2e land in
  ``reqtrace_*_seconds`` families labeled ``{arm,outcome,generation}``,
  subsuming the scheduler's old hand-rolled
  ``serving_request_latency_seconds`` observation (kept as an alias so
  dashboards survive).

The same completions feed **bounded per-arm windows** (seqno-tagged, so
readers take a mark and ask "what completed since") that
:class:`~horovod_tpu_torch.serving.rollout.GenerationRollout` reads for its
canary gate and :mod:`~horovod_tpu_torch.observability.slo` evaluates
objectives against — one observation path instead of the double-booked
rollout-window / scheduler-histogram pair this replaces.

``HOROVOD_REQTRACE=0`` disables the trace/flight/histogram *emission*;
the windowed accounting always runs (the rollout gate and SLO evaluator
depend on it and it is a few deque appends per request).
``HOROVOD_REQTRACE_WINDOW`` bounds the per-arm windows (default 256
completions).

For the fleet tier, requests carry an
optional ``replica`` label (stamped on flight events and trace args so
a multi-replica flight record attributes each span to the engine that
served it), completions fan out to registered *observers*
(:func:`add_completion_observer` — the fleet router builds its
per-replica gate windows this way instead of double-booking the
accounting), and :func:`recent_tpot` exposes the windowed decode-gap
median for deterministic backpressure hints. A completion whose error
starts with ``"cancelled"`` (a hedge loser withdrawn by the router) is
excluded from the arm windows and the error-rate SLO — it was never a
served outcome.

stdlib-only, like the rest of the observability package. Hooks are
called by :mod:`horovod_tpu_torch.serving.scheduler` /
:mod:`horovod_tpu_torch.serving.engine` outside their locks; all module state
here is guarded by one lock.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from horovod_tpu_torch.observability import flight as _flight
from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.observability import slo as _slo
from horovod_tpu_torch.observability import trace as _trace

logger = logging.getLogger(__name__)

__all__ = [
    "REQTRACE_ENV",
    "WINDOW_ENV",
    "enabled",
    "window_size",
    "reset",
    "on_enqueue",
    "on_reject",
    "on_admit",
    "on_prefill_chunk",
    "on_prefix_hit",
    "on_spec_verify",
    "on_first_token",
    "on_token",
    "on_finish",
    "on_relabel",
    "arm_mark",
    "arm_window",
    "quantile",
    "live_requests",
    "add_completion_observer",
    "remove_completion_observer",
    "recent_tpot",
]

REQTRACE_ENV = "HOROVOD_REQTRACE"
WINDOW_ENV = "HOROVOD_REQTRACE_WINDOW"

_lock = threading.Lock()
_enabled_cache: Optional[bool] = None
_window_cache: Optional[int] = None


class _Rec:
    """Live state for one in-flight request (keyed by ``id(req)`` — rids
    are caller-chosen and need not be unique across retries)."""

    __slots__ = ("rid", "arm", "replica", "t_enqueue", "t_admit",
                 "t_first", "t_last", "generation", "tokens",
                 "tpot_sum", "cached_tokens", "spec_proposed",
                 "spec_accepted")

    def __init__(self, rid, arm: str, t_enqueue: float,
                 replica: str = ""):
        self.rid = rid
        self.arm = arm
        self.replica = replica
        self.t_enqueue = t_enqueue
        self.t_admit: Optional[float] = None
        self.t_first: Optional[float] = None
        self.t_last: Optional[float] = None
        self.generation: int = -1
        self.tokens = 0
        self.tpot_sum = 0.0
        #: prompt tokens aliased from the prefix cache (skipped prefill
        #: — the TTFT attribution for a cache hit)
        self.cached_tokens = 0
        #: draft tokens proposed / accepted for this request (the TPOT
        #: attribution for speculative decode)
        self.spec_proposed = 0
        self.spec_accepted = 0


class _ArmSeries:
    """Bounded completion window for one user-facing arm. Entries are
    seqno-tagged so concurrent readers (rollout gate, SLO evaluator,
    p50/p99 gauges) can each keep their own mark."""

    __slots__ = ("seq", "done", "tpot")

    def __init__(self, window: int):
        self.seq = 0
        # (seqno, generation, error, e2e, ttft, tpot_mean)
        self.done: deque = deque(maxlen=window)
        # token-level inter-token gaps, for the p50/p99 gauges
        self.tpot: deque = deque(maxlen=window)


_live: Dict[int, _Rec] = {}
_arms: Dict[str, _ArmSeries] = {}
# completion observers (fleet router): fn(req, summary_dict), called
# outside the module lock on every on_finish
_observers: List = []


def _replica_of(req) -> str:
    return str(getattr(req, "replica", "") or "")


def add_completion_observer(fn) -> None:
    """Register `fn(req, summary)` to run on every completion.
    `summary` carries rid / replica / arm / generation / error /
    cancelled / e2e / ttft / tpot_mean; `req` is the scheduler-level
    request object (identity lets the fleet router match its own
    copies). Observers run outside the reqtrace lock; exceptions are
    swallowed so a broken observer cannot wedge the engine."""
    with _lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_completion_observer(fn) -> None:
    """Unregister a completion observer (no-op when unknown)."""
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def enabled() -> bool:
    """Emission switch (``HOROVOD_REQTRACE``, default on). Gates the
    trace-lane / flight-event / histogram output, NOT the windowed
    accounting."""
    global _enabled_cache
    with _lock:
        if _enabled_cache is None:
            _enabled_cache = os.environ.get(REQTRACE_ENV, "1") != "0"
        return _enabled_cache


def window_size() -> int:
    """Per-arm completion-window bound (``HOROVOD_REQTRACE_WINDOW``)."""
    global _window_cache
    with _lock:
        if _window_cache is None:
            _window_cache = max(
                1, int(os.environ.get(WINDOW_ENV, "256")))
        return _window_cache


def reset() -> None:
    """Drop live records, windows, and cached env (tests)."""
    global _enabled_cache, _window_cache
    with _lock:
        _live.clear()
        _arms.clear()
        _observers.clear()
        _enabled_cache = None
        _window_cache = None


def _series(arm: str) -> _ArmSeries:
    # caller holds _lock
    s = _arms.get(arm)
    if s is None:
        s = _ArmSeries(window_size_unlocked())
        _arms[arm] = s
    return s


def window_size_unlocked() -> int:
    global _window_cache
    if _window_cache is None:
        _window_cache = max(1, int(os.environ.get(WINDOW_ENV, "256")))
    return _window_cache


def quantile(values: List[float], q: float) -> Optional[float]:
    """Deterministic nearest-rank quantile (no interpolation — two
    processes computing p99 over the same window agree bit-for-bit)."""
    if not values:
        return None
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, math.ceil(q * len(vs)) - 1))
    return vs[idx]


def live_requests() -> List[dict]:
    """Snapshot of in-flight request records (diagnostics / tests)."""
    with _lock:
        return [
            {"rid": r.rid, "arm": r.arm, "tokens": r.tokens,
             "admitted": r.t_admit is not None}
            for r in _live.values()
        ]


# ------------------------------------------------------------ lifecycle


def on_enqueue(req) -> None:
    """A request entered the queue (scheduler accepted it)."""
    replica = _replica_of(req)
    rec = _Rec(req.rid, req.arm, req.submitted_at, replica)
    with _lock:
        _live[id(req)] = rec
    if not enabled():
        return
    _flight.record("serve", what="req_begin", rid=str(req.rid),
                   arm=req.arm,
                   **({"replica": replica} if replica else {}))
    if _trace.enabled():
        _trace.add_raw({
            "ph": "i", "s": "t", "pid": f"req:{req.rid}",
            "tid": "lifecycle", "name": "enqueue",
            "ts": round(_trace.rel_us(req.submitted_at), 1),
            "args": {"arm": req.arm,
                     **({"replica": replica} if replica else {})},
        })


def on_reject(req, reason: str) -> None:
    """Admission control refused the request (queue full / too long)."""
    with _lock:
        _live.pop(id(req), None)
    now = time.monotonic()
    lat = now - req.submitted_at
    if _metrics.enabled():
        _metrics.histogram(
            "reqtrace_e2e_seconds",
            help="submit-to-finish wall time per request "
                 "(queue wait included)",
            arm=req.arm, outcome="rejected", generation="-1",
        ).observe(lat)
    _slo.observe("error_rate", 1.0)
    if not enabled():
        return
    replica = _replica_of(req)
    _flight.record("serve", what="req_end", rid=str(req.rid),
                   arm=req.arm, outcome="rejected", reason=reason,
                   **({"replica": replica} if replica else {}))
    if _trace.enabled():
        _trace.add_raw({
            "ph": "X", "pid": f"req:{req.rid}", "tid": "lifecycle",
            "name": "rejected",
            "ts": round(_trace.rel_us(req.submitted_at), 1),
            "dur": round(lat * 1e6, 1),
            "args": {"arm": req.arm, "reason": reason},
        })


def on_admit(seq) -> None:
    """A queued request took a batch slot + full page reservation."""
    req = seq.req
    now = time.monotonic()
    with _lock:
        rec = _live.get(id(req))
        if rec is None:
            rec = _Rec(req.rid, req.arm, req.submitted_at)
            _live[id(req)] = rec
        rec.t_admit = now
        rec.arm = req.arm
    wait = now - req.submitted_at
    if _metrics.enabled():
        _metrics.histogram(
            "reqtrace_queue_wait_seconds",
            help="enqueue-to-admission wait per request",
            arm=req.arm,
        ).observe(wait)
    _slo.observe("queue_wait", wait)
    if not enabled() or not _trace.enabled():
        return
    pid = f"req:{req.rid}"
    _trace.add_raw({
        "ph": "X", "pid": pid, "tid": "lifecycle", "name": "queue_wait",
        "ts": round(_trace.rel_us(req.submitted_at), 1),
        "dur": round(wait * 1e6, 1),
        "args": {"arm": req.arm},
    })
    _trace.add_raw({
        "ph": "i", "s": "t", "pid": pid, "tid": "lifecycle",
        "name": "admit", "ts": round(_trace.rel_us(now), 1),
        "args": {"slot": seq.slot, "pages": len(seq.pages),
                 "arm": seq.arm},
    })


def on_prefill_chunk(seq, ntokens: int, t0: float,
                     generation: int) -> None:
    """One chunked-prefill iteration wrote `ntokens` of this sequence's
    prompt (``t0`` = pass start, ``time.monotonic()``)."""
    req = seq.req
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            rec.generation = int(generation)
    if not enabled() or not _trace.enabled():
        return
    _trace.add_raw({
        "ph": "X", "pid": f"req:{req.rid}", "tid": "engine",
        "name": f"prefill[{ntokens}]",
        "ts": round(_trace.rel_us(t0), 1),
        "dur": round((time.monotonic() - t0) * 1e6, 1),
        "args": {"arm": seq.arm, "generation": int(generation)},
    })


def on_prefix_hit(seq, ntokens: int) -> None:
    """Admission aliased `ntokens` cached prompt tokens for this
    request — those prefill chunks are skipped entirely, which is the
    TTFT story a cache hit tells on the trace lane."""
    req = seq.req
    now = time.monotonic()
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            rec.cached_tokens = int(ntokens)
    if not enabled() or not _trace.enabled():
        return
    _trace.add_raw({
        "ph": "i", "s": "t", "pid": f"req:{req.rid}", "tid": "engine",
        "name": "prefix_hit", "ts": round(_trace.rel_us(now), 1),
        "args": {"cached_tokens": int(ntokens), "arm": seq.arm},
    })


def on_spec_verify(seq, proposed: int, accepted: int,
                   generation: int) -> None:
    """One speculative iteration verified for this request: `proposed`
    draft tokens, `accepted` of them kept (plus the bonus token the
    verify forward emits regardless). The per-iteration TPOT gaps the
    :func:`on_token` cadence records around this event are the
    speculative attribution: one verify wall-clock amortized over
    ``accepted + 1`` tokens."""
    req = seq.req
    now = time.monotonic()
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            rec.spec_proposed += int(proposed)
            rec.spec_accepted += int(accepted)
            rec.generation = int(generation)
    if not enabled() or not _trace.enabled():
        return
    _trace.add_raw({
        "ph": "i", "s": "t", "pid": f"req:{req.rid}", "tid": "engine",
        "name": "spec_verify", "ts": round(_trace.rel_us(now), 1),
        "args": {"proposed": int(proposed), "accepted": int(accepted),
                 "arm": seq.arm, "generation": int(generation)},
    })


def on_first_token(seq, generation: int) -> None:
    """The request's first token sampled — TTFT closes here."""
    req = seq.req
    now = time.monotonic()
    ttft = now - req.submitted_at
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            rec.t_first = now
            rec.t_last = now
            rec.tokens = 1
            rec.generation = int(generation)
    if _metrics.enabled():
        _metrics.histogram(
            "reqtrace_ttft_seconds",
            help="submit-to-first-token wall time per request (TTFT)",
            arm=req.arm, generation=str(int(generation)),
        ).observe(ttft)
    _slo.observe("ttft", ttft)
    if not enabled() or not _trace.enabled():
        return
    _trace.add_raw({
        "ph": "i", "s": "t", "pid": f"req:{req.rid}", "tid": "engine",
        "name": "first_token", "ts": round(_trace.rel_us(now), 1),
        "args": {"ttft_ms": round(ttft * 1e3, 3), "arm": seq.arm,
                 "generation": int(generation)},
    })


def on_token(seq, generation: int) -> None:
    """One decode token sampled — the TPOT cadence."""
    req = seq.req
    now = time.monotonic()
    gap = None
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            if rec.t_last is not None:
                gap = now - rec.t_last
                rec.tpot_sum += gap
            rec.t_last = now
            rec.tokens += 1
            rec.generation = int(generation)
            if gap is not None:
                _series(req.arm).tpot.append(gap)
    if gap is None:
        return
    if _metrics.enabled():
        _metrics.histogram(
            "reqtrace_tpot_seconds",
            help="inter-token decode gap per generated token (TPOT)",
            arm=req.arm, generation=str(int(generation)),
        ).observe(gap)
    _slo.observe("tpot", gap)
    if not enabled() or not _trace.enabled():
        return
    _trace.add_raw({
        "ph": "X", "pid": f"req:{req.rid}", "tid": "engine",
        "name": "decode_token",
        "ts": round(_trace.rel_us(now - gap), 1),
        "dur": round(gap * 1e6, 1),
        "args": {"arm": seq.arm},
    })


def on_finish(seq, *, error: Optional[str] = None) -> None:
    """A sequence retired at an iteration boundary — the one completion
    observation path (the scheduler's old
    ``serving_request_latency_seconds`` lives on as an alias of the e2e
    series recorded here)."""
    req = seq.req
    cancelled = bool(error) and str(error).startswith("cancelled")
    outcome = "cancelled" if cancelled \
        else ("error" if error else "ok")
    lat = req.latency_seconds()
    with _lock:
        rec = _live.pop(id(req), None)
        generation = rec.generation if rec is not None else -1
        ttft = (rec.t_first - rec.t_enqueue) \
            if rec is not None and rec.t_first is not None else None
        tpot_mean = None
        if rec is not None and rec.tokens > 1:
            tpot_mean = rec.tpot_sum / (rec.tokens - 1)
        s = _series(req.arm)
        s.seq += 1
        if lat is not None and not cancelled:
            s.done.append((s.seq, generation, bool(error), lat, ttft,
                           tpot_mean))
        ttft_vals = [e[4] for e in s.done if e[4] is not None]
        tpot_vals = list(s.tpot)
        observers = list(_observers)
    if observers:
        summary = {
            "rid": req.rid,
            "replica": rec.replica if rec is not None
            else _replica_of(req),
            "arm": req.arm, "generation": generation,
            "error": error, "cancelled": cancelled,
            "e2e": lat, "ttft": ttft, "tpot_mean": tpot_mean,
            # hot-path attribution: how much of this request's latency
            # the cache/speculation machinery explains
            "cached_tokens": rec.cached_tokens if rec is not None else 0,
            "spec_proposed": rec.spec_proposed if rec is not None else 0,
            "spec_accepted": rec.spec_accepted if rec is not None else 0,
        }
        for fn in observers:
            try:
                fn(req, summary)
            except Exception as e:  # noqa: BLE001 - observers best-effort
                logger.debug("completion observer %r failed: %s", fn, e)
    if _metrics.enabled() and lat is not None:
        _metrics.histogram(
            "reqtrace_e2e_seconds",
            help="submit-to-finish wall time per request "
                 "(queue wait included)",
            arm=req.arm, outcome=outcome,
            generation=str(int(generation)),
        ).observe(lat)
        # alias: the pre-reqtrace scheduler observation, kept so
        # existing dashboards / the A-B bench keep reading
        _metrics.histogram(
            "serving_request_latency_seconds",
            help="submit-to-finish wall time per request",
            arm=req.arm,
        ).observe(lat)
        for q, qname in ((0.5, "p50"), (0.99, "p99")):
            tv = quantile(ttft_vals, q)
            if tv is not None:
                _metrics.gauge(
                    f"reqtrace_ttft_{qname}",
                    help="windowed TTFT quantile per arm (seconds)",
                    arm=req.arm,
                ).set(tv)
            pv = quantile(tpot_vals, q)
            if pv is not None:
                _metrics.gauge(
                    f"reqtrace_tpot_{qname}",
                    help="windowed TPOT quantile per arm (seconds)",
                    arm=req.arm,
                ).set(pv)
    if lat is not None and not cancelled:
        _slo.observe("e2e", lat)
    if not cancelled:
        _slo.observe("error_rate", 1.0 if error else 0.0)
    if not enabled():
        return
    replica = rec.replica if rec is not None else _replica_of(req)
    _flight.record("serve", what="req_end", rid=str(req.rid),
                   arm=req.arm, outcome=outcome,
                   **({"replica": replica} if replica else {}))
    if _trace.enabled() and lat is not None:
        _trace.add_raw({
            "ph": "X", "pid": f"req:{req.rid}", "tid": "lifecycle",
            "name": f"request:{outcome}",
            "ts": round(_trace.rel_us(req.submitted_at), 1),
            "dur": round(lat * 1e6, 1),
            "args": {"arm": req.arm, "generation": int(generation),
                     "tokens": rec.tokens if rec is not None else 0,
                     **({"error": error} if error else {})},
        })


def on_relabel(req, src: str, dst: str) -> None:
    """A queued request moved arms (rollback re-route / promotion)."""
    with _lock:
        rec = _live.get(id(req))
        if rec is not None:
            rec.arm = dst
    if not enabled():
        return
    _flight.record("serve", what="req_relabel", rid=str(req.rid),
                   src=src, dst=dst)
    if _trace.enabled():
        _trace.add_raw({
            "ph": "i", "s": "t", "pid": f"req:{req.rid}",
            "tid": "lifecycle", "name": f"relabel:{src}->{dst}",
            "ts": round(_trace.rel_us(time.monotonic()), 1),
            "args": {"src": src, "dst": dst},
        })


# -------------------------------------------------------------- readers


def arm_mark(arm: str) -> int:
    """Current completion seqno for `arm` — take one, then ask
    :func:`arm_window` what completed *since* (the rollout gate's
    fresh-window idiom, replacing its hand-rolled accumulator)."""
    with _lock:
        s = _arms.get(arm)
        return 0 if s is None else s.seq


def arm_window(arm: str, since: int = 0,
               generation: Optional[int] = None) -> Dict[str, object]:
    """Completions on `arm` with seqno > `since` (and, when `generation`
    is given, decoded under exactly that weight generation — a leftover
    from a rolled-back canary never pollutes a later gate window)."""
    with _lock:
        s = _arms.get(arm)
        entries = [] if s is None else [
            e for e in s.done
            if e[0] > since and (generation is None
                                 or e[1] == int(generation))
        ]
    ttft = [e[4] for e in entries if e[4] is not None]
    tpot = [e[5] for e in entries if e[5] is not None]
    e2e = [e[3] for e in entries]
    return {
        "done": len(entries),
        "errors": sum(1 for e in entries if e[2]),
        "latency_sum": float(sum(e2e)),
        "e2e": e2e,
        "ttft": ttft,
        "tpot": tpot,
    }


def recent_tpot(default: Optional[float] = None) -> Optional[float]:
    """Windowed median inter-token decode gap across every arm, or
    `default` when nothing has decoded yet. Nearest-rank over bounded
    deques, so the backpressure hint derived from it
    (:meth:`~horovod_tpu_torch.serving.scheduler.Scheduler.backpressure_hint`)
    is deterministic for a given completion history."""
    with _lock:
        vals = [g for s in _arms.values() for g in s.tpot]
    if not vals:
        return default
    return quantile(vals, 0.5)
