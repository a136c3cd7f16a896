"""Host-side chrome-trace span recorder — the Python half of the merged
timeline.

The native core (``csrc/``) already writes a chrome://tracing JSON array of
negotiation/launch phases to ``HOROVOD_TIMELINE`` (rank 0, reference
``common/timeline.{h,cc}``). What that file cannot show is where the
*Python* layer spends time: enqueue calls into the core, the execute
callback receiving a fused plan, eager collective dispatch. This module
records those as chrome-trace events and, at shutdown, merges them into the
SAME file the core wrote — one Perfetto load then shows controller + host
activity on a shared monotonic timebase (``set_epoch`` is called right
before ``hvd_core_init`` so both sides' ``ts=0`` coincide to within
microseconds; ``steady_clock`` and ``time.monotonic`` read the same Linux
clock). Load the ``torch.profiler`` device trace from
:func:`horovod_tpu_torch.profiler.timeline` alongside it for device activity.

Fleet tracing: collective spans carry a ``(step, generation,
seq)`` correlation key in their ``args`` (stamped by
:mod:`~horovod_tpu_torch.observability.straggler`), every rank records — ranks
!= 0 flush to a ``<path>.rank<r>.json`` sidecar — and
:func:`horovod_tpu_torch.observability.clock.merge_rank_traces` merges the
per-rank files into one skew-corrected timeline where one collective's
spans align as a row per rank. The span buffer is a capped ring
(``HOROVOD_TRACE_MAX_SPANS``): when full the OLDEST events are dropped (a
long soak keeps its most recent window) and the ``trace_spans_dropped``
counter records the loss.

stdlib only; recording is enabled iff ``HOROVOD_TIMELINE`` is set (and
``HOROVOD_TRACE_HOST`` is not 0) — the per-call cost when disabled is one
env-cached bool check returning a shared no-op context manager.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Optional

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "enabled",
    "set_epoch",
    "set_recording",
    "set_clock_info",
    "span",
    "instant",
    "add_raw",
    "rel_us",
    "epoch_ns",
    "flush",
    "reset",
    "events",
    "max_spans",
]

_lock = threading.Lock()
_events: "collections.deque" = collections.deque()
_epoch_ns: Optional[int] = None
_enabled_cache: Optional[bool] = None
_recording = True  # False on ranks whose buffer would never be flushed
_dropped = 0
_max_spans_cache: Optional[int] = None
_clock_info: Optional[dict] = None  # rank/offset metadata for merge tools

#: default span-ring capacity — generous (a multi-hour soak's worth of
#: eager dispatches) while still bounding host RAM; override with
#: ``HOROVOD_TRACE_MAX_SPANS``
DEFAULT_MAX_SPANS = 2_000_000

#: chrome-trace ``pid`` lane for host events. The native writer uses the
#: integer rank as its pid; a distinct string keeps the two process rows
#: separate in Perfetto while living in one file.
HOST_PID = "python-host"

#: ``pid`` lane prefix for per-rank correlated collective events (the
#: fleet-view rows): rank r's arrivals land on ``rank<r>``
RANK_PID_PREFIX = "rank"


def enabled() -> bool:
    """True iff host tracing is on: ``HOROVOD_TIMELINE`` set,
    ``HOROVOD_TRACE_HOST`` not 0, and this process's buffer will actually
    be flushed (see :func:`set_recording`). The env half is cached after
    the first read (both knobs are fixed at job start, like the
    reference's Timeline)."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = bool(os.environ.get("HOROVOD_TIMELINE")) and (
            os.environ.get("HOROVOD_TRACE_HOST", "1").lower()
            not in ("0", "false")
        )
    return _recording and _enabled_cache


def set_recording(on: bool) -> None:
    """Turn span recording on/off for this process. With fleet tracing
    every rank records (its buffer flushes to a per-rank sidecar at
    shutdown); ``HOROVOD_TRACE_ALL_RANKS=0`` restores the PR-1
    coordinator-only behavior where ``horovod_tpu_torch.init`` disables
    recording on ranks != 0."""
    global _recording
    _recording = bool(on)


def max_spans() -> int:
    """The span-ring capacity (``HOROVOD_TRACE_MAX_SPANS``, default
    :data:`DEFAULT_MAX_SPANS`; ``0`` means unbounded). Cached after first
    read; :func:`reset` re-reads."""
    global _max_spans_cache
    if _max_spans_cache is None:
        try:
            _max_spans_cache = int(
                os.environ.get("HOROVOD_TRACE_MAX_SPANS", "")
                or DEFAULT_MAX_SPANS
            )
        except ValueError:
            _max_spans_cache = DEFAULT_MAX_SPANS
    return _max_spans_cache


def _now_us() -> float:
    global _epoch_ns
    now = time.monotonic_ns()
    if _epoch_ns is None:
        _epoch_ns = now
    return (now - _epoch_ns) / 1e3


def set_epoch() -> None:
    """Pin ts=0 to *now*. ``NativeCore.__init__`` calls this immediately
    before ``hvd_core_init`` so host and native timestamps share an origin;
    without a core, the first recorded event sets the epoch."""
    global _epoch_ns
    _epoch_ns = time.monotonic_ns()


def epoch_ns() -> int:
    """Raw ``time.monotonic_ns`` value of this process's ts=0 origin
    (established on first use). The clock-sync metadata records it so the
    merge tool can place per-rank files on one timebase."""
    _now_us()  # establish the epoch if nothing recorded yet
    return int(_epoch_ns)


def rel_us(monotonic_s: float) -> float:
    """Convert a local ``time.monotonic()`` reading (seconds) into this
    process's trace timebase (µs since the epoch)."""
    _now_us()
    return (monotonic_s * 1e9 - _epoch_ns) / 1e3


def set_clock_info(info: Optional[dict]) -> None:
    """Attach clock-sync metadata (rank, epoch origin, offset to the KV
    server's clock, error bound — see
    :func:`horovod_tpu_torch.observability.clock.refresh`) that :func:`flush`
    embeds as a ``clock_sync`` meta event, making the file mergeable on a
    skew-corrected timebase."""
    global _clock_info
    _clock_info = dict(info) if info else None


class _Span:
    """Re-entrant-per-instance complete-event recorder ('X' phase)."""

    __slots__ = ("tid", "name", "args", "_t0")

    def __init__(self, tid: str, name: str, args: Optional[dict] = None):
        self.tid = tid
        self.name = name
        self.args = args

    def __enter__(self):
        self._t0 = _now_us()
        return self

    def __exit__(self, *exc):
        t1 = _now_us()
        ev = {
            "ph": "X",
            "pid": HOST_PID,
            "tid": self.tid,
            "name": self.name,
            "ts": round(self._t0, 1),
            "dur": round(t1 - self._t0, 1),
        }
        if self.args:
            ev["args"] = self.args
        _append(ev)
        return False


def _append(event: dict) -> None:
    global _dropped
    overflowed = False
    with _lock:
        cap = max_spans()
        while cap > 0 and len(_events) >= cap:
            # ring semantics: drop the OLDEST so a long soak keeps its most
            # recent window (the reverse — refusing new events — would
            # freeze the trace at the start of the run, the least useful
            # window for debugging what eventually went wrong)
            _events.popleft()
            _dropped += 1
            overflowed = True
        _events.append(event)
    if overflowed and _metrics.enabled():
        _metrics.counter(
            "trace_spans_dropped",
            help="host-trace events evicted by the span ring "
                 "(HOROVOD_TRACE_MAX_SPANS)",
        ).inc()


def add_raw(event: dict) -> None:
    """Append one pre-built chrome-trace event (the straggler layer's
    per-rank arrival rows use this to write onto ``rank<r>`` pid lanes).
    No-op while recording is disabled."""
    if not enabled():
        return
    _append(event)


@contextlib.contextmanager
def _noop_span():
    yield None


_NOOP = _noop_span  # factory: cheapest disabled path is one call + yield


def span(tid: str, name: str, **args):
    """Context manager recording one complete event on host lane ``tid``
    (e.g. ``with trace.span("enqueue", tensor_name): ...``). Keyword
    arguments land in the event's ``args`` — collective spans carry their
    ``(step, gen, seq)`` correlation key this way."""
    if not enabled():
        return _NOOP()
    return _Span(tid, name, args or None)


def instant(tid: str, name: str, **args) -> None:
    """One instant event (the host analog of the native writer's
    ``CYCLE_START`` markers)."""
    if not enabled():
        return
    ev = {
        "ph": "i",
        "s": "t",
        "pid": HOST_PID,
        "tid": tid,
        "name": name,
        "ts": round(_now_us(), 1),
    }
    if args:
        ev["args"] = args
    _append(ev)


def events() -> list:
    """Copy of the buffered (not yet flushed) host events."""
    with _lock:
        return list(_events)


def dropped() -> int:
    """Events evicted from the ring since the last flush/reset."""
    return _dropped


def reset() -> None:
    """Drop buffered events and the cached enable/epoch/recording state
    (tests)."""
    global _epoch_ns, _enabled_cache, _recording, _dropped
    global _max_spans_cache, _clock_info
    with _lock:
        _events.clear()
    _epoch_ns = None
    _enabled_cache = None
    _recording = True
    _dropped = 0
    _max_spans_cache = None
    _clock_info = None


def flush(path: Optional[str] = None) -> Optional[str]:
    """Merge buffered host events into the chrome-trace file at ``path``
    (default: ``HOROVOD_TIMELINE``) and clear the buffer.

    Call AFTER the native core shut down (its writer thread closes the JSON
    array then): the existing file is parsed, host events are appended, and
    the merged array is rewritten as valid JSON. With no existing/parseable
    file the host events alone are written. ``horovod_tpu_torch.shutdown`` does
    this on process rank 0 — the rank whose file the core wrote — and
    writes ranks != 0 to a ``<HOROVOD_TIMELINE>.rank<r>.json`` sidecar
    each (merge them with
    :func:`horovod_tpu_torch.observability.clock.merge_rank_traces`).

    Returns the path written, or None when there was nothing to do.
    """
    global _dropped
    path = path or os.environ.get("HOROVOD_TIMELINE")
    with _lock:
        pending = list(_events)
        _events.clear()
        dropped_n, _dropped = _dropped, 0
    if not path or not pending:
        return None
    if dropped_n:
        pending.append(
            {
                "ph": "i", "s": "g", "pid": HOST_PID, "tid": "meta",
                "name": f"host-trace ring full: {dropped_n} oldest events "
                        "dropped",
                "ts": round(_now_us(), 1),
            }
        )
    if _clock_info:
        # merge tools read this to shift the file onto the fleet timebase
        pending.append(
            {
                "ph": "i", "s": "g", "pid": HOST_PID, "tid": "meta",
                "name": "clock_sync", "ts": 0.0,
                "args": dict(_clock_info),
            }
        )
    merged: list = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            # unparseable: the core is still writing (or foreign content) —
            # never clobber it; park host events in a sidecar instead
            path = path + ".host.json"
        else:
            if isinstance(existing, list):
                merged = existing
    merged.extend(pending)
    tmp = path + ".host.tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(tmp, path)
    return path
