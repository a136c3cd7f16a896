"""Black-box flight recorder + cross-rank hang forensics.

The timeline/stall machinery can say *that* a collective stalled
— while the process is alive to be asked. What it cannot answer is *why a
job died or hung after the fact*: a wedged rank, a SIGKILL, or a mesh
deadlocked on a divergent schedule takes the metrics registry, the trace
ring, and the sanitizer records down with it. Production collective stacks
solved this with an always-on crash-safe event ring (PyTorch's NCCL
"flight recorder" / ``TORCH_NCCL_TRACE_BUFFER``); this module is that
instrument for horovod_tpu_torch:

- **Flight ring** — a bounded in-process ring of structured events,
  appended through the hooks that already exist: collective begin/end with
  the sanitizer's ``(step, generation, seq)`` correlation signature
  (``ops.collective._record_eager_op`` / the ``_guarded`` launch wrapper),
  step boundaries (``InstrumentedStep``), health-machine transitions,
  chaos injections, elastic membership epochs, per-step sanitizer schedule
  hashes, serving publish/subscribe/admission decisions, and input-plane
  ``data`` events (prefetch-watchdog stalls, shard quarantines — rare and
  crash-adjacent, so they flush to the sidecar immediately like health
  transitions). Always on (``HOROVOD_FLIGHT=0`` opts
  out); the per-event cost is one dict append under a lock.
- **Crash-durable sidecar** — with ``HOROVOD_FLIGHT_DIR`` set, events are
  batch-appended to a per-rank JSONL sidecar
  (``flight-rank<r>.jsonl``), torn-tail tolerant like the rendezvous WAL
  (a line cut mid-write by SIGKILL is skipped at load; everything before
  it is good). Non-collective events flush immediately; the hot
  collective stream flushes every ``HOROVOD_FLIGHT_FLUSH_EVERY`` events.
  The file is compacted back to the ring contents when it outgrows
  ``HOROVOD_FLIGHT_MAX_BYTES``, so the record stays bounded AND survives
  SIGKILL.
- **Hang detector** — a watchdog (armed when ``HOROVOD_HANG_TIMEOUT`` > 0)
  that fires when no collective-end/step progress lands for the timeout:
  it pushes every reachable rank's ring tail to the rendezvous KV
  (``/flight/tail/<rank>``, beside the ``/sanitize`` records) and, on
  rank 0, produces a merged clock-skew-corrected diagnosis
  (:func:`analyze`) naming the collective ``(step, gen, seq)`` the stuck
  ranks are parked on and the rank(s) that never arrived — distinguishing
  "rank N missing at seq K" from "schedules diverged at seq K" by
  cross-checking the per-step sanitizer hashes. The verdict feeds
  :func:`horovod_tpu_torch.resilience.health.record_hang` and (with
  ``HOROVOD_HANG_EVICT=1``) queues the missing rank for elastic eviction
  at the next membership sweep.
- **Offline forensics** — :func:`analyze_dir` replays the same
  :func:`analyze` from sidecar files alone (merge, skew-correct, unified
  timeline + verdict) for the case where every process is already dead.

Topology note (the same convention as the sanitizer/straggler layers):
single-controller SPMD dispatches on behalf of every rank, so the one
sidecar carries a ``ranks`` list in its header. The deterministic chaos
charge ``HOROVOD_CHAOS=rank_hang_at_step=K`` makes the loop testable on
the 8-device CPU mesh: the highest rank (never rank 0) "stops dispatching"
mid-step — its view of the record is frozen *before* the parked collective
and written to its own sidecar, every survivor records the begin with no
end, and the dispatching thread really holds (released by the live
diagnosis or after ``rank_hang_hold`` seconds) so the watchdog fires for
real. Multi-process: the highest process rank holds *before* dispatching,
parking its peers inside the actual collective.

Clock model: events are stamped with raw local ``time.monotonic``; the
sidecar header and every KV tail carry this rank's offset to the KV
server's clock (:mod:`horovod_tpu_torch.observability.clock`), applied at
merge/analysis time — records captured before the first clock sync are
corrected retroactively, the same discipline as the straggler ring.

stdlib-only at import (chaos/health/sanitizer/basics are imported lazily
at call time); importing this module must never initialize a device
backend.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from horovod_tpu_torch.observability import clock as _clock
from horovod_tpu_torch.observability import metrics as _metrics

logger = logging.getLogger("horovod_tpu_torch.observability")

__all__ = [
    "FLIGHT_ENV",
    "DIR_ENV",
    "enabled",
    "configure",
    "reset",
    "record",
    "collective_begin",
    "collective_end",
    "step_boundary",
    "events",
    "flush",
    "sidecar_path",
    "load_sidecar",
    "load_dir",
    "analyze",
    "analyze_loaded",
    "analyze_dir",
    "push_tails",
    "read_tails",
    "maybe_arm_watchdog",
    "arm_watchdog",
    "disarm_watchdog",
    "last_hang",
    "take_hung_ranks",
    "evict_enabled",
    "hang_timeout",
    "TAIL_SCOPE",
]

FLIGHT_ENV = "HOROVOD_FLIGHT"
DIR_ENV = "HOROVOD_FLIGHT_DIR"
MAX_EVENTS_ENV = "HOROVOD_FLIGHT_MAX_EVENTS"
FLUSH_EVERY_ENV = "HOROVOD_FLIGHT_FLUSH_EVERY"
MAX_BYTES_ENV = "HOROVOD_FLIGHT_MAX_BYTES"
HANG_TIMEOUT_ENV = "HOROVOD_HANG_TIMEOUT"
HANG_TAIL_ENV = "HOROVOD_HANG_TAIL"
HANG_EVICT_ENV = "HOROVOD_HANG_EVICT"

#: KV namespace the watchdog pushes ring tails under (``<scope>/<rank>``),
#: beside the sanitizer's ``/sanitize`` records
TAIL_SCOPE = "/flight/tail"

#: ring capacity default — a few thousand recent events is hours of step
#: boundaries or minutes of dense eager dispatch, at ~100 B each
DEFAULT_MAX_EVENTS = 4096
DEFAULT_FLUSH_EVERY = 32
DEFAULT_MAX_BYTES = 8 << 20
DEFAULT_HANG_TAIL = 64

# re-entrant: the watchdog thread's firing path re-enters through
# flush()/record() while helpers consult the env caches under the lock
_lock = threading.RLock()
_events: "collections.deque" = collections.deque()
_pending: List[dict] = []  # events awaiting a sidecar append (dir set only)
_enabled_cache: Optional[bool] = None
_dir_override: Optional[str] = None
_max_events_cache: Optional[int] = None
_flush_every_cache: Optional[int] = None

_sidecar_file = None
_sidecar_path_current: Optional[str] = None
_sidecar_bytes = 0
_header_sig: Optional[tuple] = None

_kv = None  # KVStoreServer/KVStoreClient duck-type, or the local store
_world_override: Optional[int] = None
_rank_override: Optional[int] = None

# correlation state for collective_end (once-per-key)
_last_begin: Optional[Tuple[Tuple[int, int, int], str]] = None
_last_end_key: Optional[Tuple[int, int, int]] = None

# single-controller rank-hang simulation: the victim's view of the record
# is frozen at the moment it "stopped dispatching"
_frozen_rank: Optional[int] = None
_frozen_tail: Optional[List[dict]] = None

# hang-detector state: (thread, its OWN stop event) — per-thread, so a
# re-arm can never resurrect a predecessor blocked in a slow firing (a
# shared event cleared by arm_watchdog would)
_watchdog: Optional[Tuple[threading.Thread, threading.Event]] = None
_release = threading.Event()  # set by a live diagnosis; ends a chaos hold
_last_progress: Optional[float] = None
_armed_at: Optional[float] = None
_fired_at: Optional[float] = None
_last_hang: Optional[dict] = None
_hung_ranks: List[int] = []


# --------------------------------------------------------------------- config


def enabled() -> bool:
    """True unless ``HOROVOD_FLIGHT=0``: the recorder is always-on (the
    ring is the whole point — the record must exist *before* anything goes
    wrong). Env cached after first read; :func:`reset` re-reads."""
    global _enabled_cache
    if _enabled_cache is None:
        with _lock:
            _enabled_cache = os.environ.get(
                FLIGHT_ENV, "1"
            ).lower() not in ("0", "false", "off")
    return _enabled_cache


def flight_dir() -> Optional[str]:
    """Sidecar directory (``HOROVOD_FLIGHT_DIR`` or :func:`configure`
    override); None = in-memory ring only (no crash durability)."""
    if _dir_override is not None:
        return _dir_override or None
    return os.environ.get(DIR_ENV) or None


def max_events() -> int:
    global _max_events_cache
    if _max_events_cache is None:
        with _lock:
            try:
                _max_events_cache = int(
                    os.environ.get(MAX_EVENTS_ENV, "")
                    or DEFAULT_MAX_EVENTS
                )
            except ValueError:
                _max_events_cache = DEFAULT_MAX_EVENTS
    return _max_events_cache


def _flush_every() -> int:
    global _flush_every_cache
    if _flush_every_cache is None:
        with _lock:
            try:
                _flush_every_cache = max(1, int(
                    os.environ.get(FLUSH_EVERY_ENV, "")
                    or DEFAULT_FLUSH_EVERY
                ))
            except ValueError:
                _flush_every_cache = DEFAULT_FLUSH_EVERY
    return _flush_every_cache


def _max_bytes() -> int:
    try:
        return int(os.environ.get(MAX_BYTES_ENV, "") or DEFAULT_MAX_BYTES)
    except ValueError:
        return DEFAULT_MAX_BYTES


def hang_timeout() -> float:
    """``HOROVOD_HANG_TIMEOUT`` in seconds; 0 (the default) leaves the
    watchdog unarmed."""
    try:
        return float(os.environ.get(HANG_TIMEOUT_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def _hang_tail() -> int:
    try:
        return max(8, int(
            os.environ.get(HANG_TAIL_ENV, "") or DEFAULT_HANG_TAIL
        ))
    except ValueError:
        return DEFAULT_HANG_TAIL


def evict_enabled() -> bool:
    """``HOROVOD_HANG_EVICT=1``: a diagnosed missing rank is queued for
    elastic eviction at the next membership sweep."""
    return os.environ.get(HANG_EVICT_ENV, "0").lower() in ("1", "true", "on")


def configure(*, on: Optional[bool] = None, dir: Optional[str] = None,
              kv=None, world: Optional[int] = None,
              rank: Optional[int] = None) -> None:
    """Programmatic setup (tests / explicit wiring): flip the switch, point
    the sidecar at a directory (``dir=""`` disables the sidecar regardless
    of the env), wire a KV store for tail pushes, or pin the world size /
    this process's rank (a recorder used outside an initialized data
    plane — drills, tools — has no ``basics`` identity to ask)."""
    global _enabled_cache, _dir_override, _kv, _world_override
    global _rank_override
    with _lock:
        if on is not None:
            _enabled_cache = bool(on)
        if dir is not None:
            _dir_override = dir
            _close_sidecar_locked()
        if kv is not None:
            _kv = kv
        if world is not None:
            _world_override = int(world)
        if rank is not None:
            _rank_override = int(rank)


def reset() -> None:
    """Back to env-driven config and an empty ring (tests)."""
    global _enabled_cache, _dir_override, _max_events_cache
    global _flush_every_cache, _kv, _world_override, _rank_override
    global _last_begin, _last_end_key, _frozen_rank, _frozen_tail
    global _last_progress, _armed_at, _fired_at, _last_hang, _hung_ranks
    disarm_watchdog()
    with _lock:
        _events.clear()
        _pending.clear()
        _close_sidecar_locked()
        _enabled_cache = None
        _dir_override = None
        _max_events_cache = None
        _flush_every_cache = None
        _kv = None  # a fresh in-process store is built on next use
        _world_override = None
        _rank_override = None
        _last_begin = None
        _last_end_key = None
        _frozen_rank = None
        _frozen_tail = None
        _last_progress = None
        _armed_at = None
        _fired_at = None
        _last_hang = None
        _hung_ranks = []
    _release.set()  # free any chaos hold a failed test left parked


def _identity() -> Tuple[int, int, int]:
    """(world, process_rank, process_size) — lazily, like the sanitizer,
    so this module never imports the data plane at import time. The
    :func:`configure` rank/world overrides win (a drill or tool process
    has no initialized data plane to ask; with a pinned rank the process
    is treated as one of ``world`` peers)."""
    world, prank, psize = 1, 0, 1
    try:
        from horovod_tpu_torch import basics

        if basics.is_initialized():
            world, prank, psize = basics.size(), basics.process_rank(), \
                basics.process_size()
    except Exception as e:
        logger.debug("flight identity probe failed: %s", e)
    if _world_override is not None:
        world = _world_override
    if _rank_override is not None:
        prank = _rank_override
        psize = max(psize, _world_override or (prank + 1), prank + 1)
    return world, prank, psize


def _store():
    """The KV the tails ride: an explicit :func:`configure` store, else a
    client from the launcher env, else a fresh in-process stand-in (the
    shared :mod:`~horovod_tpu_torch.run.rendezvous` wiring — lazily imported so
    this module stays import-light)."""
    global _kv
    if _kv is None:
        with _lock:
            if _kv is None:
                from horovod_tpu_torch.run.rendezvous import (
                    InProcessKVStore, kv_client_from_env,
                )

                _kv = kv_client_from_env() or InProcessKVStore()
    return _kv


# ------------------------------------------------------------------ recording


def record(kind: str, /, **fields) -> Optional[dict]:
    """Append one structured event to the ring (and the sidecar batch).
    The timestamp is raw local monotonic seconds; skew correction happens
    at merge/analysis time. ``t``/``kind`` are the record's own keys —
    caller fields must not reuse them (raises, so a clobbered schema can
    never reach the sidecar silently). Returns the event, or None while
    disabled."""
    if not enabled():
        return None
    if "t" in fields or "kind" in fields:
        raise ValueError(
            "flight.record: 't' and 'kind' are reserved event keys"
        )
    ev = {"t": round(time.monotonic(), 6), "kind": str(kind)}
    ev.update(fields)
    _append(ev)
    return ev


def _append(ev: dict) -> None:
    flush_now = False
    with _lock:
        cap = max_events()
        while cap > 0 and len(_events) >= cap:
            _events.popleft()
        _events.append(ev)
        if flight_dir():
            _pending.append(ev)
            # a sidecar that keeps failing to flush (full disk, perms)
            # must not grow _pending forever: keep at most a ring's worth
            # — the same bound, and the tail is what forensics needs
            if cap > 0 and len(_pending) > cap:
                del _pending[: len(_pending) - cap]
            # collective AND serving streams are hot paths — batch them;
            # everything else (health, hang, step, epoch, chaos) is rare
            # and crash-adjacent, so it reaches the OS immediately
            flush_now = (
                ev["kind"] not in ("collective", "serve")
                or len(_pending) >= _flush_every()
            )
    if _metrics.enabled():
        _metrics.counter(
            "flight_events",
            help="structured events appended to the flight ring",
            kind=ev["kind"],
        ).inc()
    if flush_now:
        flush()


def collective_begin(op: str, key: Tuple[int, int, int], *,
                     world: int = 1, process_rank: int = 0,
                     process_size: int = 1) -> None:
    """One eager collective is about to dispatch (called from
    ``ops.collective._record_eager_op`` with the straggler layer's
    correlation key). Applies any armed ``rank_hang_at_step`` chaos charge:
    the multi-process victim holds HERE — before its begin is recorded, so
    its record shows it never arrived — while the single-controller charge
    freezes the victim's view first, records the survivors' begin, then
    holds the dispatching thread."""
    if not enabled():
        return
    global _last_begin
    mode = _maybe_hang(op, key, world, process_rank, process_size)
    with _lock:
        _last_begin = (tuple(key), str(op))
    record(
        "collective", ph="b", op=str(op),
        step=int(key[0]), gen=int(key[1]), seq=int(key[2]),
    )
    if mode == "hold":
        _hold()


def collective_end() -> None:
    """The most recent begin's launch returned (called from the
    ``_guarded`` eager-launch wrapper). Recorded once per correlation key
    — a begin that never gets its end is exactly the parked state the
    hang diagnosis keys on. Dispatch is asynchronous, so "end" means the
    launch was handed to the runtime, not that the collective completed
    on-device; for hang forensics that is the right boundary (a rank that
    reached it made host progress)."""
    if not enabled():
        return
    global _last_end_key
    with _lock:
        if _last_begin is None or _last_begin[0] == _last_end_key:
            return
        key, op = _last_begin
        _last_end_key = key
    record(
        "collective", ph="e", op=op,
        step=key[0], gen=key[1], seq=key[2],
    )
    _note_progress()


def step_boundary(step: int) -> None:
    """A train-step boundary (``InstrumentedStep`` calls this beside the
    straggler/sanitizer scopes). Counts as forward progress."""
    if not enabled():
        return
    record("step", step=int(step))
    _note_progress()


def _note_progress() -> None:
    global _last_progress
    _last_progress = time.monotonic()


# --------------------------------------------------------------- chaos: hang


def _maybe_hang(op, key, world, prank, psize) -> Optional[str]:
    """Apply an armed ``rank_hang_at_step`` charge at this dispatch.
    Fires mid-step (from the step's second collective on) so the record
    shows partial-step progress — the forensically hard case. Returns
    "hold" when the caller should hold AFTER recording the begin
    (single-controller survivors park on the collective); the
    multi-process victim holds here and then resumes (None)."""
    from horovod_tpu_torch.resilience import chaos

    if not chaos.enabled():
        return None
    at = chaos.rank_hang_step()
    if at is None or int(key[0]) < at or int(key[2]) < 1:
        return None
    if psize > 1:
        victim = psize - 1
        if prank != victim:
            # the charge is consumed only by the process that hangs (the
            # grad_corrupt convention): peers park inside the real
            # collective below the victim's held dispatch
            return None
        chaos.consume_rank_hang()
        logger.warning(
            "chaos: rank %d stops dispatching at collective %s (step %d)",
            victim, tuple(key), key[0],
        )
        _hold()
        return None
    victim = world - 1
    if world < 2:
        return None  # nobody to hang relative to
    chaos.consume_rank_hang()
    with _lock:
        _freeze_rank_locked(victim)
    logger.warning(
        "chaos: rank %d stops dispatching at collective %s (step %d); "
        "simulated on the single-controller dispatcher", victim,
        tuple(key), key[0],
    )
    return "hold"


def _hold() -> None:
    """Really stop dispatching: park until the live diagnosis releases us
    or the chaos hold budget expires — bounded, so a drill can never wedge
    tier-1."""
    from horovod_tpu_torch.resilience import chaos

    _release.clear()
    budget = chaos.rank_hang_hold()
    released = _release.wait(max(0.0, budget))
    record("hang", ph="resume", released=bool(released))


def _freeze_rank_locked(victim: int) -> None:
    """Single-controller: pin the victim's view of the record to this
    instant (it 'never arrives' at the collective about to be recorded)
    and write it to the victim's own sidecar; the shared sidecar gets a
    fresh header excluding the victim so offline analysis sees two
    diverged streams."""
    global _frozen_rank, _frozen_tail, _header_sig
    _frozen_rank = int(victim)
    _frozen_tail = list(_events)
    d = flight_dir()
    if d:
        world, prank, psize = _identity()
        path = os.path.join(d, f"flight-rank{victim}.jsonl")
        try:
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(_header(
                    ranks=[int(victim)],
                    world=_domain_world(world, psize))) + "\n")
                for ev in _frozen_tail:
                    f.write(json.dumps(ev, separators=(",", ":")) + "\n")
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("flight freeze sidecar write failed: %s", e)
    _header_sig = None  # next flush re-headers the shared file


# -------------------------------------------------------------------- sidecar


def _domain_world(world: int, psize: int) -> int:
    """The rank domain a diagnosis reasons over. Multi-process, sidecars
    and KV tails are per-PROCESS, so the domain is the process count —
    recording the chip world there would make offline analysis of any
    multi-chip-per-process run name the never-existing sidecar ranks
    missing. Single-controller, the one process simulates every chip
    rank, so the domain is the world."""
    return psize if psize > 1 else max(1, world)


def _header(*, ranks: List[int], world: int) -> dict:
    info = _clock.info()
    return {
        "kind": "header",
        "ranks": ranks,
        "world": int(world),
        "offset_s": float(info.get("offset_s") or 0.0),
        "error_s": info.get("error_s"),
        "generation": int(info.get("generation") or 0),
        "written_t": round(time.monotonic(), 6),
    }


def sidecar_path() -> Optional[str]:
    """This process's sidecar file path (None when the sidecar is off)."""
    d = flight_dir()
    if not d:
        return None
    _world, prank, _psize = _identity()
    return os.path.join(d, f"flight-rank{prank}.jsonl")


def _close_sidecar_locked() -> None:
    global _sidecar_file, _sidecar_path_current, _sidecar_bytes, _header_sig
    if _sidecar_file is not None:
        try:
            _sidecar_file.close()
        except OSError as e:
            logger.debug("flight sidecar close failed: %s", e)
    _sidecar_file = None
    _sidecar_path_current = None
    _sidecar_bytes = 0
    _header_sig = None


def flush() -> Optional[str]:
    """Append pending events to the sidecar and sync them to the OS
    (surviving SIGKILL from there). Opens the file and (re-)writes a
    header whenever the rank set or clock estimate changed; compacts the
    file back to the current ring once it outgrows
    ``HOROVOD_FLIGHT_MAX_BYTES``. No-op without ``HOROVOD_FLIGHT_DIR``.
    Returns the sidecar path, or None."""
    global _sidecar_file, _sidecar_path_current, _sidecar_bytes, _header_sig
    with _lock:
        d = flight_dir()
        if not d:
            _pending.clear()
            return None
        world, prank, psize = _identity()
        path = os.path.join(d, f"flight-rank{prank}.jsonl")
        try:
            if _sidecar_path_current != path:
                _close_sidecar_locked()
                os.makedirs(d, exist_ok=True)
                _sidecar_file = open(path, "a")
                _sidecar_path_current = path
                _sidecar_bytes = (
                    os.path.getsize(path) if os.path.exists(path) else 0
                )
            if psize > 1:
                ranks = [prank]
            else:
                ranks = [
                    r for r in range(max(1, world)) if r != _frozen_rank
                ]
            dom = _domain_world(world, psize)
            info = _clock.info()
            sig = (tuple(ranks), round(float(info.get("offset_s") or 0.0), 9),
                   info.get("generation"))
            if sig != _header_sig:
                line = json.dumps(_header(ranks=ranks, world=dom)) + "\n"
                _sidecar_file.write(line)
                _sidecar_bytes += len(line)
                _header_sig = sig
            for ev in _pending:
                line = json.dumps(ev, separators=(",", ":")) + "\n"
                _sidecar_file.write(line)
                _sidecar_bytes += len(line)
            # the batch is only dropped once it reached the OS: an
            # ENOSPC raised by flush() keeps _pending (bounded by the
            # ring cap in _append) for retry — a silent gap exactly
            # around a disk-pressure incident is what a post-mortem
            # would be investigating. A partially-buffered batch may
            # duplicate on retry after reopen; duplicates are benign
            # where gaps are not.
            _sidecar_file.flush()
            _pending.clear()
            if _metrics.enabled():
                _metrics.counter(
                    "flight_sidecar_flushes",
                    help="flight-ring batches appended to the crash "
                         "sidecar",
                ).inc()
            if _max_bytes() > 0 and _sidecar_bytes > _max_bytes():
                _compact_locked(path, ranks, dom)
        except OSError as e:
            logger.warning("flight sidecar flush failed: %s", e)
            _close_sidecar_locked()
            return None
        return path


def _compact_locked(path: str, ranks: List[int], world: int) -> None:
    """Rewrite the sidecar as header + the current ring (tmp + atomic
    rename, so a crash mid-compaction keeps the old file)."""
    global _sidecar_file, _sidecar_bytes
    tmp = path + ".compact"
    with open(tmp, "w") as f:
        f.write(json.dumps(_header(ranks=ranks, world=world)) + "\n")
        for ev in _events:
            f.write(json.dumps(ev, separators=(",", ":")) + "\n")
    os.replace(tmp, path)
    try:
        _sidecar_file.close()
    except OSError as e:
        logger.debug("flight sidecar close during compaction failed: %s", e)
    _sidecar_file = open(path, "a")
    _sidecar_bytes = os.path.getsize(path)
    if _metrics.enabled():
        _metrics.counter(
            "flight_sidecar_compactions",
            help="sidecar rewrites after outgrowing "
                 "HOROVOD_FLIGHT_MAX_BYTES",
        ).inc()


def events() -> List[dict]:
    """Copy of the in-memory ring (newest last)."""
    with _lock:
        return list(_events)


def _tail_events(n: int, *, rank: Optional[int] = None) -> List[dict]:
    with _lock:
        if rank is not None and rank == _frozen_rank and \
                _frozen_tail is not None:
            return list(_frozen_tail[-n:])
        return list(_events)[-n:]


# ------------------------------------------------------------------ KV tails


def push_tails(kv=None, *, ttl: float = 120.0) -> int:
    """Push ring tails to the KV under ``/flight/tail/<rank>`` so a live
    diagnosis can see every reachable rank's last events. Multi-process:
    this process's own rank only; single-controller: one tail per
    simulated rank (the frozen victim's is its truncated view). `ttl` is
    the tail's KV lease — the firing path scales it past its own
    diagnosis wait. Returns the number of tails pushed."""
    store = kv or _store()
    world, prank, psize = _identity()
    n = _hang_tail()
    info = _clock.info()
    if psize > 1:
        items = {prank: _tail_events(n)}
    else:
        items = {
            r: _tail_events(n, rank=r) for r in range(max(1, world))
        }
    for r, evs in items.items():
        payload = {
            "rank": int(r),
            "world": _domain_world(world, psize),
            "offset_s": float(info.get("offset_s") or 0.0),
            "generation": int(info.get("generation") or 0),
            "pushed_t": round(time.monotonic(), 6),
            "events": evs,
        }
        store.put(
            f"{TAIL_SCOPE}/{r}",
            json.dumps(payload, separators=(",", ":")).encode(),
            ttl=float(ttl),
        )
    if _metrics.enabled():
        _metrics.counter(
            "flight_tail_pushes",
            help="per-rank flight-ring tails pushed to the KV by the "
                 "hang watchdog",
        ).inc(len(items))
    return len(items)


def read_tails(ranks: Iterable[int], kv=None) -> Dict[int, dict]:
    """Read pushed tails for `ranks` from the KV; absent/unreadable ranks
    are simply missing from the result (their absence is itself
    evidence)."""
    store = kv or _store()
    out: Dict[int, dict] = {}
    for r in ranks:
        try:
            blob = store.get(f"{TAIL_SCOPE}/{int(r)}")
        except Exception as e:
            logger.debug("flight tail read for rank %s failed: %s", r, e)
            continue
        if blob is None:
            continue
        try:
            out[int(r)] = json.loads(blob)
        except ValueError:
            continue
    return out


# ------------------------------------------------------------------- analysis


def _temporal(step: int, gen: int, seq: int) -> Tuple[int, int, int]:
    """Keys in wall-clock order: generation outranks step outranks seq
    (the straggler layer's convention — a resize rolls the step back)."""
    return (gen, step, seq)


def analyze(rank_events: Dict[int, Sequence[dict]], *,
            expected: Optional[Iterable[int]] = None) -> dict:
    """The shared hang diagnosis: fold per-rank event streams into a
    verdict. Used identically by the live watchdog (KV tails) and the
    offline :func:`analyze_dir` (sidecar files) so the two can never
    disagree about the same evidence.

    Returns a dict with ``verdict`` one of:

    - ``"rank_missing"`` — ranks parked at collective ``key`` that some
      rank(s) (``hung_ranks``) never began;
    - ``"schedule_divergence"`` — the stuck step's per-rank sanitizer
      hashes (or the ops recorded at the frontier seq) disagree:
      ``hung_ranks`` names the rank(s) whose record differs from rank 0's;
    - ``"all_parked"`` — every expected rank began the frontier collective
      and none finished it (an external stall: device wedge, network);
    - ``"progressing"`` — the frontier collective completed somewhere and
      nobody is parked behind it;
    - ``"no_data"`` — no collective events to reason about.

    ``key`` is the frontier ``[step, gen, seq]``, ``op`` its collective,
    ``waiting`` the parked ranks, ``last_key`` each rank's newest begun
    signature."""
    expected = sorted(expected) if expected is not None else \
        sorted(rank_events)
    per: Dict[int, dict] = {}
    op_at: Dict[Tuple[int, int, int], str] = {}
    all_begun: set = set()
    for r in expected:
        evs = rank_events.get(r) or []
        last_b: Optional[Tuple[int, int, int]] = None
        last_op: Optional[str] = None
        begun_keys = set()
        ended = set()
        scheds: Dict[Tuple[int, int], str] = {}
        for ev in evs:
            kind = ev.get("kind")
            if kind == "collective":
                try:
                    tkey = _temporal(
                        int(ev.get("step", 0)), int(ev.get("gen", 0)),
                        int(ev.get("seq", 0)))
                except (TypeError, ValueError):
                    continue
                if ev.get("ph") == "e":
                    ended.add(tkey)
                else:
                    begun_keys.add(tkey)
                    op_at.setdefault(tkey, str(ev.get("op", "?")))
                    if last_b is None or tkey >= last_b:
                        last_b = tkey
                        last_op = ev.get("op")
            elif kind == "sched":
                # keyed by (generation, step): an elastic re-formation
                # numbers its steps afresh
                try:
                    scheds[(int(ev.get("gen", 0)),
                            int(ev.get("step", -1)))] = str(ev.get("hash"))
                except (TypeError, ValueError):
                    continue
        all_begun |= begun_keys
        per[r] = {"last_b": last_b, "op": last_op, "ended": ended,
                  "scheds": scheds}
    begun = {r: p["last_b"] for r, p in per.items()
             if p["last_b"] is not None}
    out: dict = {
        "ranks": expected,
        "last_key": {
            str(r): (
                None if per[r]["last_b"] is None
                else [per[r]["last_b"][1], per[r]["last_b"][0],
                      per[r]["last_b"][2]]
            )
            for r in expected
        },
    }
    if not begun:
        out["verdict"] = "no_data"
        return out
    frontier = max(begun.values())
    arrived = sorted(r for r, k in begun.items() if k == frontier)
    waiting = sorted(
        r for r in arrived if frontier not in per[r]["ended"]
    )
    missing = sorted(r for r in expected if r not in arrived)
    ops = {per[r]["op"] for r in arrived if per[r]["op"] is not None}
    out["key"] = [frontier[1], frontier[0], frontier[2]]
    out["op"] = sorted(ops)[0] if ops else "?"
    out["waiting"] = waiting
    # sanitizer cross-check: compare per-step schedule hashes between
    # rank 0 (the coordinator reference) and everyone else, at the newest
    # step both sides recorded
    diverged: List[int] = []
    ref = per.get(0, {}).get("scheds") or {}
    for r in expected:
        if r == 0:
            continue
        theirs = per[r]["scheds"]
        common = set(ref) & set(theirs)
        if not common:
            continue
        s = max(common)
        if ref[s] != theirs[s]:
            diverged.append(r)
    if len(ops) > 1:
        # ranks parked at the same seq on DIFFERENT collectives: the
        # schedules themselves forked (stronger evidence than the hashes,
        # which lag one step). The reference op must come from a rank AT
        # the frontier — rank 0 preferred, else the lowest arrived rank;
        # anchoring on a rank parked at some OTHER key would misattribute
        # every survivor
        ref_rank = 0 if 0 in arrived else arrived[0]
        ref_op = per[ref_rank]["op"]
        diverged = sorted(set(diverged) | {
            r for r in arrived
            if per[r]["op"] is not None and per[r]["op"] != ref_op
        })
    if diverged:
        out["verdict"] = "schedule_divergence"
        out["hung_ranks"] = sorted(diverged)
        return out
    if missing:
        # named missing even when nobody is (still) parked: survivors may
        # have been released/evicted and progressed past the stuck
        # collective, but a rank whose record stops short of the frontier
        # is exactly what the post-mortem is looking for. The signature
        # reported is the FIRST collective the missing rank never joined
        # (its last begun key + 1 in dispatch order), not the end-of-run
        # frontier — that is the seq the survivors parked on.
        stuck = frontier
        for r in missing:
            lb = per[r]["last_b"]
            later = sorted(k for k in all_begun
                           if lb is None or k > lb)
            if later and later[0] < stuck:
                stuck = later[0]
        out["key"] = [stuck[1], stuck[0], stuck[2]]
        out["op"] = op_at.get(stuck, out["op"])
        out["verdict"] = "rank_missing"
        out["hung_ranks"] = missing
        return out
    if waiting and len(waiting) == len(expected):
        out["verdict"] = "all_parked"
        out["hung_ranks"] = []
        return out
    out["verdict"] = "progressing"
    out["hung_ranks"] = []
    return out


def describe(verdict: dict) -> str:
    """One-line human spelling of an :func:`analyze` verdict (shared by
    the live log line and the offline analysis)."""
    v = verdict.get("verdict")
    key = verdict.get("key")
    sig = tuple(key) if key else None
    if v == "rank_missing":
        return (
            f"rank(s) {verdict['hung_ranks']} missing at collective "
            f"(step, gen, seq)={sig} op={verdict.get('op')}; "
            f"rank(s) {verdict.get('waiting')} parked waiting"
        )
    if v == "schedule_divergence":
        return (
            f"schedules diverged at (step, gen, seq)={sig}: rank(s) "
            f"{verdict['hung_ranks']} disagree with rank 0's record"
        )
    if v == "all_parked":
        return (
            f"every rank parked in collective (step, gen, seq)={sig} "
            f"op={verdict.get('op')} — external stall (device/network), "
            f"not a missing rank"
        )
    if v == "progressing":
        return "no hang: the newest collective completed"
    return "no collective events to reason about"


# ----------------------------------------------------------- sidecar loading


def load_sidecar(path: str) -> dict:
    """Parse one sidecar torn-tail tolerantly: unparseable lines (the
    SIGKILL-cut tail, or any corruption) are skipped and counted, like the
    rendezvous WAL replay. The LAST header wins (matching the trace
    merge's newest-``clock_sync`` rule). Returns ``{ranks, world,
    offset_s, generation, events, skipped}``."""
    events_out: List[dict] = []
    header: Optional[dict] = None
    skipped = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                skipped += 1
                continue
            if not isinstance(ev, dict):
                skipped += 1
                continue
            if ev.get("kind") == "header":
                header = ev
            else:
                events_out.append(ev)
    header = header or {}
    return {
        "ranks": [int(r) for r in header.get("ranks", [0])],
        "world": int(header.get("world", 1)),
        "offset_s": float(header.get("offset_s", 0.0)),
        "generation": int(header.get("generation", 0)),
        "events": events_out,
        "skipped": skipped,
    }


def load_dir(path_or_paths) -> Tuple[Dict[int, List[dict]], dict]:
    """Load sidecar files (a directory is globbed for
    ``flight-rank*.jsonl``) into skew-corrected per-rank event streams:
    each file's events are shifted by its header's clock offset, assigned
    to every rank in its LAST header's ``ranks`` list, and sorted by
    corrected time. Returns ``(rank_events, meta)`` where meta carries the
    max ``world`` seen (so a rank with NO file at all can still be named
    missing) and per-file load notes."""
    if isinstance(path_or_paths, str):
        if os.path.isdir(path_or_paths):
            paths = sorted(
                os.path.join(path_or_paths, fn)
                for fn in os.listdir(path_or_paths)
                if fn.startswith("flight-rank") and fn.endswith(".jsonl")
            )
        else:
            paths = [path_or_paths]
    else:
        paths = list(path_or_paths)
    rank_events: Dict[int, List[dict]] = {}
    meta: dict = {"files": [], "world": 0}
    for p in paths:
        try:
            side = load_sidecar(p)
        except OSError as e:
            meta["files"].append({"path": p, "error": str(e)})
            continue
        meta["files"].append({
            "path": p, "ranks": side["ranks"], "events": len(side["events"]),
            "skipped": side["skipped"],
        })
        meta["world"] = max(meta["world"], side["world"])
        off = side["offset_s"]
        for ev in side["events"]:
            try:
                shifted = dict(ev, t=float(ev.get("t", 0.0)) + off)
            except (TypeError, ValueError):
                shifted = dict(ev)
            for r in side["ranks"]:
                rank_events.setdefault(r, []).append(shifted)
    for r in rank_events:
        rank_events[r].sort(key=lambda e: e.get("t") or 0.0)
    return rank_events, meta


def analyze_loaded(rank_events: Dict[int, List[dict]], meta: dict) -> dict:
    """:func:`analyze` over :func:`load_dir` output, with the expected
    rank set widened to the headers' world — a rank that left NO record
    is still named missing. The one offline entry point both
    :func:`analyze_dir` goes through, so the widening
    rule cannot drift between them."""
    expected = set(rank_events)
    if meta.get("world"):
        expected |= set(range(meta["world"]))
    verdict = analyze(rank_events, expected=sorted(expected))
    verdict["meta"] = meta
    return verdict


def analyze_dir(path_or_paths) -> dict:
    """Offline diagnosis from sidecar files alone (what an operator
    runs): load, skew-correct, :func:`analyze_loaded`."""
    rank_events, meta = load_dir(path_or_paths)
    return analyze_loaded(rank_events, meta)


# ------------------------------------------------------------------ watchdog


def maybe_arm_watchdog(kv=None, world: Optional[int] = None):
    """Arm the hang watchdog iff ``HOROVOD_HANG_TIMEOUT`` > 0 (what
    ``horovod_tpu_torch.init`` calls); returns the thread or None."""
    t = hang_timeout()
    if t <= 0 or not enabled():
        return None
    return arm_watchdog(timeout=t, kv=kv, world=world)


def arm_watchdog(*, timeout: float, kv=None, world: Optional[int] = None):
    """Start the watchdog thread: when no collective-end/step progress
    lands for `timeout` seconds (measured from arming or the last progress
    event, and only once any collective/step activity has been seen), it
    pushes ring tails to the KV and — on rank 0 — diagnoses and feeds
    :func:`horovod_tpu_torch.resilience.health.record_hang`. One firing per
    stall episode; progress re-arms it."""
    global _watchdog, _armed_at, _fired_at
    disarm_watchdog()
    if kv is not None or world is not None:
        configure(kv=kv, world=world)
    _armed_at = time.monotonic()
    _fired_at = None
    stop = threading.Event()
    th = threading.Thread(
        target=_watch, args=(float(timeout), stop),
        name="hvd-hang-watchdog", daemon=True,
    )
    _watchdog = (th, stop)
    th.start()
    return th


def disarm_watchdog() -> None:
    global _watchdog
    entry = _watchdog
    if entry is None:
        return
    th, stop = entry
    stop.set()
    _release.set()
    th.join(timeout=5)
    # a thread that outlived the join (blocked in a slow firing) still
    # holds its own (now set) stop event: it exits its loop — and skips
    # publishing a stale verdict — as soon as it unblocks
    _watchdog = None


def _watch(timeout: float, stop: threading.Event) -> None:
    global _fired_at
    poll = max(0.02, min(timeout / 4.0, 1.0))
    while not stop.wait(poll):
        progress = _last_progress
        if _fired_at is not None:
            # one firing per stall episode: re-arm only once progress
            # resumed after the firing
            if progress is not None and progress > _fired_at:
                with _lock:
                    _fired_at = None
            continue
        if progress is None:
            continue  # no collective/step activity yet: nothing to hang
        # measured from arming OR the last progress, whichever is newer:
        # a re-arm after an elastic resize must not fire instantly off
        # the stale pre-resize progress stamp
        base = progress if _armed_at is None else max(progress, _armed_at)
        if time.monotonic() - base >= timeout:
            try:
                _fire(timeout, stop)
            except Exception:
                logger.warning(
                    "hang watchdog firing failed", exc_info=True)
                with _lock:
                    _fired_at = time.monotonic()


def _fire(timeout: float, stop: Optional[threading.Event] = None) -> None:
    """The watchdog tripped: persist + push this process's evidence, and
    (rank 0) run the cross-rank diagnosis. `stop` is the owning thread's
    disarm event: a firing that outlives its watchdog (disarm during the
    peer-tail wait) aborts instead of publishing a stale verdict into a
    newer generation."""
    global _fired_at, _last_hang
    with _lock:
        _fired_at = time.monotonic()
    record("hang", ph="fired", timeout=timeout)
    if _metrics.enabled():
        _metrics.counter(
            "hang_watchdog_fired",
            help="hang-watchdog firings (no collective/step progress for "
                 "HOROVOD_HANG_TIMEOUT)",
        ).inc()
    flush()
    # tails must outlive the whole diagnosis window: rank 0 waits up to
    # one timeout for peers, and every poll re-reads — a lease shorter
    # than that would expire the surviving peers' evidence mid-wait
    ttl = max(120.0, 4.0 * timeout)
    try:
        push_tails(ttl=ttl)
    except Exception as e:
        logger.warning("flight tail push failed: %s", e)
    world, prank, psize = _identity()
    if prank != 0:
        return  # the coordinator owns the verdict
    participants = list(range(max(1, psize if psize > 1 else world)))
    # peers' watchdogs fire on their own clocks: give their pushes one
    # timeout's grace before diagnosing with what there is (an absent tail
    # is itself evidence — the prime suspect pushes nothing)
    deadline = time.monotonic() + max(0.2, timeout)
    tails = {}
    while True:
        tails = read_tails(participants)
        if len(tails) >= len(participants) or time.monotonic() >= deadline:
            break
        if stop is not None and stop.wait(max(0.02, timeout / 10.0)):
            return  # disarmed mid-wait: no stale verdict
        elif stop is None:
            time.sleep(max(0.02, timeout / 10.0))
    if stop is not None and stop.is_set():
        return  # disarmed: the new generation owns diagnosis now
    verdict = analyze(
        {r: t.get("events", []) for r, t in tails.items()},
        expected=participants,
    )
    # live-only sharpening: the sanitizer may have already named a
    # divergence at the stuck step's boundary — trust it over "missing"
    if verdict.get("verdict") in ("rank_missing", "all_parked"):
        try:
            from horovod_tpu_torch.analysis import sanitizer as _sanitizer

            d = _sanitizer.last_divergence()
            if d and verdict.get("key") and \
                    int(d["step"]) >= int(verdict["key"][0]) - 1:
                verdict = dict(
                    verdict, verdict="schedule_divergence",
                    hung_ranks=[int(d["rank"])], sanitizer=d,
                )
        except Exception as e:
            logger.debug("sanitizer cross-check failed: %s", e)
    record(
        "hang", ph="diagnosed", verdict=verdict.get("verdict"),
        key=verdict.get("key"), op=verdict.get("op"),
        hung_ranks=verdict.get("hung_ranks"),
    )
    flush()
    if _metrics.enabled():
        _metrics.counter(
            "hang_diagnosed",
            help="hang-watchdog diagnoses, by verdict",
            verdict=str(verdict.get("verdict")),
        ).inc()
    logger.error("hang diagnosis: %s", describe(verdict))
    if verdict.get("verdict") in (
        "rank_missing", "schedule_divergence", "all_parked",
    ):
        from horovod_tpu_torch.resilience import health

        hung = verdict.get("hung_ranks") or []
        health.record_hang(
            hung[0] if hung else None,
            verdict.get("key"),
            kind=verdict.get("verdict", "rank_missing"),
        )
        if hung and evict_enabled():
            with _lock:
                for r in hung:
                    if r != 0 and r not in _hung_ranks:
                        _hung_ranks.append(int(r))
    with _lock:
        # published LAST: a poller seeing last_hang() non-None may rely
        # on the health strike and eviction queue already being in place
        _last_hang = verdict
    _release.set()  # free a chaos hold parked on the diagnosis


def last_hang() -> Optional[dict]:
    """The most recent live diagnosis this process produced, or None."""
    return _last_hang


def take_hung_ranks() -> List[int]:
    """Drain the ranks a diagnosis queued for elastic eviction (populated
    only under ``HOROVOD_HANG_EVICT=1``; the elastic membership sweep
    consumes this exactly like the numerics quarantine set)."""
    global _hung_ranks
    with _lock:
        out, _hung_ranks = _hung_ranks, []
    return out


def requeue_hung_ranks(ranks: Iterable[int]) -> None:
    """Put verdicts back after a failed eviction attempt (a transient KV
    error at ``mark_dead`` must not lose the verdict — the watchdog fires
    once per stall episode and a hung mesh makes no progress to re-arm
    it, so a dropped verdict would never be re-derived). Mirrors
    ``numerics.requeue_corrupt_ranks``."""
    with _lock:
        for r in ranks:
            if int(r) not in _hung_ranks:
                _hung_ranks.append(int(r))
