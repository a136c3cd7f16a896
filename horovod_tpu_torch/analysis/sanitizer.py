"""Runtime cross-rank collective-schedule sanitizer (``HOROVOD_SANITIZE=1``).

The static layers (:mod:`~horovod_tpu_torch.analysis.lint`,
:mod:`~horovod_tpu_torch.analysis.schedule`) prove a *traced* program's schedule
is rank-independent; the eager path has no trace to prove anything about —
each dispatch is a fresh decision the host makes at runtime, which is
exactly where Horovod's coordinator earned its keep (PAPER.md L4: rank 0
knows which ranks submitted which tensors). This module rebuilds that
defense on the observability plane:

- every eager collective dispatch appends its **signature** (op name,
  per-tensor shape/dtype, axis) to a per-step ring and folds it into a
  **rolling hash**;
- at each step boundary the finished step's ``{hash, count, ops}`` record
  is published to the rendezvous KV under ``/sanitize/<step>/<rank>``
  (TTL'd; an in-process store stands in when no KV is wired up);
- rank 0 **cross-checks** the previous step: every rank's hash must match
  rank 0's. On mismatch the first divergent op index and the divergent
  rank are named — ``sanitizer_schedule_divergence{rank=}`` increments,
  and :func:`horovod_tpu_torch.resilience.health.record_schedule_divergence`
  strikes the health machine to SUSPECT with the rank + op in the reason.

Topology note: single-controller SPMD dispatches on behalf of every rank,
so per-rank schedules are identical by construction — there the sanitizer
is exercised by the deterministic chaos charge
``HOROVOD_CHAOS=schedule_diverge_at_step=K`` (the highest rank's published
record is perturbed at step K, mirroring ``rank_fail``'s never-rank-0
convention), which is also how tier-1 pins the detection latency: the
divergence is named within one step. Multi-process ranks each publish only
their own record and rank 0 cross-checks for real.

Env knobs:

- ``HOROVOD_SANITIZE`` — ``1`` to enable (default off: the happy path
  costs one boolean per dispatch).
- ``HOROVOD_SANITIZE_MAX_OPS`` (default 512) — per-step ring capacity;
  overflowing ops still roll the hash but drop their diagnostic
  signature.
- ``HOROVOD_SANITIZE_TTL`` (default 120 s) — KV record TTL.

stdlib-only at import; chaos/health are imported lazily at call time.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from horovod_tpu_torch.observability import metrics as _metrics

__all__ = [
    "SANITIZE_ENV",
    "enabled",
    "configure",
    "reset",
    "record",
    "set_step",
    "flush",
    "publish",
    "cross_check",
    "last_divergence",
    "schedule_key",
]

SANITIZE_ENV = "HOROVOD_SANITIZE"
MAX_OPS_ENV = "HOROVOD_SANITIZE_MAX_OPS"
TTL_ENV = "HOROVOD_SANITIZE_TTL"

_lock = threading.Lock()
_enabled: Optional[bool] = None  # None = read env
_kv = None  # KVStoreServer/KVStoreClient duck-type, or the local store
#: the step whose ops the ring holds; None before the first boundary of
#: a run or a generation (those ops join the first step's record)
_step: Optional[int] = None
_ops: List[list] = []
_dropped = 0
_hash = hashlib.sha256()
_last_divergence: Optional[dict] = None
_world_override: Optional[int] = None
#: steps rank 0 could not fully cross-check yet (a peer's publication had
#: not landed) -> remaining recheck attempts; retried at later boundaries
_pending_checks: Dict[int, int] = {}

#: boundaries a step with missing peers is retried before being dropped
#: (a peer that never publishes is the heartbeat layer's finding, not a
#: schedule verdict)
PENDING_CHECK_ATTEMPTS = 8


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get(SANITIZE_ENV, "0").lower() not in (
            "0", "false", "off", "",
        )
    return _enabled


def configure(on: Optional[bool] = None, *, kv=None,
              world: Optional[int] = None) -> None:
    """Programmatic setup: flip the switch, wire a KV store (a
    :class:`~horovod_tpu_torch.run.rendezvous.KVStoreServer` or ``...Client``),
    or pin the world size (defaults to what dispatches report)."""
    global _enabled, _kv, _world_override
    with _lock:
        if on is not None:
            _enabled = bool(on)
        if kv is not None:
            _kv = kv
        if world is not None:
            _world_override = int(world)


def reset() -> None:
    """Back to env-driven config and an empty ring (tests)."""
    global _enabled, _kv, _step, _ops, _dropped, _hash
    global _last_divergence, _world_override
    with _lock:
        _enabled = None
        _kv = None  # a fresh in-process store is built on next use
        _step = None
        _ops = []
        _dropped = 0
        _hash = hashlib.sha256()
        _last_divergence = None
        _world_override = None
        _pending_checks.clear()


def _max_ops() -> int:
    return max(8, int(os.environ.get(MAX_OPS_ENV, "512")))


def _ttl() -> float:
    return float(os.environ.get(TTL_ENV, "120"))


def _store():
    """Explicit :func:`configure` store, else a client from the launcher
    env (``HVD_RUN_KV_ADDR``/``HVD_RUN_KV_PORT``), else a fresh
    in-process stand-in — the shared
    :mod:`~horovod_tpu_torch.run.rendezvous` wiring, lazily imported so this
    module stays importable from collection-time contexts."""
    global _kv
    if _kv is None:
        from horovod_tpu_torch.run.rendezvous import (
            InProcessKVStore, kv_client_from_env,
        )

        _kv = kv_client_from_env() or InProcessKVStore()
    return _kv


def _generation() -> int:
    from horovod_tpu_torch.observability import straggler

    return straggler.generation()


def schedule_key(step: int, rank: int, gen: Optional[int] = None) -> str:
    """``/sanitize/<step>/<rank>``, the JAX package's key, in generation
    0; ``/sanitize/g<gen>/<step>/<rank>`` in a later elastic generation
    (``gen`` default: the straggler keys' generation), whose step numbers
    restart where the world re-formed and must not meet the records of
    the world before it."""
    gen = _generation() if gen is None else int(gen)
    if gen == 0:
        return f"/sanitize/{int(step)}/{int(rank)}"
    return f"/sanitize/g{gen}/{int(step)}/{int(rank)}"


# --------------------------------------------------------------------------
# recording


def _axis_repr(axis) -> str:
    if axis is None:
        return "data"
    if isinstance(axis, (tuple, list)):
        return "+".join(str(a) for a in axis)
    return str(axis)


def _dtype_name(t) -> str:
    """numpy's name of a tensor's dtype (``"float32"``, ``"bfloat16"``):
    the JAX package's record spells JAX arrays' dtypes so, and the same
    ops must hash to the same hex in both packages."""
    return str(getattr(t, "dtype", "?")).replace("torch.", "")


def record(op: str, tensors, axis=None) -> None:
    """Append one dispatched eager collective's signature to the current
    step's ring and roll the hash. Called from
    ``ops.collective._record_eager_op`` — the one choke point every eager
    dispatch passes through."""
    if not enabled():
        return
    sig = [
        str(op),
        _axis_repr(axis),
        [
            [list(getattr(t, "shape", ()) or ()), _dtype_name(t)]
            for t in tensors
        ],
    ]
    blob = json.dumps(sig, separators=(",", ":")).encode()
    global _dropped
    with _lock:
        _hash.update(blob)
        if len(_ops) < _max_ops():
            _ops.append(sig)
        else:
            _dropped += 1


def _snapshot_locked() -> dict:
    return {
        "hash": _hash.hexdigest(),
        "n": len(_ops) + _dropped,
        "dropped": _dropped,
        "ops": list(_ops),
    }


# --------------------------------------------------------------------------
# step boundary: publish + cross-check


def set_step(step: int) -> None:
    """Open step `step`'s recording scope; the step that just finished is
    published and (rank 0) cross-checked. ``InstrumentedStep`` calls this
    per dispatched train step, next to the straggler correlation scope;
    explicit loops call it themselves.

    The first boundary of a run (or of an elastic generation,
    :func:`begin_generation`) publishes nothing: the ops recorded before
    it (the elastic driver's commit, a re-formation's broadcast) join
    the first step's record, so no step is published twice under one
    key with different contents."""
    if not enabled():
        return
    global _step
    with _lock:
        opening = _step is None
    if not opening:
        flush()
    with _lock:
        _step = int(step)


def begin_generation() -> None:
    """An elastic re-formation: the abandoned step's partial ring and the
    old generation's pending re-checks are dropped (its peers may never
    finish that step), and the next boundary opens the new generation's
    first step (its records are keyed by the generation:
    :func:`schedule_key`)."""
    global _step
    with _lock:
        _reset_ring_locked()
        _pending_checks.clear()
        _step = None


def flush() -> Optional[dict]:
    """Publish + cross-check the current step's record and clear the
    ring; also retry earlier steps whose cross-check was incomplete (a
    peer's publication had not landed at its own boundary — the race a
    multi-process job hits when rank 0 reaches the boundary first).
    Returns the newest divergence detected (also kept in
    :func:`last_divergence`)."""
    if not enabled():
        return None
    with _lock:
        step = 0 if _step is None else _step
        record_now = _snapshot_locked()
        _reset_ring_locked()
        pending_steps = sorted(_pending_checks)
    out: Optional[dict] = None
    for pending in pending_steps:
        out = cross_check(pending) or out
    if record_now["n"] == 0:
        return out
    publish(step, record_now)
    return cross_check(step) or out


def _reset_ring_locked() -> None:
    global _ops, _dropped, _hash
    _ops = []
    _dropped = 0
    _hash = hashlib.sha256()


def _identity() -> Tuple[int, int, int]:
    """(world, process_rank, process_size) — lazily, so this module never
    imports the data plane at import time."""
    try:
        from horovod_tpu_torch import basics

        if basics.is_initialized():
            return basics.size(), basics.process_rank(), \
                basics.process_size()
    except Exception as e:  # pre-init dispatch: treat as a 1-rank world
        import logging

        logging.getLogger("horovod_tpu_torch").debug(
            "sanitizer identity probe failed: %s", e)
    return 1, 0, 1


def _chaos_mod():
    from horovod_tpu_torch.resilience import chaos

    return chaos


def publish(step: int, record_dict: Optional[dict] = None) -> None:
    """Publish `step`'s schedule record to the KV.

    Single-controller (``process_size == 1``): one record is written for
    EVERY rank — they dispatched the same ops by construction — except
    when the ``schedule_diverge_at_step`` chaos charge fires, in which
    case the highest rank's copy is perturbed (first op renamed, hash
    re-rolled) so the cross-check has a real divergence to find.
    Multi-process: each process writes only its own rank's record; the
    chaos charge fires on the highest process rank."""
    if record_dict is None:
        with _lock:
            record_dict = _snapshot_locked()
    world, prank, psize = _identity()
    if _world_override is not None:
        world = _world_override
    store = _store()
    ttl = _ttl()
    chaos = _chaos_mod()
    # only the process that would actually perturb consumes the charge:
    # resilience_chaos_injected{site=} must count injections that FIRED
    # (every publishing rank taking it would over-count the fleet total,
    # and a 1-rank world would count a perturbation that cannot exist)
    can_perturb = (
        prank == psize - 1 if psize > 1 else world > 1
    )
    diverge = (
        can_perturb and chaos.enabled() and chaos.take_schedule_diverge(step)
    )
    blob = json.dumps(record_dict, separators=(",", ":")).encode()
    if _metrics.enabled():
        _metrics.counter(
            "sanitizer_ops_recorded",
            help="eager collective signatures folded into the schedule "
                 "sanitizer ring",
        ).inc(record_dict["n"])
    if psize > 1:
        if diverge:
            record_dict = _perturb(record_dict)
            blob = json.dumps(record_dict, separators=(",", ":")).encode()
        # the flight ring keeps this rank's per-step schedule hash (the
        # perturbed one when the chaos charge fired — that IS what this
        # rank "dispatched"): offline hang forensics cross-checks these
        # to tell "rank missing" from "schedules diverged"
        _flight_sched(step, record_dict)
        store.put(schedule_key(step, prank), blob, ttl=ttl)
        return
    _flight_sched(step, record_dict)
    victim = world - 1 if diverge else None
    perturbed = (
        json.dumps(_perturb(record_dict), separators=(",", ":")).encode()
        if victim is not None else None
    )
    for r in range(max(1, world)):
        store.put(
            schedule_key(step, r),
            perturbed if r == victim else blob,
            ttl=ttl,
        )


def _flight_sched(step: int, record_dict: dict) -> None:
    try:
        from horovod_tpu_torch.observability import flight as _flight

        _flight.record(
            "sched", step=int(step), hash=record_dict["hash"][:16],
            n=record_dict["n"], gen=_generation(),
        )
    except Exception as e:
        import logging

        logging.getLogger("horovod_tpu_torch").debug(
            "flight sched event skipped: %s", e)


def _perturb(record_dict: dict) -> dict:
    """The chaos divergence: rename the first op (or invent one in an
    empty step) and re-roll the hash, as if the victim rank had dispatched
    a different collective first."""
    ops = [list(o) for o in record_dict["ops"]]
    if ops:
        ops[0] = [str(ops[0][0]) + "!chaos", ops[0][1], ops[0][2]]
    else:
        ops = [["allreduce!chaos", "data", [[[1], "float32"]]]]
    h = hashlib.sha256()
    for sig in ops:
        h.update(json.dumps(sig, separators=(",", ":")).encode())
    return {
        "hash": h.hexdigest(),
        "n": max(1, record_dict["n"]),
        "dropped": record_dict.get("dropped", 0),
        "ops": ops,
    }


def _first_divergent_op(ours: dict, theirs: dict) -> Tuple[int, str]:
    """(index, description) of the first op the two records disagree on."""
    for i, (a, b) in enumerate(zip(ours["ops"], theirs["ops"])):
        if a != b:
            return i, f"{b[0]} (rank's op {i}; coordinator saw {a[0]})"
    na, nb = ours["n"], theirs["n"]
    i = min(len(ours["ops"]), len(theirs["ops"]))
    if nb > na:
        extra = theirs["ops"][i][0] if i < len(theirs["ops"]) else "?"
        return i, f"{extra} (rank issued {nb - na} extra op(s) from {i})"
    if na > nb:
        missing = ours["ops"][i][0] if i < len(ours["ops"]) else "?"
        return i, f"{missing} (rank missing {na - nb} op(s) from {i})"
    return i, "schedules hash-diverge past the diagnostic ring"


def cross_check(step: int) -> Optional[dict]:
    """Rank 0: compare every rank's published record for `step` against
    our own; on the first mismatch name the divergent rank and op, count
    ``sanitizer_schedule_divergence{rank=}``, and strike the health
    machine (SUSPECT names the rank + op). A step with a peer whose
    publication has not landed yet is NOT dropped: it is remembered and
    re-checked at the next :data:`PENDING_CHECK_ATTEMPTS` step
    boundaries (rank 0 reaching the boundary before a peer's KV put is
    the common race in a real multi-process job — the divergent rank is
    often the *slow* one). A peer still missing after the retry budget
    is the straggler/heartbeat layers' business, not a schedule
    verdict."""
    global _last_divergence
    world, prank, psize = _identity()
    if _world_override is not None:
        world = _world_override
    if prank != 0:
        return None
    store = _store()
    mine_blob = store.get(schedule_key(step, 0))
    if mine_blob is None:
        return None
    try:
        mine = json.loads(mine_blob)
    except ValueError:
        return None
    checked = False
    missing = False
    divergence: Optional[dict] = None
    ranks = range(1, max(1, world if psize == 1 else psize))
    for r in ranks:
        blob = store.get(schedule_key(step, r))
        if blob is None:
            missing = True  # not published yet: defer, don't drop
            continue
        try:
            theirs = json.loads(blob)
        except ValueError:
            continue
        checked = True
        if theirs.get("hash") == mine.get("hash"):
            continue
        idx, op_desc = _first_divergent_op(mine, theirs)
        divergence = {
            "step": step,
            "rank": r,
            "op_index": idx,
            "op": op_desc,
            "expected_n": mine.get("n"),
            "got_n": theirs.get("n"),
        }
        break
    with _lock:
        if missing and divergence is None:
            left = _pending_checks.get(step, PENDING_CHECK_ATTEMPTS) - 1
            if left > 0:
                _pending_checks[step] = left
            else:
                _pending_checks.pop(step, None)
        else:
            _pending_checks.pop(step, None)
    if checked and _metrics.enabled():
        _metrics.counter(
            "sanitizer_steps_checked",
            help="steps whose cross-rank schedule hashes rank 0 compared",
        ).inc()
    if divergence is None:
        return None
    _last_divergence = divergence
    if _metrics.enabled():
        _metrics.counter(
            "sanitizer_schedule_divergence",
            help="cross-rank collective-schedule mismatches detected by "
                 "the sanitizer",
            rank=divergence["rank"],
        ).inc()
    from horovod_tpu_torch.resilience import health

    health.record_schedule_divergence(
        divergence["rank"], divergence["op"], step=step,
    )
    return divergence


def last_divergence() -> Optional[dict]:
    """The most recent divergence this process detected, or None."""
    return _last_divergence
