"""Env-gated fault injection (``HOROVOD_CHAOS=...``) — deterministic chaos.

Counterpart of ``horovod_tpu/resilience/chaos.py``, copied whole: one
grammar, every charge's accessor. Consumers in the port: the numerics
guard (``grad_nan_at_step``, ``grad_spike_at_step``), the eager dispatch
guard of :mod:`horovod_tpu_torch.ops.collective` (``collective_fail``,
``collective_delay``), the preemption loop (``sigterm_at_step``) and the
elastic driver (``rank_fail``, ``rank_fail_at_step``,
``rank_join_at_step``), the serving plane (:mod:`horovod_tpu_torch.
serving`: ``publish_fail`` and ``kv_restart_at_step`` in the publisher,
``subscriber_stall`` in the subscriber, ``request_burst``,
``cache_evict_at_pass`` and ``slow_decode`` in the engine,
``replica_kill`` and ``replica_stale`` in the fleet), the
observability planes, and the input plane (``data_stall`` in
:class:`~horovod_tpu_torch.data.ResumableLoader`'s producer,
``shard_corrupt`` in :class:`~horovod_tpu_torch.data.ArrayShardStore`).
Besides the metrics counter, each
injection is counted in :data:`injected` (site -> count).

Every recovery path in this package is only trustworthy if tier-1 can
exercise it on CPU, so the harness injects faults *deterministically*
(counted, not sampled): "drop the first N KV requests" reproduces bit-for-bit
where "drop 10% of requests" flakes.

Grammar — comma-separated ``key=value`` pairs::

    HOROVOD_CHAOS="kv_drop=2,collective_delay=0.05,sigterm_at_step=3"

Supported keys (unknown keys raise ``ValueError`` at parse time so typos
fail loudly, not silently inject nothing):

- ``kv_drop=N`` — fail the first N rendezvous KV client requests with
  ``ConnectionRefusedError`` (the server-startup race, on demand).
- ``collective_fail=N`` — fail the first N eager collective launches with
  :class:`~horovod_tpu_torch.resilience.retry.TransientError` (the XLA:CPU
  rendezvous-abort class of failure).
- ``collective_delay=S`` — sleep S seconds before every eager collective
  launch (keep ≤ 0.2 in tier-1 tests).
- ``sigterm_at_step=K`` — have :func:`horovod_tpu_torch.resilience.run` deliver a
  real ``SIGTERM`` to this process just before step K (0-based), driving
  the full preempt → drain → emergency-checkpoint path.
- ``rank_fail=N`` — have the elastic coordinator kill N ranks (highest
  rank ids first, never rank 0): their heartbeats tombstone and the job
  re-forms at the smaller world size. Fires at the step-boundary
  membership sweep of step ``rank_fail_at_step`` (default 1).
- ``rank_fail_at_step=K`` — pin the step (0-based boundary) at which the
  ``rank_fail`` charge fires.
- ``rank_join_at_step=K`` — at step K's boundary, revive every previously
  failed rank: the elastic coordinator re-admits them and grows the world
  back (bounded by ``--max-workers``).
- ``publish_fail=N`` — fail the first N weight-publication attempts
  (:class:`horovod_tpu_torch.serving.WeightPublisher`) with
  :class:`~horovod_tpu_torch.resilience.retry.TransientError` partway through the
  chunk upload, exercising the commit-last ordering: the torn generation is
  never visible and the shared retry policy republishes it.
- ``kv_restart_at_step=K`` — restart the rendezvous KV server at step K's
  publish boundary (``KVStoreServer.restart()``): with a WAL the store
  replays; without one the subscriber must keyframe-resync.
- ``kv_kill_primary_at_step=K`` — SIGKILL-model the **primary** KV server
  at step K's publish boundary (``KVStoreServer.kill()``: socket, WAL
  handle, and ``.lock`` dropped with no graceful teardown): the failover
  drill — a standby must promote, clients must reconnect within their
  original deadlines, and the promoted state must be byte-identical to
  the dead primary's WAL. Consumed by the publisher driving the drill
  (``WeightPublisher.chaos_primary``, falling back to its own store).
- ``kv_partition=<s>`` — blackhole the client's **first-listed** KV
  endpoint (the original primary) for `s` seconds: every request to it
  fails like a refused connection, forcing the multi-endpoint failover
  path without killing the server. The window opens at the first consult
  and self-clears; each dropped request is counted.
- ``subscriber_stall=S`` — sleep S seconds before every subscriber poll
  (keep ≤ 0.2 in tier-1 tests), forcing the catch-up/lag path.
- ``request_burst=N`` — slam N synthetic generation requests into the
  serving engine's queue at one iteration boundary
  (:meth:`horovod_tpu_torch.serving.engine.InferenceEngine.step`), driving the
  queue-overflow admission-control path
  (``serving_admission_rejected{reason=queue_full}``). Fires once.
- ``cache_evict_at_pass=K`` — at the engine's K-th iteration boundary,
  force-evict the serving prefix cache: every refcount-0 cached page is
  dropped AND live sequences aliasing shared pages swap them for fresh
  owned pages and re-prefill from position 0
  (:meth:`horovod_tpu_torch.serving.scheduler.ContinuousBatchingScheduler
  .chaos_evict`) — the drill pins that a forced eviction mid-flight
  rewrites the same KV and the victim's tokens stay bit-identical.
  Fires once.
- ``rank_slow=<rank>:<seconds>`` — make `rank` arrive `seconds` late at
  every eager collective (the deterministic straggler): in a multi-process
  job the matching process sleeps before each dispatch; on the
  single-controller SPMD mesh the sleep happens in the one dispatching
  process and the delay is attributed to `rank`'s simulated arrival
  (:mod:`horovod_tpu_torch.observability.straggler`). Persistent, like
  ``collective_delay``; keep ≤ 0.2 in tier-1 tests.
- ``schedule_diverge_at_step=K`` — at step K's publish boundary, the
  schedule sanitizer (``HOROVOD_SANITIZE=1``,
  :mod:`horovod_tpu_torch.analysis.sanitizer`) perturbs the highest rank's
  published collective-schedule record (never rank 0, like
  ``rank_fail``), so rank 0's cross-check must name that rank and the
  first divergent op. Fires once.
- ``grad_nan_at_step=K`` — the numerics guard
  (:mod:`horovod_tpu_torch.resilience.numerics`) multiplies the gradient tree
  by NaN on its K-th guarded update (0-based, the guard's own step
  counter). The guard compares its counter with K on the device at every
  update, so the finiteness detector is exercised for real; the charge is consumed host-side by
  :func:`numerics.note_step` once the guard's counter has passed K.
- ``grad_spike_at_step=K:<scale>`` — same mechanism, multiplying the
  gradients by ``<scale>`` (default 1e3) instead of NaN, so the EWMA
  global-norm spike detector trips while every value stays finite.
- ``rank_hang_at_step=K`` — the hung-rank drill
  (:mod:`horovod_tpu_torch.observability.flight`): the highest rank (never
  rank 0; in a multi-process job the highest process rank) *stops
  dispatching* mid-step — from step K's second collective on — really
  holding the dispatching thread so the ``HOROVOD_HANG_TIMEOUT``
  watchdog fires for real. Single-controller: the victim's flight
  record/sidecar/KV-tail view is frozen *before* the parked collective
  (it stays "missing at (step, gen, seq)" even after the drill resumes,
  so live AND offline ``tools/hvd_blackbox.py`` diagnosis agree), and
  the in-process live diagnosis releases the hold early. Multi-process:
  the victim holds the full ``rank_hang_hold`` budget (the release
  signal is process-local to rank 0) and then resumes, so its
  post-drill record shows recovery — for a dead-process offline drill,
  SIGKILL the victim mid-hold. Consumed only by the process that hangs.
- ``rank_hang_hold=S`` — bound on how long the ``rank_hang_at_step``
  victim holds, default 5.0 (keeps the drill from wedging a run).
- ``grad_corrupt_rank=<r>:<step>`` — at `step`'s fingerprint boundary,
  rank `r`'s published per-dtype gradient fingerprint is perturbed to a
  non-finite record (single-controller: the dispatching process writes
  the perturbed copy for `r`; multi-process: the matching process
  perturbs its own). Rank 0's cross-check must name `r` within one
  step; like ``schedule_diverge_at_step``, the charge is consumed only
  by the process that actually perturbs — a 1-rank world leaves it
  armed.
- ``data_stall=<rank>:<seconds>`` — `rank`'s input pipeline stalls
  `seconds` before producing every batch (the deterministic slow-disk:
  in a multi-process job the matching process's loader really sleeps;
  single-controller, the one loader sleeps and the wait is *attributed*
  to `rank`'s simulated input pipeline, the ``rank_slow`` convention),
  so straggler attribution must name the rank **input-bound** — not
  compute-bound — and the prefetch watchdog must detect the stall.
  Persistent, like ``rank_slow``; the loader
  (:class:`horovod_tpu_torch.data.ResumableLoader`) owns the sleep and calls
  :func:`record_injection` per application.
- ``shard_corrupt=<shard>:<k>`` — from its `k`-th read (0-based) on,
  data shard `<shard>`'s bytes come back corrupted (CRC mismatch), so
  the store's retry → quarantine → degrade-don't-crash path runs for
  real (:class:`horovod_tpu_torch.data.ArrayShardStore`). Persistent from
  read `k` (a transiently corrupt read would be healed by the retry and
  prove nothing); applied — and counted per corrupted read — by the
  reading process.
- ``slow_decode=<seconds>[:<arm>[@<replica>]]`` — the serving engine
  sleeps `seconds` before every prefill/decode pass, optionally scoped
  to one rollout arm (``slow_decode=0.05:canary`` slows ONLY the
  canary arm and its drain labels) and, with an ``@<replica>`` suffix,
  to one fleet replica's engine (``slow_decode=0.05:canary@r1``) — the
  deterministic latency regression: TTFT and TPOT burn on the scoped
  arm only, the SLO gate (:mod:`horovod_tpu_torch.observability.slo`)
  auto-rolls the canary back, and ``/health`` names the burning
  objective. Tokens are unaffected (the sleep is host-side), so a
  rolled-back drill keeps token parity with a clean run. Persistent,
  like ``rank_slow``; the engine owns the sleep and calls
  :func:`record_injection` per applied pass; keep ≤ 0.2 in tier-1
  tests.
- ``replica_kill=<i>[:<at_pump>]`` — the fleet router
  (:class:`horovod_tpu_torch.serving.fleet.FleetRouter`) kills serving
  replica index `i` at its `at_pump`-th pump boundary (default 1): the
  replica's lease is tombstoned, its in-flight sequences are abandoned
  mid-decode, and the router must re-route every stranded request with
  exactly-once completion. Consumed when it fires.
- ``replica_stale=<i>:<seconds>`` — fleet replica index `i` reports
  its subscriber `seconds` stale regardless of what it actually
  applied, driving the PR-12 staleness→health path (503, DEGRADED) and
  the router's last-resort demotion without having to wedge a real
  publisher. Persistent; the replica's status publisher calls
  :func:`record_injection` per published status.

Each injection increments ``resilience_chaos_injected{site=...}`` so tests
(and operators running a game-day) can assert the fault actually fired.

stdlib-only. Configuration is lazy: the env is parsed on first query;
:func:`configure` overrides it programmatically and :func:`reset` returns
to env-driven (tests use both).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional, Union

from horovod_tpu_torch.observability import metrics as _metrics
from horovod_tpu_torch.resilience.retry import TransientError

__all__ = [
    "CHAOS_ENV",
    "parse_spec",
    "configure",
    "reset",
    "enabled",
    "should_fail",
    "maybe_delay",
    "sigterm_at_step",
    "take_rank_fail",
    "take_rank_join",
    "take_kv_restart",
    "take_kv_kill_primary",
    "kv_partition_active",
    "take_request_burst",
    "take_cache_evict",
    "take_schedule_diverge",
    "rank_slow",
    "grad_nan_step",
    "consume_grad_nan",
    "grad_spike",
    "consume_grad_spike",
    "grad_corrupt",
    "consume_grad_corrupt",
    "rank_hang_step",
    "rank_hang_hold",
    "consume_rank_hang",
    "data_stall",
    "shard_corrupt",
    "slow_decode",
    "take_replica_kill",
    "replica_stale",
    "record_injection",
    "injected",
]

CHAOS_ENV = "HOROVOD_CHAOS"

#: count-consuming sites (value = how many times the fault fires)
_COUNT_KEYS = ("kv_drop", "collective_fail", "publish_fail")
#: float-valued knobs
_FLOAT_KEYS = (
    "collective_delay",
    "subscriber_stall",
    "rank_hang_hold",
    "kv_partition",
)
#: int-valued knobs
_INT_KEYS = (
    "sigterm_at_step",
    "rank_fail",
    "rank_fail_at_step",
    "rank_join_at_step",
    "kv_restart_at_step",
    "kv_kill_primary_at_step",
    "schedule_diverge_at_step",
    "grad_nan_at_step",
    "request_burst",
    "rank_hang_at_step",
    "cache_evict_at_pass",
)
#: structured knobs with their own value grammar
_STRUCT_KEYS = (
    "rank_slow",
    "grad_spike_at_step",
    "grad_corrupt_rank",
    "data_stall",
    "shard_corrupt",
    "slow_decode",
    "replica_kill",
    "replica_stale",
)

_lock = threading.Lock()
_config: Optional[Dict[str, Union[int, float]]] = None  # None = read env
#: injections counted per site since the process started (or
#: :func:`reset`), what ``resilience_chaos_injected{site=}`` counts while
#: the metrics are enabled
injected: Dict[str, int] = {}


def parse_spec(spec: str) -> Dict[str, Union[int, float]]:
    """``"kv_drop=2,collective_delay=0.05"`` → ``{"kv_drop": 2, ...}``."""
    out: Dict[str, Union[int, float]] = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        key, sep, value = item.partition("=")
        key = key.strip()
        if not sep:
            raise ValueError(
                f"{CHAOS_ENV}: expected key=value, got {item!r}"
            )
        if key in _COUNT_KEYS or key in _INT_KEYS:
            out[key] = int(value)
        elif key in _FLOAT_KEYS:
            out[key] = float(value)
        elif key in ("rank_slow", "data_stall"):
            rank_s, sep2, sec_s = value.partition(":")
            if not sep2:
                raise ValueError(
                    f"{CHAOS_ENV}: {key} expects <rank>:<seconds>, "
                    f"got {value!r}"
                )
            out[key] = (int(rank_s), float(sec_s))
        elif key == "shard_corrupt":
            shard_s, sep2, at_s = value.partition(":")
            out[key] = (int(shard_s), int(at_s) if sep2 and at_s else 0)
        elif key == "slow_decode":
            sec_s, sep2, arm_s = value.partition(":")
            out[key] = (float(sec_s),
                        arm_s.strip() if sep2 and arm_s.strip() else None)
        elif key == "replica_kill":
            idx_s, sep2, at_s = value.partition(":")
            out[key] = (int(idx_s),
                        int(at_s) if sep2 and at_s.strip() else 1)
        elif key == "replica_stale":
            idx_s, sep2, sec_s = value.partition(":")
            if not sep2:
                raise ValueError(
                    f"{CHAOS_ENV}: replica_stale expects "
                    f"<replica>:<seconds>, got {value!r}"
                )
            out[key] = (int(idx_s), float(sec_s))
        elif key == "grad_spike_at_step":
            step_s, _sep2, scale_s = value.partition(":")
            out[key] = (int(step_s), float(scale_s) if scale_s else 1e3)
        elif key == "grad_corrupt_rank":
            rank_s, sep2, step_s = value.partition(":")
            if not sep2:
                raise ValueError(
                    f"{CHAOS_ENV}: grad_corrupt_rank expects "
                    f"<rank>:<step>, got {value!r}"
                )
            out[key] = (int(rank_s), int(step_s))
        else:
            known = ", ".join(
                _COUNT_KEYS + _FLOAT_KEYS + _INT_KEYS + _STRUCT_KEYS
            )
            raise ValueError(
                f"{CHAOS_ENV}: unknown chaos site {key!r} (known: {known})"
            )
    return out


def configure(spec: Union[str, Dict[str, Union[int, float]], None]) -> None:
    """Set the active chaos config programmatically (a spec string or a
    parsed dict); ``configure(None)`` disables chaos entirely regardless of
    the env (distinct from :func:`reset`, which re-reads the env)."""
    global _config, _kv_partition_t0
    with _lock:
        if spec is None:
            _config = {}
        elif isinstance(spec, str):
            _config = parse_spec(spec)
        else:
            _config = dict(spec)
        _kv_partition_t0 = None


def reset() -> None:
    """Forget programmatic config and the injection counts; the env is
    re-parsed on next query."""
    global _config, _kv_partition_t0
    with _lock:
        _config = None
        _kv_partition_t0 = None
        injected.clear()


def _active() -> Dict[str, Union[int, float]]:
    global _config
    with _lock:
        if _config is None:
            _config = parse_spec(os.environ.get(CHAOS_ENV, ""))
        return _config


def enabled() -> bool:
    return bool(_active())


def _record(site: str) -> None:
    with _lock:
        injected[site] = injected.get(site, 0) + 1
    if _metrics.enabled():
        _metrics.counter(
            "resilience_chaos_injected",
            help="faults injected by the chaos harness",
            site=site,
        ).inc()
    try:
        # the flight ring keeps injections in the post-mortem record: a
        # crash AFTER a chaos charge fired must be attributable to it
        from horovod_tpu_torch.observability import flight as _flight

        _flight.record("chaos", site=site)
    except Exception as e:
        import logging

        logging.getLogger("horovod_tpu_torch.resilience").debug(
            "flight chaos event skipped: %s", e)


def should_fail(site: str) -> bool:
    """Consume one charge of a counted fault at `site`; True while charges
    remain. Thread-safe (concurrent dispatchers never double-spend)."""
    cfg = _active()
    with _lock:
        remaining = int(cfg.get(site, 0))
        if remaining <= 0:
            return False
        cfg[site] = remaining - 1
    _record(site)
    return True


def inject_failure(site: str, exc_factory=None) -> None:
    """Raise at `site` while charges remain (default
    :class:`TransientError`); no-op otherwise."""
    if should_fail(site):
        raise (exc_factory or TransientError)(
            f"chaos: injected fault at {site}"
        )


def maybe_delay(site: str = "collective_delay") -> None:
    """Sleep the configured delay for `site` (no-op when unset)."""
    delay = float(_active().get(site, 0.0))
    if delay > 0:
        _record(site)
        time.sleep(delay)


def rank_slow():
    """The armed ``(rank, seconds)`` straggler charge, or None. NOT
    consumed on read — the charge applies to every eager collective, like
    ``collective_delay`` (persistent stragglers are the detection target).
    The applier (:func:`horovod_tpu_torch.observability.straggler
    .collective_begin`) owns the sleep and calls
    :func:`record_injection` per application."""
    v = _active().get("rank_slow")
    if v is None:
        return None
    return int(v[0]), float(v[1])


def data_stall():
    """The armed ``(rank, seconds)`` input-stall charge, or None. NOT
    consumed on read — the charge applies to every produced batch, like
    ``rank_slow`` (persistent input-side stragglers are the detection
    target). The applier (:class:`horovod_tpu_torch.data.ResumableLoader`'s
    producer) owns the sleep and calls :func:`record_injection` per
    application."""
    v = _active().get("data_stall")
    if v is None:
        return None
    return int(v[0]), float(v[1])


def shard_corrupt():
    """The armed ``(shard, from_read)`` shard-corruption charge, or None.
    NOT consumed on read — corruption is persistent from the shard's
    ``from_read``-th read onward (a one-shot corrupt read would be healed
    by the retry layer and never reach quarantine). The applier
    (:class:`horovod_tpu_torch.data.ArrayShardStore`) calls
    :func:`record_injection` per corrupted read."""
    v = _active().get("shard_corrupt")
    if v is None:
        return None
    return int(v[0]), int(v[1])


def slow_decode():
    """The armed ``(seconds, arm_or_None)`` serving-latency charge, or
    None. NOT consumed on read — the charge applies to every engine
    prefill/decode pass (persistent latency regressions are the
    detection target, like ``rank_slow``). ``arm_or_None`` scopes the
    sleep to one rollout arm (and its drain labels); None slows every
    arm. The applier (:class:`horovod_tpu_torch.serving.engine
    .InferenceEngine`) owns the sleep and calls
    :func:`record_injection` per applied pass."""
    v = _active().get("slow_decode")
    if v is None:
        return None
    return float(v[0]), (None if v[1] is None else str(v[1]))


def take_replica_kill(pump: int) -> Optional[int]:
    """Index of the serving replica the fleet router should kill at
    `pump`'s boundary, or None when the charge is unarmed or its pump
    has not arrived (default boundary 1). Consumed on a non-None return
    (fires once) — like ``rank_fail``, but aimed at the serving fleet
    instead of the training collective."""
    cfg = _active()
    with _lock:
        v = cfg.get("replica_kill")
        if v is None or pump < int(v[1]):
            return None
        cfg.pop("replica_kill", None)
    _record("replica_kill")
    return int(v[0])


def replica_stale():
    """The armed ``(replica, seconds)`` forced-staleness charge, or
    None. NOT consumed on read — staleness is a persistent condition
    until the charge is cleared (a one-pump stale blip would never trip
    the health watermark). The applier
    (:class:`horovod_tpu_torch.serving.fleet.FleetReplica`) calls
    :func:`record_injection` per published status."""
    v = _active().get("replica_stale")
    if v is None:
        return None
    return int(v[0]), float(v[1])


def record_injection(site: str) -> None:
    """Count one applied injection at `site`
    (``resilience_chaos_injected{site=}``) — for appliers that implement
    the fault themselves rather than through :func:`inject_failure` /
    :func:`maybe_delay`."""
    _record(site)


def sigterm_at_step() -> Optional[int]:
    """The step index before which ``resilience.run`` should deliver a fake
    preemption SIGTERM, or None. Consumed on read (fires once)."""
    cfg = _active()
    with _lock:
        step = cfg.get("sigterm_at_step")
        return None if step is None else int(step)


def consume_sigterm() -> None:
    """Mark the configured fake SIGTERM as delivered (fires once)."""
    cfg = _active()
    with _lock:
        cfg.pop("sigterm_at_step", None)
    _record("sigterm_at_step")


def take_rank_fail(step: int) -> int:
    """Number of ranks the elastic coordinator should kill at `step`'s
    boundary (0 when the charge is unarmed or its step has not arrived).
    Consumed on a nonzero return (fires once)."""
    cfg = _active()
    with _lock:
        n = int(cfg.get("rank_fail", 0))
        at = int(cfg.get("rank_fail_at_step", 1))
        if n <= 0 or step < at:
            return 0
        cfg.pop("rank_fail", None)
        cfg.pop("rank_fail_at_step", None)
    _record("rank_fail")
    return n


def take_kv_restart(step: int) -> bool:
    """True when the rendezvous KV server should be restarted at `step`'s
    publish boundary (0 when unarmed or the step has not arrived).
    Consumed on True (fires once)."""
    cfg = _active()
    with _lock:
        at = cfg.get("kv_restart_at_step")
        if at is None or step < int(at):
            return False
        cfg.pop("kv_restart_at_step", None)
    _record("kv_restart_at_step")
    return True


def take_kv_kill_primary(step: int) -> bool:
    """True when the primary rendezvous KV server should be
    SIGKILL-modeled (``KVStoreServer.kill()``) at `step`'s publish
    boundary (False when unarmed or the step has not arrived). Consumed
    on True (fires once) — the control-plane failover drill."""
    cfg = _active()
    with _lock:
        at = cfg.get("kv_kill_primary_at_step")
        if at is None or step < int(at):
            return False
        cfg.pop("kv_kill_primary_at_step", None)
    _record("kv_kill_primary_at_step")
    return True


#: monotonic time the kv_partition window opened (None = not yet consulted)
_kv_partition_t0: Optional[float] = None


def kv_partition_active() -> bool:
    """True while the ``kv_partition`` window is open: the KV client must
    drop requests to its first-listed endpoint (the original primary).
    The window opens at the FIRST consult — so it always covers the
    consulting client's next requests regardless of setup time — and
    self-clears after its configured seconds. Each dropped request is
    counted (``site=kv_partition``)."""
    global _kv_partition_t0
    cfg = _active()
    with _lock:
        window = float(cfg.get("kv_partition", 0.0))
        if window <= 0:
            return False
        now = time.monotonic()
        if _kv_partition_t0 is None:
            _kv_partition_t0 = now
        if now - _kv_partition_t0 >= window:
            cfg.pop("kv_partition", None)
            _kv_partition_t0 = None
            return False
    _record("kv_partition")
    return True


def take_request_burst() -> int:
    """Number of synthetic requests the serving engine should inject at
    this iteration boundary (0 when unarmed). Consumed on a nonzero
    return (fires once)."""
    cfg = _active()
    with _lock:
        n = int(cfg.get("request_burst", 0))
        if n <= 0:
            return 0
        cfg.pop("request_burst", None)
    _record("request_burst")
    return n


def take_cache_evict(pass_count: int) -> bool:
    """True when the serving engine should force-evict its prefix cache
    at `pass_count`'s iteration boundary (False when unarmed or the
    pass has not arrived). Consumed on True (fires once)."""
    cfg = _active()
    with _lock:
        at = cfg.get("cache_evict_at_pass")
        if at is None or pass_count < int(at):
            return False
        cfg.pop("cache_evict_at_pass", None)
    _record("cache_evict_at_pass")
    return True


def take_schedule_diverge(step: int) -> bool:
    """True when the schedule sanitizer should perturb the highest rank's
    published record at `step`'s publish boundary (False when unarmed or
    the step has not arrived). Consumed on True (fires once)."""
    cfg = _active()
    with _lock:
        at = cfg.get("schedule_diverge_at_step")
        if at is None or step < int(at):
            return False
        cfg.pop("schedule_diverge_at_step", None)
    _record("schedule_diverge_at_step")
    return True


def grad_nan_step() -> Optional[int]:
    """The guard-counter value at which the numerics guard should inject
    NaN gradients, or None. NOT consumed on read — the guard compares its
    counter with it on the device at every update; the host-side consumer
    (:func:`horovod_tpu_torch.resilience.numerics.note_step`) calls
    :func:`consume_grad_nan` once the guard's counter has passed it."""
    cfg = _active()
    with _lock:
        step = cfg.get("grad_nan_at_step")
        return None if step is None else int(step)


def consume_grad_nan() -> None:
    """Mark the grad-NaN charge as fired (once) and count the injection."""
    cfg = _active()
    with _lock:
        if "grad_nan_at_step" not in cfg:
            return
        cfg.pop("grad_nan_at_step", None)
    _record("grad_nan_at_step")


def grad_spike():
    """The armed ``(step, scale)`` gradient-spike charge, or None. NOT
    consumed on read (like :func:`grad_nan_step`)."""
    v = _active().get("grad_spike_at_step")
    if v is None:
        return None
    return int(v[0]), float(v[1])


def consume_grad_spike() -> None:
    """Mark the grad-spike charge as fired (once) and count the injection."""
    cfg = _active()
    with _lock:
        if "grad_spike_at_step" not in cfg:
            return
        cfg.pop("grad_spike_at_step", None)
    _record("grad_spike_at_step")


def grad_corrupt():
    """The armed ``(rank, step)`` fingerprint-corruption charge, or None.
    NOT consumed on read — only the process that actually perturbs the
    published fingerprint consumes it (:func:`consume_grad_corrupt`), so
    a 1-rank world leaves the charge armed."""
    v = _active().get("grad_corrupt_rank")
    if v is None:
        return None
    return int(v[0]), int(v[1])


def consume_grad_corrupt() -> None:
    """Mark the fingerprint-corruption charge as fired (once)."""
    cfg = _active()
    with _lock:
        if "grad_corrupt_rank" not in cfg:
            return
        cfg.pop("grad_corrupt_rank", None)
    _record("grad_corrupt_rank")


def rank_hang_step() -> Optional[int]:
    """The step at which the hung-rank drill arms, or None. NOT consumed
    on read — every dispatch consults it; only the process that actually
    hangs consumes (:func:`consume_rank_hang`, the ``grad_corrupt``
    convention), so a 1-rank world leaves the charge armed."""
    v = _active().get("rank_hang_at_step")
    return None if v is None else int(v)


def rank_hang_hold() -> float:
    """Bound (seconds) on how long the hung rank holds before resuming —
    the drill must never wedge a test run. Default 5.0."""
    return float(_active().get("rank_hang_hold", 5.0))


def consume_rank_hang() -> None:
    """Mark the hung-rank charge as fired (once) and count the injection."""
    cfg = _active()
    with _lock:
        if "rank_hang_at_step" not in cfg:
            return
        cfg.pop("rank_hang_at_step", None)
    _record("rank_hang_at_step")


def take_rank_join(step: int) -> bool:
    """True when the elastic coordinator should re-admit the failed ranks
    at `step`'s boundary. Consumed on True (fires once)."""
    cfg = _active()
    with _lock:
        at = cfg.get("rank_join_at_step")
        if at is None or step < int(at):
            return False
        cfg.pop("rank_join_at_step", None)
    _record("rank_join_at_step")
    return True
