"""Env-gated fault injection (``HOROVOD_CHAOS=...``), deterministic chaos.

Counterpart of ``horovod_tpu/resilience/chaos.py``, as far as the
numerics guard needs it: the spec grammar (comma-separated
``key=value`` pairs, unknown keys raise) and the two gradient charges:

- ``grad_nan_at_step=K`` — the numerics guard multiplies the gradients
  by NaN on its K-th guarded update (0-based, the guard's own counter);
  consumed by :func:`horovod_tpu_torch.resilience.numerics.note_step`
  once the step reports that it fired;
- ``grad_spike_at_step=K:<scale>`` — the same, multiplying by
  ``<scale>`` (default 1e3), so the EWMA norm-spike check trips while
  every value stays finite.

The grammar parses every key of the JAX package's harness, so a spec
written for it is read here; the other charges have no consumer in the
port yet (ROADMAP Queue A item 9). Each injection is counted in
:data:`injected` (site -> count); the metrics counter and the flight
record wait for the observability port (item 11).

stdlib-only. The env is parsed on first query; :func:`configure`
overrides it and :func:`reset` returns to it.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Union

__all__ = [
    "CHAOS_ENV",
    "parse_spec",
    "configure",
    "reset",
    "enabled",
    "injected",
    "grad_nan_step",
    "consume_grad_nan",
    "grad_spike",
    "consume_grad_spike",
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
#: :func:`reset`), what the JAX package counts in
#: ``resilience_chaos_injected{site=}``
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
    global _config
    with _lock:
        if spec is None:
            _config = {}
        elif isinstance(spec, str):
            _config = parse_spec(spec)
        else:
            _config = dict(spec)


def reset() -> None:
    """Forget programmatic config and the injection counts; the env is
    re-parsed on next query."""
    global _config
    with _lock:
        _config = None
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


def grad_nan_step() -> Optional[int]:
    """The guard-counter value at which the numerics guard injects NaN
    gradients, or None. NOT consumed on read: the guard compares its
    counter with it on the device at every update, and the host-side
    consumer (:func:`horovod_tpu_torch.resilience.numerics.note_step`)
    calls :func:`consume_grad_nan` once a step reports that it fired."""
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
