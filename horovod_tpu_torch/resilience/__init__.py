"""Fault tolerance: classify, retry, or checkpoint — never just die.

Counterpart of ``horovod_tpu/resilience``:

- :mod:`~horovod_tpu_torch.resilience.health` — the process-wide health
  state machine (``HEALTHY → SUSPECT → DEGRADED → FATAL``) fed by the
  native core's cycle/stall signals and the retry layer, exposed through
  ``basics.health_state()`` / ``basics.health()``.
- :mod:`~horovod_tpu_torch.resilience.retry` — the shared
  :class:`~horovod_tpu_torch.resilience.retry.RetryPolicy` (exponential
  backoff + seeded jitter + total deadline) applied to eager collective
  dispatch.
- :mod:`~horovod_tpu_torch.resilience.loop` — the preemption-aware
  training loop :func:`run`: SIGTERM/SIGINT drain in-flight collectives,
  write an emergency checkpoint, and exit with :data:`RESUMABLE_EXIT_CODE`
  (75 = ``EX_TEMPFAIL``), which launchers read as "preempted, retry".
- :mod:`~horovod_tpu_torch.resilience.chaos` — the env-gated
  (``HOROVOD_CHAOS=...``) fault-injection harness that makes all of the
  above deterministically testable on the CPU.
- :mod:`~horovod_tpu_torch.resilience.elastic` — elastic world-size
  training in a world of processes: heartbeat membership with a TTL,
  generation-numbered epochs, process-group re-formation, ZeRO-1 state
  reshard, and rollback to the last committed host snapshot.
- :mod:`~horovod_tpu_torch.resilience.numerics` — the value-plane guard
  (finiteness and norm-spike detection, atomic step skip, dynamic loss
  scaling) and its skip/replay policy.

Everything exported here is stdlib-only at import except
:mod:`numerics`, which imports torch.
"""

from __future__ import annotations

from horovod_tpu_torch.resilience import chaos, elastic, numerics  # noqa: F401
from horovod_tpu_torch.resilience.health import (  # noqa: F401
    HealthMonitor,
    HealthState,
    MONITOR,
    health_state,
)
from horovod_tpu_torch.resilience.loop import (  # noqa: F401
    Preempted,
    RESUMABLE_EXIT_CODE,
    resume_state,
    run,
)
from horovod_tpu_torch.resilience.retry import (  # noqa: F401
    RetryError,
    RetryPolicy,
    TransientError,
    policy_from_env,
)

__all__ = [
    "HealthMonitor",
    "HealthState",
    "MONITOR",
    "health_state",
    "Preempted",
    "RESUMABLE_EXIT_CODE",
    "resume_state",
    "run",
    "RetryError",
    "RetryPolicy",
    "TransientError",
    "policy_from_env",
    "chaos",
    "elastic",
]
