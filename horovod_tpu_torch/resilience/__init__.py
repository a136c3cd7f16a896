"""Resilience: the value-plane guard and the chaos harness that tests it.

Counterpart of ``horovod_tpu/resilience``, as far as the port has it:

- :mod:`~horovod_tpu_torch.resilience.numerics` — the numerics guard:
  per-step gradient/loss finiteness and EWMA norm-spike detection with
  an atomic skip of a BAD step, dynamic loss scaling, the host-side
  verdict readers and the finiteness gate;
- :mod:`~horovod_tpu_torch.resilience.chaos` — the ``HOROVOD_CHAOS``
  spec grammar and the two gradient charges the guard injects.

The preemption loop, elastic training, health and retry are not ported
yet (ROADMAP Queue A item 9).
"""

from horovod_tpu_torch.resilience import chaos, numerics  # noqa: F401
