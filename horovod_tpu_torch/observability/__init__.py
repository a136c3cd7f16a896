"""Metrics for horovod_tpu_torch.

Counterpart of ``horovod_tpu/observability``, as far as the port has it:
:mod:`~horovod_tpu_torch.observability.metrics`, the process-local
registry of counters, gauges and histograms that health, retry, chaos,
the preemption loop and the elastic driver count through. stdlib-only.
The exporters, the trace, the flight ring, the clock and the straggler
attribution wait for the observability port (ROADMAP Queue A item 11).
"""

from horovod_tpu_torch.observability import metrics  # noqa: F401
