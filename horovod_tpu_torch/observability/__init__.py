"""Unified metrics & host tracing for horovod_tpu_torch.

Counterpart of ``horovod_tpu/observability``, whole. Ten stdlib-only
modules (importing them starts no device and imports no JAX):

- :mod:`~horovod_tpu_torch.observability.metrics` — process-local registry of
  counters, gauges, and fixed-bucket histograms with labeled children.
  The instrumented layers (the eager ops in ``ops/collective.py``, the
  optimizer's exchanges, the training-step wrapper) feed it; user code
  reads it via ``metrics.snapshot()`` / ``metrics.summary()``.
- :mod:`~horovod_tpu_torch.observability.exporters` — Prometheus text
  exposition + JSON snapshot, and the opt-in rank-0 HTTP endpoint
  (``HOROVOD_METRICS_PORT``) — serving the fleet view at ``/fleet`` /
  ``/fleet.json`` once an aggregator registers.
- :mod:`~horovod_tpu_torch.observability.trace` — host-side chrome-trace span
  recorder (capped ring, ``HOROVOD_TRACE_MAX_SPANS``) that merges
  Python-layer phases into the SAME ``HOROVOD_TIMELINE`` file the native
  core writes; ranks != 0 flush per-rank sidecars for the fleet merge.
- :mod:`~horovod_tpu_torch.observability.clock` — per-rank clock-offset
  estimation against the rendezvous KV server (request/response midpoint)
  and the skew-corrected merge of per-rank trace files.
- :mod:`~horovod_tpu_torch.observability.straggler` — ``(step, generation,
  seq)`` correlation keys on every eager collective, per-rank arrival
  recording, and arrival-spread attribution feeding ``straggler_rank`` +
  the resilience health machine.
- :mod:`~horovod_tpu_torch.observability.aggregate` — the cross-rank metric
  plane: per-rank snapshot publication to the KV (TTL'd) and the rank-0
  fleet aggregator (min/mean/max/p99 across ranks, rank-labeled raw
  series, dead ranks surfaced).
- :mod:`~horovod_tpu_torch.observability.flight` — the black-box flight
  recorder: an always-on bounded ring of structured events (collective
  begin/end with ``(step, gen, seq)``, step boundaries, health
  transitions, chaos injections, elastic epochs, serving admissions)
  checkpointed to a crash-durable per-rank sidecar
  (``HOROVOD_FLIGHT_DIR``), plus the ``HOROVOD_HANG_TIMEOUT`` watchdog
  whose cross-rank diagnosis names the hung rank and collective;
  :func:`~horovod_tpu_torch.observability.flight.analyze_dir` replays the
  same analysis offline from the sidecars.
- :mod:`~horovod_tpu_torch.observability.slo` — declarative SLO objectives
  (``HOROVOD_SLO=ttft_p99<0.5s,...``) with deterministic multi-window
  burn-rate math counted in steps/requests; a burning objective feeds
  the health machine (``record_slo_burn``) and the
  ``slo_burn_rate{objective=}`` / ``slo_budget_remaining{objective=}``
  gauges, and the rollout controller's canary gate judges through the
  same evaluator.
- :mod:`~horovod_tpu_torch.observability.reqtrace` — per-request span
  lifecycle for the serving engine (queue wait, admission, prefill
  chunks, TTFT, TPOT, completion) landing in ``req:<id>`` chrome-trace
  lanes, rid-correlated flight events, and the
  ``reqtrace_*_seconds{arm,outcome,generation}`` histograms + bounded
  per-arm windows the rollout/SLO gates read.
- :mod:`~horovod_tpu_torch.observability.regression` — the
  performance-regression sentinel: warmup-guarded EWMA+MAD rolling
  baselines producing deterministic drift verdicts on step time /
  throughput / data-wait in-process, plus the ``BENCH_*.json`` trend
  differ.

The eager collectives (``ops/collective._record_eager_op``), the step
wrapper (:class:`~horovod_tpu_torch.training.InstrumentedStep`),
``basics.init``/``shutdown``/``flush_timeline``, the preemption loop and
the elastic driver feed them.
"""

from horovod_tpu_torch.observability import (  # noqa: F401
    exporters,
    metrics,
    trace,
    clock,
    straggler,
    aggregate,
    flight,
    slo,
    regression,
    reqtrace,
)
