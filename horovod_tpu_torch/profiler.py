"""Device tracing and peak-rate tables, on ``torch.profiler``.

Counterpart of ``horovod_tpu/profiler.py``. Two layers show where a step
goes:

- the **negotiation timeline**: the native core writes chrome://tracing
  JSON of its enqueue/negotiate/execute phases to ``HOROVOD_TIMELINE``,
  and :mod:`~horovod_tpu_torch.observability.trace` merges the host spans
  into it (:func:`horovod_tpu_torch.basics.flush_timeline`);
- the **device timeline** (this module): :func:`timeline` runs
  ``torch.profiler`` over the CPU and, when CUDA is available, the GPU
  (CUPTI), and writes its Chrome trace to ``<log_dir>/trace.json``: the
  kernels by their symbols, the NCCL calls, the copies.

:func:`annotate` names a host range in both that trace
(``record_function``) and Nsight's (an NVTX range, on the card).
:func:`device_peak_flops` / :func:`device_peak_hbm_bytes` are the
denominators of ``train_mfu``: NVIDIA parts only, from their published
datasheets; an untabled device (the CPU) gives None.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

__all__ = [
    "start_timeline",
    "stop_timeline",
    "timeline",
    "annotate",
    "timed_steps",
    "device_peak_flops",
    "device_peak_hbm_bytes",
]

_active: Optional[tuple] = None     # (profiler, log_dir)


def start_timeline(log_dir: str) -> None:
    """Begin a ``torch.profiler`` capture that :func:`stop_timeline`
    writes into ``log_dir`` (call it on the rank whose trace you want)."""
    global _active
    if _active is not None:
        raise RuntimeError(f"timeline already active in {_active[1]}")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _active = (prof, log_dir)


def stop_timeline() -> str:
    """Stop the capture and write ``<log_dir>/trace.json``; returns its
    path."""
    global _active
    if _active is None:
        raise RuntimeError("no active timeline; call start_timeline first")
    (prof, log_dir), _active = _active, None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def timeline(log_dir: str):
    """Context-manager spelling::

        with hvd.profiler.timeline("trace_dir"):
            train_steps()
        # the trace is trace_dir/trace.json
    """
    start_timeline(log_dir)
    try:
        yield log_dir
    finally:
        stop_timeline()


@contextlib.contextmanager
def annotate(name: str):
    """A named host range in the ``torch.profiler`` trace and, on the
    card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


#: dense bf16 tensor-core FLOP/s, keyed by substrings of the lower-cased
#: ``torch.cuda.get_device_name()``: H100 SXM5 (sold as "H100 80GB
#: HBM3"), H100 PCIe, A100
_PEAK_BF16_FLOPS = (
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
    ("h100 pcie", 756e12),
    ("a100", 312e12),
)

#: HBM bytes/s, same keys
_PEAK_HBM_BYTES = (
    ("h100 80gb hbm3", 3.35e12),
    ("h100 sxm", 3.35e12),
    ("h100 pcie", 2.0e12),
    ("a100-sxm4-80gb", 2.039e12),
    ("a100", 1.555e12),
)


def timed_steps(run_one, n_steps: int, *, lag: int = 2):
    """Time ``n_steps`` calls of ``run_one()`` with a lagged device→host
    fence; returns ``(fenced_values, dt_seconds)``. ``run_one`` runs one
    step and returns a scalar tensor (the loss) that depends on the
    previous step's state: reading each ``lag`` steps late keeps the card
    busy while the host waits, and the final drain waits for the whole
    chain before the clock stops."""
    import collections
    import time

    fenced = []
    in_flight = collections.deque()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        in_flight.append(run_one())
        if len(in_flight) > lag:
            fenced.append(float(in_flight.popleft()))
    while in_flight:
        fenced.append(float(in_flight.popleft()))
    return fenced, time.perf_counter() - t0


def _lookup_peak(table, device_kind: Optional[str]) -> Optional[float]:
    if device_kind is None:
        if not torch.cuda.is_available():
            return None
        device_kind = torch.cuda.get_device_name(0)
    kind = device_kind.lower()
    for key, peak in table:
        if key in kind:
            return peak
    return None


def device_peak_flops(device_kind: Optional[str] = None) -> Optional[float]:
    """Peak dense bf16 FLOP/s of a device name (default: GPU 0's), or
    None for an untabled one (the CPU): callers skip MFU then."""
    return _lookup_peak(_PEAK_BF16_FLOPS, device_kind)


def device_peak_hbm_bytes(device_kind: Optional[str] = None
                          ) -> Optional[float]:
    """Published HBM bandwidth in bytes/s (None when untabled), looked up
    as :func:`device_peak_flops` does."""
    return _lookup_peak(_PEAK_HBM_BYTES, device_kind)
