#!/usr/bin/env python3
"""Where a ResNet-50 step with bucketed overlap spends its time, on one
GPU.

    python3 tools/overlap_probe.py [--steps 6] [--turns 2]

ResNet-50 at full width (``chip_smoke.build_model``), batch 64, int8 +
EF, fused Adam (``chip_smoke.make_tx``), a world of one. Configurations,
each on a fresh model, in turns (the order reversed every turn):

- ``zero1``: ZeRO-1 without overlap (one exchange after the backward);
- ``zero1_ov64``: ZeRO-1 at 64 MiB buckets, started from the backward's
  gradient hooks (``make_train_step``'s hook route);
- ``zero1_ov64_after``: the same optimizer without its ``exchange``, so
  the buckets run after the backward on the caller's stream;
- ``allreduce_ov64``: allreduce mode at 64 MiB from the hooks.

For each: the step times (a host clock around a step that ends in a
device-to-host read of the loss), the caching allocator's counters over
the timed steps (``torch.cuda.memory_stats``: ``cudaMalloc`` and
``cudaFree`` calls, allocation retries) and the peak memory, and a
``torch.profiler`` trace of two more steps: the device time by kernel
(the 12 largest), the host time and count of the CUDA runtime's
``cudaMalloc``/``cudaFree``/synchronisation calls. Prints the card's
name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ("zero1", "zero1_ov64", "zero1_ov64_after", "allreduce_ov64")
MIB64 = 64 << 20
RUNTIME_CALLS = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize",
                 "cudaDeviceSynchronize", "cudaEventSynchronize",
                 "cudaStreamWaitEvent")


def build(config: str):
    import horovod_tpu_torch as hvd

    import chip_smoke as S

    mode = config.split("_")[0]
    bb = MIB64 if "ov64" in config else None
    model = S.build_model("resnet50", 0, hvd.device())
    tx = S.make_tx(mode, 1e-3, bb)
    if config.endswith("_after"):
        tx = tx._replace(exchange=None)
    step = hvd.make_train_step(model, tx, shard_optimizer=mode == "zero1")
    return step, tx.init(model.jax_params())


def profile(step, st, x, y) -> tuple:
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            st, loss = step(st, x, y)
            float(loss)
    torch.cuda.synchronize()
    rows = p.key_averages()

    def device_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0)

    kernels = sorted(((e.key, device_us(e) / 2e3, e.count / 2) for e in rows
                      if device_us(e) > 0), key=lambda t: -t[1])[:12]
    runtime = {e.key: dict(calls=e.count / 2, host_ms=e.cpu_time_total / 2e3)
               for e in rows if e.key in RUNTIME_CALLS}
    return st, dict(device_ms_by_kernel=[
        dict(name=k[:80], ms=ms, calls=c) for k, ms, c in kernels],
        runtime_a_step=runtime)


def run(config: str, steps: int, x, y) -> dict:
    import torch

    step, st = build(config)
    st, loss = step(st, x, y)           # warm-up (cuDNN autotuning)
    float(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_stats()
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        st, loss = step(st, x, y)
        float(loss)
        times.append(time.perf_counter() - t0)
    after = torch.cuda.memory_stats()
    alloc = {k: after.get(k, 0) - before.get(k, 0)
             for k in ("num_device_alloc", "num_device_free",
                       "num_alloc_retries")}
    out = dict(step_s=times, median_step_s=sorted(times)[len(times) // 2],
               img_per_s=x.shape[0] * len(times) / sum(times),
               allocator_over_steps=alloc,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    st, trace = profile(step, st, x, y)
    ex = getattr(step, "last_exchange", None)
    for h in getattr(step, "hooks", []):
        h.remove()
    out.update(trace, buckets=None if ex is None else len(ex.order))
    del step, st
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    if not torch.cuda.is_available():
        sys.exit("overlap_probe: needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

    _build.build_all()
    hvd.init()
    try:
        torch.backends.cudnn.allow_tf32 = True
        gen = torch.Generator(device=hvd.device()).manual_seed(0)
        x = torch.randn(64, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (64,), device=hvd.device(), generator=gen)
        res: dict = {c: [] for c in CONFIGS}
        for turn in range(args.turns):
            order = CONFIGS if turn % 2 == 0 else tuple(reversed(CONFIGS))
            for c in order:
                res[c].append(run(c, args.steps, x, y))
                print(f"{c} turn {turn}: {res[c][-1]['img_per_s']:.2f} img/s, "
                      f"allocator {res[c][-1]['allocator_over_steps']}",
                      flush=True)
    finally:
        hvd.shutdown()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "steps": args.steps, "runs": res}), flush=True)


if __name__ == "__main__":
    main()
