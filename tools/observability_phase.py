#!/usr/bin/env python3
"""Run phase 20 of ``chip_smoke.py`` (observability and analysis) alone.

    python3 tools/observability_phase.py            # the one-GPU part
    python3 tools/observability_phase.py --gpus 4   # the drills across 4

The one-GPU part is ``chip_smoke.observability_phase()``: ResNet-50
ZeRO-1 plain and instrumented in child processes, its gates and both
runs' ms a step. With ``--gpus N`` it is ``chip_smoke.drills_gpus(N)``:
the hang drill and the corrupt-rank drill, each one elastic world of N
processes, with their detection latencies. Builds the two kernel
libraries the path needs first; prints the card's name and power limit,
then one JSON line; needs a GPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    from horovod_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        cs.fail("phase 20 needs a GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(["int8_wire", "fused_adam"])
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    if len(sys.argv) > 2 and sys.argv[1] == "--gpus":
        out = cs.drills_gpus(int(sys.argv[2]))
    else:
        out = cs.observability_phase()
    print(json.dumps(out), flush=True)
    print(f"phase {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
