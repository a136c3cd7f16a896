#!/usr/bin/env python3
"""Run phase 21 of ``chip_smoke.py`` (serving) alone.

    python3 tools/serving_phase.py            # phase 21's one-GPU part
    python3 tools/serving_phase.py --gpus 4   # and the TP engine across 4

Builds the kernels, then in a world of one ``chip_smoke.serving_phase``:
(a) the handoff (8 steps of the flagship LM under ``ElasticRun`` with a
publisher, a subscriber over HTTP rebuilding each generation on the
card), (b) the paged engine against ``generate``, (c) the prefix cache,
(d) speculative decoding, (e) the rollout's verdict and the fleet under
``replica_kill``; then replays the delta's one ``quantize`` call against
the plain version (the kernel phase's ``serve_delta`` row). With
``--gpus N``, ``chip_smoke.serving_tp_gpus(N)``: (f), the TP engine over
a ``tp`` axis of N. Prints the phase's lines and one JSON line; needs a
GPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch

    import chip_smoke as S
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import _build

    gpus = int(sys.argv[2]) if len(sys.argv) > 2 and \
        sys.argv[1] == "--gpus" else 1
    if not torch.cuda.is_available():
        S.fail("phase 21 needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    hvd.init()
    try:
        p21, calls, traffic = S.serving_phase(smi)
    finally:
        hvd.shutdown()
    S.print_serving(p21, smi)
    out = {"phase21_s": p21["seconds"]}
    hvd.init()
    try:
        rows = S.kernel_phase({"serve_delta": calls},
                              {k: ("serve_delta",) for k in S.TPU_KERNELS})
    finally:
        hvd.shutdown()
    out["serve_delta"] = rows["quantize"]["by_mode"]["serve_delta"]
    print(f"kernel quantize (serve_delta replay): "
          f"{json.dumps(out['serve_delta'])} ({smi})", flush=True)
    if gpus > 1:
        torch.cuda.empty_cache()
        out["tp"] = S.serving_tp_gpus(gpus, traffic)
        print(f"phase 21 (f): {json.dumps(out['tp'])} ({smi})", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
