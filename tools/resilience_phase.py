#!/usr/bin/env python3
"""Run phase 19 of ``chip_smoke.py`` (resilience) alone, and time the
elastic driver's commit on one GPU, split into its parts.

    python3 tools/resilience_phase.py            # phase 19's one-GPU part
    python3 tools/resilience_phase.py --gpus 4   # the elastic run across 4
    python3 tools/resilience_phase.py --commit   # the commit, split

The one-GPU part is ``chip_smoke.resilience_phase()`` (preemption in
child processes, the guard's rollback, the retried allreduce); with
``--gpus N`` ``chip_smoke.elastic_gpus(N)`` and the kernel phase's
replay of its N-1-rank step. ``--commit`` builds ResNet-50's ZeRO-1 +
int8 + EF state after one step and times, three times each, the rows'
gather (``checkpoint._gather_sharded``), the host copy
(``training.host_snapshot``, by part of the state) and, as yardsticks,
one 102 MB device-to-host copy into pageable memory and one into
page-locked memory; with and without deterministic algorithms. Prints
JSON lines; needs a GPU.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _timed(f, *a):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = f(*a)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def commit_split(deterministic: bool) -> list:
    import torch

    import chip_smoke as S
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import checkpoint as ck
    from horovod_tpu_torch.training import host_snapshot

    if deterministic:
        torch.use_deterministic_algorithms(True)
    hvd.init()
    try:
        model = S.build_model("resnet50", 0, hvd.device())
        tx = S.make_tx("zero1")
        step = hvd.make_train_step(model, tx, shard_optimizer=True)
        st = tx.init(model.jax_params())
        st, loss = step(st, *S.p19_batch(0))
        float(loss)
        state = S.p19_state(model, st)
        big = torch.empty(25_557_032, device=hvd.device())
        pinned = torch.empty(25_557_032, pin_memory=True)
        out = []
        for _ in range(3):
            gathered, gather_s = _timed(ck._gather_sharded, state)
            _, host_s = _timed(host_snapshot, gathered)
            parts = {part: _timed(host_snapshot, gathered[part])[1]
                     for part in ("params", "batch_stats", "opt_state")}
            out.append(dict(
                deterministic=deterministic, gather_s=gather_s,
                host_copy_s=host_s, host_copy_by_part_s=parts,
                pageable_102MB_s=_timed(lambda: big.cpu())[1],
                pinned_102MB_s=_timed(lambda: pinned.copy_(big))[1]))
        return out
    finally:
        hvd.shutdown()


def main() -> None:
    import torch

    import chip_smoke as S
    from horovod_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        S.fail("resilience_phase: no GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    if "--commit" in sys.argv:
        if len(sys.argv) > 2:       # the child: one setting
            for rec in commit_split(sys.argv[2] == "det"):
                print(json.dumps(rec), flush=True)
            return
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        for mode in ("det", "nodet"):   # deterministic mode is per process
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--commit", mode], check=True, env=env)
        return
    gpus = int(sys.argv[2]) if len(sys.argv) > 2 and \
        sys.argv[1] == "--gpus" else 1
    t0 = time.perf_counter()
    if gpus == 1:
        print(json.dumps(S.resilience_phase()), flush=True)
    else:
        rec, run, calls = S.elastic_gpus(gpus)
        print(json.dumps(rec), json.dumps(run), flush=True)
        rows = S.kernel_phase({f"elastic@{gpus - 1}": calls},
                              S.main_modes(gpus))
        for name, r in rows.items():
            if r["by_mode"]:
                print(f"kernel {name}: {json.dumps(r['by_mode'])}",
                      flush=True)
    print(f"{time.perf_counter() - t0:.1f} s ({smi})", flush=True)


if __name__ == "__main__":
    main()
