#!/usr/bin/env python3
"""Time the Adasum combine's blend pass in reverse chunk order (as
``horovod_tpu_torch/ops/csrc/adasum.cu`` ships it) against forward order,
on one GPU, at ResNet-50's shapes.

    python3 tools/adasum_blend_order.py [--reps 6]

The kernel's reduce pass streams the operands from the first chunk to
the last; a blend that starts from the last chunk may find them still in
the 50 MB L2. This script builds ``adasum.cu`` twice, as it is and with
the blend's chunk order turned forward (an edited copy in the git-ignored
build directory), and swaps each library in for the package's own
(``ops.kernels._fns``), so both run through the same wrappers on the same
inputs: ResNet-50's 161 gradient leaves packed in bf16
(``adasum_pair_combine_packed``, the compressed route) and as the f32
group buffer (``adasum_segment_combine``, the grouped route). The two
variants must give the same bits (the order of blocks changes no sum).
Times are CUDA events, in turns (reverse, forward, forward, reverse,
...): "warm", ``--iters`` calls back to back between one pair of events
(the previous call's blend leaves the first chunks in L2, where the next
reduce starts); "cold", each call alone between its own events after a
1 GiB write, which empties the L2 and keeps the card busy while the host
enqueues the call. Prints the card's name and power limit, then one JSON
line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REVERSE = "const int c = n_chunks - 1 - static_cast<int>(blockIdx.x);"
FORWARD = "const int c = static_cast<int>(blockIdx.x);"


def forward_library(build, kernels):
    """The combine with its blend in forward chunk order, loaded."""
    with open(os.path.join(build.CSRC, "adasum.cu")) as fh:
        src = fh.read()
    if src.count(REVERSE) != 1:
        sys.exit("adasum_blend_order: the blend's chunk order line is not "
                 "in adasum.cu as this script expects")
    d = build.build_dir()
    path = os.path.join(d, "adasum_forward_blend.cu")
    with open(path, "w") as fh:
        fh.write(src.replace(REVERSE, FORWARD))
    lib = os.path.join(d, "adasum_forward_blend.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib, path],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(lib).hvd_adasum_combine
    fn.argtypes = kernels._ARGTYPES["hvd_adasum_combine"]
    fn.restype = ctypes.c_int
    return fn


def warm_ms(torch, run, iters: int) -> float:
    """Mean ms of ``iters`` calls of ``run()`` back to back."""
    run()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def cold_ms(torch, run, iters: int, flush) -> float:
    """Mean ms of ``run()`` over ``iters`` calls, each timed alone after
    ``flush()``."""
    total = 0.0
    for _ in range(iters):
        flush()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        run()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6,
                    help="turns of each variant (default 6)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls timed in each turn (default 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("adasum_blend_order: needs a GPU")
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import _build, adasum as A, kernels as K
    from horovod_tpu_torch.optim import tree_keys

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    meta = ResNet50(device="meta").jax_params()
    sizes = tuple(meta[k].numel() for k in tree_keys(meta))
    gen = torch.Generator(device=dev).manual_seed(0)

    def leaves(dtype):
        return [(torch.randn(s, device=dev, generator=gen) * 1e-2).to(dtype)
                for s in sizes]

    _, table = A._leaf_table(sizes, 2)
    pa, pb = A._pack(leaves(torch.bfloat16), table), \
        A._pack(leaves(torch.bfloat16), table)
    fa, offsets = A._flatten_group(leaves(torch.float32))
    fb, _ = A._flatten_group(leaves(torch.float32))
    cases = {
        "packed_bf16": lambda: K.adasum_pair_combine_packed(pa, pb, table),
        "grouped_f32": lambda: K.adasum_segment_combine(fa, fb, offsets),
    }
    shipped = K._fn("adasum", "hvd_adasum_combine")
    variants = {"reverse": shipped, "forward": forward_library(_build, K)}
    outs = {}
    for name, fn in variants.items():
        K._fns["hvd_adasum_combine"] = fn
        outs[name] = {c: run() for c, run in cases.items()}
    for c in cases:
        a, b = outs["reverse"][c], outs["forward"][c]
        if not torch.equal(a.view(torch.int16 if a.element_size() == 2
                                  else torch.int32),
                           b.view(torch.int16 if b.element_size() == 2
                                  else torch.int32)):
            sys.exit(f"adasum_blend_order: {c}: the two blend orders differ")
    junk = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    timers = {"warm": lambda run: warm_ms(torch, run, args.iters),
              "cold": lambda run: cold_ms(torch, run, args.iters,
                                          lambda: junk.fill_(1))}
    times = {v: {c: {t: [] for t in timers} for c in cases} for v in variants}
    for rep in range(args.reps):
        order = ("reverse", "forward") if rep % 2 == 0 else ("forward", "reverse")
        for v in order:
            K._fns["hvd_adasum_combine"] = variants[v]
            for c, run in cases.items():
                for t, timer in timers.items():
                    times[v][c][t].append(timer(run))
    K._fns["hvd_adasum_combine"] = shipped
    print(json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                      "reps": args.reps, "iters": args.iters,
                      "elements": {"packed_bf16": table[-1],
                                   "grouped_f32": offsets[-1]},
                      "ms": times}), flush=True)


if __name__ == "__main__":
    main()
