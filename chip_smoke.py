#!/usr/bin/env python3
"""Drive horovod_tpu_torch's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # one GPU
    python3 chip_smoke.py --gpus 4   # and then across 4 GPUs

Phases, each fatal on failure (exit code 1, no result line):

1. versions, and the card's name and power limit from nvidia-smi;
2. build the CUDA kernels from ``horovod_tpu_torch/ops/csrc`` (one nvcc
   per source, started together; nvcc's release line, and each kernel's
   registers and spills from ``-Xptxas -v``);
3. small-input check: three ZeRO-1 int8 + error-feedback steps of a
   narrow ResNet on the GPU agree with the same steps on the CPU (a
   child process, plain versions, gloo);
4. end to end: ResNet-50 at full width (224x224x3, 1000 classes, bf16
   compute, f32 parameters), batch 64, random weights from a seed, a
   world of one over NCCL: (a) ZeRO-1 + int8 + EF + fused Adam, 10 steps;
   (b) allreduce mode + int8 + EF + fused Adam, 5 steps. Losses must be
   finite and fall on the repeated batch, and every kernel of each run's
   path must have launched during it; fused Adam exactly once a step
   (one multi-tensor launch over the flat shard, or over the 161 leaves,
   ``ops.kernels.ADAM_MAX_LEAVES`` a launch). Allreduce mode exchanges the
   tree fused: exactly one ``quantize`` (its roundtrip serves the error
   feedback and the wire), one ``dequant_accumulate_requantize`` and one
   ``dequantize_rows`` a step over the 76 quantizable leaves laid side by
   side as ``[N, S]``, and exactly 5 NCCL calls in the optimizer update
   (two ``all_to_all`` and two ``all_gather`` of the int8 group, one
   ``all_reduce`` of the 85 small f32 leaves; the step's running-stats
   and loss allreduces are counted apart), counted by wrapping the
   ``torch.distributed`` functions ``ops/collective.py`` calls. Every
   kernel-wrapper call of the run is logged with its shape;
5. with ``--gpus N``: phase 4 again across N GPUs of the host (one process
   per GPU, NCCL, each rank on its own 64 rows of one global batch, 4
   steps per mode), and the ZeRO-3 and Adasum runs of phase 7; every rank
   must report the same falling losses and the same parameters;
6. kernels: every call of one step of each run above is replayed on
   fresh inputs at its own shape (the flat buffer's quantize, allreduce
   mode's one quantize, requantize and dequantize over its ``[N, S]``
   buffer, the one Adam launch over the 161 leaves, each gradient at its
   logged offset from a 16-byte boundary, ...) and held against the
   plain PyTorch version:
   bit for bit for the int8 wire, within 2 ULP for every leaf of fused
   Adam, a NaN meeting a NaN. The inputs carry all-zero blocks, exact half-way
   quotients, NaN and infinite blocks. Each mode's replay is timed with
   CUDA events (kernel, plain version, and for fused Adam
   ``torch._fused_adam_`` over the same tensors as a yardstick) beside
   the sum of the calls' bounds; the kernel's replay also as
   ``device_ms``, queued behind a sleep of the card so that the wrappers'
   host time drops out (back to back, ``ms`` reads the slower of the
   host and the card). The 152 quantizes and 76 requantizes
   allreduce mode made a step before its exchange was fused (two per
   quantizable leaf, one per leaf) are replayed and timed the same way,
   as the yardstick of the fused calls (``per_leaf_yardstick`` of the
   ``quantize`` and ``dequant_accumulate_requantize`` rows, outside
   their ``ms``). The requantize's inputs at two or more senders also
   carry a block whose sum has exact half-way quotients. ResNet-50's flat
   buffer is also checked with a tail that does not divide the block and
   with eight synthetic senders (the requantize dividing by none, 3, 6
   and 8), and fused Adam's int8 requantize epilogue (which no training
   path calls) bit for bit at ZeRO-1's shard length, 25,557,032;
7. ZeRO-3 and Adasum on the ResNet-50 step, one GPU: (a) ``zero3``,
   ``DistributedOptimizer(fused_adam(1e-3), shard_params=True)`` with the
   int8 parameter gather (``HOROVOD_FSDP_WIRE=int8``), 10 steps: exactly
   2 ``quantize`` and 2 ``dequantize_rows`` launches a step (the gather
   and the backward's re-gather of the one f32 group) and 1
   ``fused_adam``; img/s and peak memory beside ZeRO-1's. Every ResNet-50
   run ends with one more step split at ``make_train_step``'s phase hook
   (forward, backward, optimizer, loss allreduce) by synchronised host
   timers. (b) ``adasum``,
   ``DistributedOptimizer(fused_adam(1e-3), op=Adasum)``, 5 steps: at a
   world of one the butterfly has no level, so no Adasum kernel runs.
   (c) the Adasum level-1 replay: ResNet-50's gradient trees on the two
   64-row halves of one 128-row batch (rank 0's and rank 1's of a world
   of two) go through the combine rank 0 makes at level 1, by the port's
   own functions: ``_segment_combine`` over the 25,557,032-element f32
   group (161 segments); ``adasum_pair_combine_packed`` over the 161
   leaves packed (``_leaf_table``, ``_pack``) in bf16 (what ``Compression.fp16`` puts
   on the wire) and in f16, one call each; and ``_pair_combine`` per leaf
   in bf16, f16 and f32. The calls are logged; the grouped and the packed
   bf16 ones are counted as the replay's launches, and the 161 per-leaf
   bf16 calls (the compressed route's combines when it ran leaf by leaf)
   are timed as
   the ``per_leaf_yardstick`` of the ``adasum_pair_combine`` row, outside
   its per-step numbers. Every combine is held against its plain version
   on these same correlated operands (where the projection term is
   large); each leaf of the packed combine must equal its per-leaf
   combine bit for bit, in bf16 and f16, and the grouped result the
   per-leaf f32 one (their chunks coincide). With ``--gpus N`` ZeRO-3
   int8, Adasum grouped (``adasum``) and Adasum compressed
   (``adasum_fp16``: ``DistributedOptimizer(fused_adam(1e-3), op=Adasum,
   compression=Compression.fp16)``, the leaves packed in bf16) run 4
   steps each across the N GPUs: every rank the same losses and the same
   unpacked parameters, ``adasum_segment_combine`` launched log2(N) times
   a step by ``adasum`` and ``adasum_pair_combine`` log2(N) times a step
   by ``adasum_fp16``, the other combine never, and each update making
   log2(N) point-to-point exchanges (``batch_isend_irecv``).
   The kernel phase replays these calls too: ``dequantize_rows`` bit for
   bit (NaN and infinite scale blocks included), the Adasum combines
   within rtol 2e-5 / atol 2e-6 (a 16-bit output also within one ULP of
   its type, the f32 value's rounding boundary) and bit-identical across
   two launches; and shapes the path does not give: 8 synthetic senders
   for ``dequantize_rows``, zero operands, lengths that are not a
   multiple of any tile, an operand at an odd element offset, a segment
   of length 1 and an empty one;
8. the LM slice (one GPU, NCCL world of one, matmuls in full f32 where
   f32: TF32 off): TransformerLM at the flagship configuration's full
   width (vocab 32000, dim 1024, depth 12, 16 heads of 64, RoPE, flash
   attention, bf16 compute, f32 parameters, 216,643,584 of them), batch
   8 x 2048 tokens from ``np.random.RandomState(0)``, targets rolled by
   one, ``DistributedOptimizer(adamw(1e-4))`` + ``lm_xent``, 8 steps.
   Losses must be finite and fall on the repeated batch, and the
   ``flash_fwd`` kernel must have launched exactly 12 times a step. It
   prints tokens/s per GPU over steps 2-8 and one more step of the same
   step function split into forward (with the kernel), backward (the
   plain flash backward inside), optimizer and loss allreduce by
   synchronised host timers at ``make_train_step``'s phase hook; the
   plain flash backward of the step's 12 calls is timed alone with CUDA
   events. The kernel phase
   replays the 12 logged ``flash_fwd`` calls of the last step at their
   own shapes and strides against ``flash_fwd_plain`` (``out`` within
   one bf16 ULP, ULPs below 2^-8's counted as 2^-8's, and the elements
   that floor lets through counted; ``lse`` within 1e-5 relative, 1e-5
   absolute below 1: the two sum in different f32 orders), and times them beside ``F.scaled_dot_product_attention``
   over the same tensors (a yardstick the port never calls; it emits no
   lse). Shapes the path does not give are checked too: GQA (16 query
   heads on 4 kv heads), non-causal, T = 1000 (not a multiple of the
   tile), head dim 128 (all four on the bf16 tensor-core kernel), f32
   inputs (the f32 kernel). The build's ``-Xptxas -v`` report gives each
   kernel's registers and spills (``ptxas`` in the ``kernels`` line).

A kernel's ``ms``/``plain_ms``/``bound_ms``/``library_ms`` in the
``{"kernels": [...]}`` line are per step: the sum over one step of each
one-GPU mode that launches it; for the Adasum combines, which no run on
one GPU launches, the level-1 replay's grouped call and its packed bf16
call (one level of each of ``DistributedOptimizer(op=Adasum)``'s
routes), or with ``--gpus N`` rank 0's step of ``adasum`` and
``adasum_fp16`` across the N GPUs. ``by_mode`` splits them.
``launches`` counts the launches of the main path's runs (with ``--gpus
N`` rank 0's of the N-GPU runs too, as ``mode@N``); a kernel that none of
them launched, as the Adasum combines on one GPU, takes the replay's
grouped and packed bf16 counts, under ``adasum_l1_replay`` in
``launches_by_mode``. A bound is the larger of the bytes
over the memory rate and the operations over the peak rate for the
inputs' type (bf16 tensor cores for ``flash_fwd``'s bf16 dots, the f32
rate outside the tensor cores otherwise); ``flash_fwd``'s operations are
those of the (query, key) pairs the causal mask keeps, whatever the
kernel's tiling. The Adasum combines' bytes read each
operand once, as the bound does for every kernel; their two-pass floor
(both operands read twice) is given beside it as ``two_pass_bound_ms``.
The last two lines of standard output are that record and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peak memory bandwidth (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense f32 rate outside the tensor cores, operations/s
F32_OPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor-core rate, operations/s
BF16_OPS_PER_S = 989e12
#: fused Adam's bar against its plain version
ADAM_ULPS = 2
#: flash_fwd's bars against its plain version: out within one ULP (of bf16;
#: ULPs below 2^-8's are counted as 2^-8's, where the f32 sums' rounding
#: is larger than an ULP), f32 out within 1e-5; lse within 1e-5 relative
#: (absolute below 1: row 0's lse is a single dot product, near 0)
FLASH_ULP_FLOOR = 2.0 ** -8
FLASH_TOL = 1e-5

#: the LM slice: the flagship TransformerLM configuration
LM = dict(vocab=32000, dim=1024, depth=12, heads=16, kv_heads=None,
          mlp_ratio=4, max_len=2048, pos_embedding="rope")
LM_BATCH, LM_SEQ, LM_STEPS = 8, 2048, 8

#: the Adasum combines' bar against their plain versions (tests/test_pallas.py)
ADASUM_RTOL, ADASUM_ATOL = 2e-5, 2e-6

TPU_KERNELS = {
    "quantize": "horovod_tpu/ops/pallas_kernels.py:220",
    "dequant_accumulate": "horovod_tpu/ops/pallas_kernels.py:323",
    "dequant_accumulate_requantize": "horovod_tpu/ops/pallas_kernels.py:354",
    "fused_adam": "horovod_tpu/ops/pallas_kernels.py:673",
    "flash_fwd": "horovod_tpu/ops/flash_attention.py:250",
    "dequantize_rows": "horovod_tpu/ops/pallas_kernels.py:404",
    "adasum_pair_combine": "horovod_tpu/ops/pallas_kernels.py:470",
    "adasum_segment_combine": "horovod_tpu/ops/pallas_kernels.py:556",
}
SOURCES = {
    "quantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "dequant_accumulate_requantize": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "fused_adam": "horovod_tpu_torch/ops/csrc/fused_adam.cu",
    "flash_fwd": "horovod_tpu_torch/ops/csrc/flash_attention.cu",
    "dequantize_rows": "horovod_tpu_torch/ops/csrc/int8_wire.cu",
    "adasum_pair_combine": "horovod_tpu_torch/ops/csrc/adasum.cu",
    "adasum_segment_combine": "horovod_tpu_torch/ops/csrc/adasum.cu",
}
#: the public wrappers of ops.kernels the path calls, and their kernel
WRAPPERS = {
    "quantize_blockwise": "quantize",
    "quantize_roundtrip": "quantize",
    "dequant_accumulate": "dequant_accumulate",
    "dequant_accumulate_requantize": "dequant_accumulate_requantize",
    "fused_adam_multi": "fused_adam",
    "fused_adam_update": "fused_adam",
    "flash_fwd": "flash_fwd",
    "dequantize_rows": "dequantize_rows",
    "adasum_pair_combine": "adasum_pair_combine",
    "adasum_pair_combine_packed": "adasum_pair_combine",
    "adasum_segment_combine": "adasum_segment_combine",
}
#: kernels each mode's path must launch (Adasum's at a world of one: none
#: of its own, the butterfly has no level; across N GPUs expected_launches
#: fixes the combines' counts; adasum_fp16 runs across N GPUs only)
NEED = {"zero1": ("quantize", "dequant_accumulate", "fused_adam"),
        "allreduce": ("quantize", "dequant_accumulate_requantize",
                      "dequantize_rows", "fused_adam"),
        "zero3": ("quantize", "dequantize_rows", "fused_adam"),
        "adasum": ("fused_adam",),
        "adasum_fp16": ("adasum_pair_combine", "fused_adam"),
        "lm": ("flash_fwd",)}
#: the torch.distributed functions ops/collective.py calls through its
#: ``dist`` name (one of each renamed pair exists)
DIST_CALLS = ("all_reduce", "all_to_all_single", "all_gather_single",
              "all_gather_into_tensor", "reduce_scatter_single",
              "reduce_scatter_tensor", "broadcast", "batch_isend_irecv")
#: the replays of what a kernel's calls were before they were fused, each
#: a yardstick outside every row's per-step numbers: allreduce mode's
#: per-leaf int8 calls, and the compressed Adasum route's 161 per-leaf
#: bf16 combines of one level
PER_LEAF = "allreduce_per_leaf"
ADASUM_PER_LEAF = "adasum_l1_replay_leaf_bfloat16"
YARDSTICKS = (PER_LEAF, ADASUM_PER_LEAF)
#: the ResNet-50 modes across N GPUs (``--gpus N``)
WORLD_MODES = ("zero1", "allreduce", "zero3", "adasum", "adasum_fp16")
#: the one-GPU modes whose replayed step makes a kernel row's numbers
ONE_GPU_MODES = ("zero1", "allreduce", "zero3", "adasum", "lm")
#: the level-1 replay's calls that stand in for the Adasum combines' step
#: on one GPU: the grouped route's, and the compressed route's in bf16
REPLAY_MODES = ("adasum_l1_replay_grouped", "adasum_l1_replay_packed_bfloat16")


def main_modes(gpus: int) -> dict:
    """Each kernel's modes whose replayed step makes its row's per-step
    numbers: the one-GPU runs; for the Adasum combines, which no run on
    one GPU launches, the level-1 replay's grouped and bf16 calls, or
    with ``gpus`` > 1 rank 0's step of the two Adasum runs across them."""
    adasum = (f"adasum@{gpus}", f"adasum_fp16@{gpus}") if gpus > 1 \
        else REPLAY_MODES
    return {k: adasum if k.startswith("adasum") else ONE_GPU_MODES
            for k in TPU_KERNELS}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def cuda_device_ms(fn, iters: int = 10) -> float:
    """The card's time for ``fn``: as :func:`cuda_ms`, with the calls
    queued behind a sleep of the card that outlasts their enqueueing, so
    that the host's time a call drops out of the reading."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * host + 1e-3)))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def _numbers(a, b):
    """``a`` and ``b`` where neither is NaN, after checking that they are
    NaN at the same places (a NaN's payload is not part of the contract:
    PyTorch's CPU and CUDA casts and the CUDA intrinsics differ in it)."""
    import torch

    if not a.is_floating_point():
        return a, b
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return None
    return a[~nan], b[~nan]


def same_bits(a, b) -> bool:
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    if a.is_floating_point():
        itype = {torch.float32: torch.int32, torch.bfloat16: torch.int16,
                 torch.float16: torch.int16}
        return torch.equal(a.view(itype[a.dtype]), b.view(itype[b.dtype]))
    return torch.equal(a, b)


def within_ulps(a, b, ulps: int = ADAM_ULPS) -> bool:
    import torch

    ab = _numbers(a, b)
    if ab is None:
        return False
    a, b = ab
    inf = torch.isinf(a) | torch.isinf(b)
    if not torch.equal(a[inf], b[inf]):
        return False
    a, b = a[~inf], b[~inf]
    big = torch.maximum(a.abs(), b.abs())
    spacing = torch.nextafter(big, torch.full_like(big, math.inf)) - big
    return bool(((a - b).abs() <= ulps * spacing).all())


def max_abs(a, b) -> float:
    """Largest |a - b| where both are numbers."""
    d = (a.float() - b.float()).abs()
    d = d[~d.isnan()]
    return float(d.max()) if d.numel() else 0.0


# --------------------------------------------------------------------------
# the kernel calls of the main path


def _signature(wrapper: str, args, kw) -> tuple:
    kernel = WRAPPERS[wrapper]
    if kernel == "quantize":
        return (kernel, wrapper == "quantize_roundtrip", args[0].numel())
    if kernel == "dequant_accumulate":
        return (kernel, *args[0].shape)
    if kernel == "dequant_accumulate_requantize":
        return (kernel, *args[0].shape, kw.get("divisor"))
    if kernel == "flash_fwd":
        q, k, v = args
        return (kernel, tuple(q.shape), tuple(k.shape),
                str(q.dtype).replace("torch.", ""), bool(kw.get("causal")),
                kw.get("sm_scale"), q.stride(), k.stride(), v.stride())
    if kernel == "dequantize_rows":
        return (kernel, *args[0].shape)
    if wrapper == "adasum_pair_combine_packed":
        return (kernel, tuple(int(o) for o in args[2]),
                str(args[0].dtype).replace("torch.", ""))
    if kernel == "adasum_pair_combine":
        return (kernel, args[0].numel(), str(args[0].dtype).replace("torch.", ""))
    if kernel == "adasum_segment_combine":
        return (kernel, tuple(int(o) for o in args[2]))
    # fused_adam: each leaf's length and its g's offset from a 16-byte
    # boundary in elements (Adasum's leaves are views into a group buffer)
    gs = args[0] if wrapper == "fused_adam_multi" else [args[0]]
    return (kernel, tuple(g.numel() for g in gs),
            tuple(g.data_ptr() % 16 // 4 for g in gs), args[3],
            tuple(sorted(kw.items())))


@contextlib.contextmanager
def logging_calls(steps: list):
    """Log the shape signature of every call of a kernel wrapper into
    ``steps[-1]`` (the caller appends a list per step). The path reaches
    the wrappers through the ``ops.kernels`` module, so wrapping the
    module's attributes sees every call; :func:`train` checks that the
    log and the launch counters agree."""
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.testing import watching_calls

    with watching_calls(K, WRAPPERS, lambda w, args, kw: steps[-1].append(
            _signature(w, args, kw))):
        yield


@contextlib.contextmanager
def counting_collectives(counts: dict, where: list):
    """Count every call of the :data:`DIST_CALLS` functions into
    ``counts[where[-1]]`` (the caller pushes a label while inside a part
    of the step). ``ops/collective.py`` looks them up through its
    ``dist`` name at each call, so wrapping the module's attributes sees
    every call."""
    from horovod_tpu_torch.ops import collective as C
    from horovod_tpu_torch.testing import watching_calls

    def count(name, args, kw):
        part = counts.setdefault(where[-1], {})
        part[name] = part.get(name, 0) + 1

    with watching_calls(C.dist, DIST_CALLS, count):
        yield


def allreduce_nccl_calls(params) -> int:
    """NCCL calls of one allreduce-mode int8 update of ``params``: four
    for each quantizable dtype's exchange (two ``all_to_all``, two
    ``all_gather``), one ``all_reduce`` for each dtype of the rest."""
    from horovod_tpu_torch.compression import Compression

    quant = [Compression.int8.quantizes(p.shape, p.dtype) for p in params]
    return (4 * len({p.dtype for p, q in zip(params, quant) if q})
            + len({p.dtype for p, q in zip(params, quant) if not q}))


def per_leaf_calls(params, n: int) -> list:
    """The int8 kernel calls allreduce mode + EF made a step when it
    exchanged leaf by leaf, for a world of ``n``: per quantizable leaf,
    the residual's quantize (padded to the block), the wire's quantize
    (padded to ``n`` blocks) and one requantize of its ``[n, Lp/n]`` rows."""
    from horovod_tpu_torch.compression import INT8_BLOCK, Compression

    sigs = []
    for p in params:
        if Compression.int8.quantizes(p.shape, p.dtype):
            L = p.numel()
            lp = L + (-L) % (n * INT8_BLOCK)
            sigs += [("quantize", False, L + (-L) % INT8_BLOCK),
                     ("quantize", False, lp),
                     ("dequant_accumulate_requantize", n, lp // n, n)]
    return sigs


def flash_pairs(t_q: int, t_k: int, causal: bool) -> int:
    """The (query, key) pairs attention needs for one (batch, head): all
    of them, or those the causal mask keeps (key index <= query index),
    ``sum_i min(t_k, i + 1)``."""
    if not causal:
        return t_q * t_k
    n = min(t_q, t_k)
    return n * (n + 1) // 2 + (t_q - n) * t_k


def call_bound(sig) -> tuple:
    """``(bytes, operations, operations/s)`` of one call: each input read
    once, each output written once; the operations at the peak rate for
    their type."""
    kernel = sig[0]
    if kernel == "quantize":
        _, roundtrip, L = sig
        return (4 * L + L + 2 * (L // 256) + 4 * L * roundtrip, 4 * L,
                F32_OPS_PER_S)
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        wire = n * sp + 2 * n * (sp // 256)
        if kernel == "dequant_accumulate":
            return wire + 4 * sp, 2 * n * sp, F32_OPS_PER_S
        return wire + sp + 2 * (sp // 256), 2 * n * sp + 4 * sp, F32_OPS_PER_S
    if kernel == "flash_fwd":
        (b, t_q, h, d), (_, t_k, h_kv, _), dtype, causal = sig[1:5]
        item = 2 if dtype == "bfloat16" else 4
        nbytes = item * d * (2 * b * t_q * h + 2 * b * t_k * h_kv) + 4 * b * h * t_q
        # q.k and p.v: 2 + 2 operations per (q, k, d) of every needed pair
        ops = 4 * d * b * h * flash_pairs(t_q, t_k, causal)
        return nbytes, ops, (BF16_OPS_PER_S if item == 2 else F32_OPS_PER_S)
    if kernel == "dequantize_rows":
        n, sp = sig[1], sig[2]
        return n * sp * (1 + 4) + n * (sp // 256) * 2, n * sp, F32_OPS_PER_S
    if kernel.startswith("adasum"):
        L, item = adasum_len_item(sig)
        # a and b read once, out written once; a*b, a*a, b*b summed (6)
        # and ca*a + cb*b (3) in f32
        return 3 * item * L, 9 * L, F32_OPS_PER_S
    L = sum(sig[1])
    return 24 * L, 12 * L, F32_OPS_PER_S


def adasum_len_item(sig) -> tuple:
    """``(elements, bytes an element)`` of an Adasum combine's call (a
    packed leaf table's elements include its pads)."""
    if sig[0] == "adasum_segment_combine":
        return sig[1][-1], 4
    L = sig[1][-1] if isinstance(sig[1], tuple) else sig[1]
    return L, 4 if sig[2] == "float32" else 2


def two_pass_bound_ms(sigs) -> float:
    """The Adasum combines' floor when both operands are read twice (the
    reduction, then the blend) and the output written once."""
    total = 0.0
    for sig in sigs:
        L, item = adasum_len_item(sig)
        total += 5 * item * L / HBM_BYTES_PER_S
    return total * 1e3


def bound_ms(sigs) -> tuple:
    """The least time for all of ``sigs``: the sum of each call's larger
    of bytes over the memory rate and operations over its peak rate."""
    total, by = 0.0, set()
    for sig in sigs:
        nbytes, ops, rate = call_bound(sig)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
        total += max(t_b, t_o)
        by.add("bytes" if t_b >= t_o else "operations")
    return total * 1e3, "bytes" if by == {"bytes"} else "operations"


def _special_blocks(x, gen) -> None:
    """Overwrite the first blocks of a flat f32 input with edge cases, as
    far as it has blocks and leaving at least one ordinary block: all zero;
    exact half-way quotients (amax 127 gives scale 1); a NaN; infinities."""
    import torch

    half = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -3.5] * 32,
                        device=x.device)
    nan = torch.randn(256, device=x.device, generator=gen)
    nan[17] = math.nan
    inf = torch.randn(256, device=x.device, generator=gen)
    inf[3], inf[200] = math.inf, -math.inf
    for i, block in enumerate((torch.zeros_like(half), half, nan, inf)):
        if (i + 2) * 256 > x.numel():
            break
        x[i * 256:(i + 1) * 256] = block


def _half_way_block(q, s, b) -> None:
    """Senders' block ``b`` whose sum has exact half-way quotients: rows 0
    and 1 at scale 1, both 127 at the block's first element and row 0 odd
    elsewhere, the other rows zero. The sum's max is 254, so its scale is
    2 / divisor for a power-of-two divisor (or none), and every odd sum
    over it lies on a half-integer."""
    import torch

    i = torch.arange(255, device=q.device)
    q[:, b * 256:(b + 1) * 256] = 0
    s[:, b] = 1.0
    q[:2, b * 256] = 127
    q[0, b * 256 + 1:(b + 1) * 256] = ((i % 63 * 2 + 1)
                                      * (1 - 2 * (i % 2))).to(torch.int8)


def make_call(sig, gen):
    """``(kernel_call, plain_call, compare)`` on fresh inputs on
    ``gen``'s device for one logged call; ``compare(out, ref)`` is None
    when they agree, else a message."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import kernels as K

    dev = gen.device
    kernel = sig[0]
    if kernel == "flash_fwd":
        _, qs, ks, dtype, causal, scale, qst, kst, vst = sig
        dtype = getattr(torch, dtype)

        def strided(shape, stride):
            # the logged layout: a view of a buffer just large enough
            n = 1 + sum((a - 1) * st for a, st in zip(shape, stride))
            x = torch.randn(n, device=dev, generator=gen).to(dtype)
            return x.as_strided(shape, stride)

        q, k, v = strided(qs, qst), strided(ks, kst), strided(ks, vst)
        call = (lambda: K.flash_fwd(q, k, v, causal=causal, sm_scale=scale),
                lambda: K.flash_fwd_plain(q, k, v, causal=causal,
                                          sm_scale=scale),
                _flash_close)
        call[0].tensors = (q, k, v, causal, scale)
        return call
    if kernel == "quantize":
        _, roundtrip, L = sig
        x = torch.randn(L, device=dev, generator=gen) * 1e-2
        _special_blocks(x, gen)
        f = K.quantize_roundtrip if roundtrip else K.quantize_blockwise
        return (lambda: f(x), lambda: K.quantize_plain(x, roundtrip=roundtrip),
                _bits)
    if kernel in ("dequant_accumulate", "dequant_accumulate_requantize"):
        n, sp = sig[1], sig[2]
        nb = sp // 256
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, nb, device=dev, generator=gen) * 1e-2).to(
            torch.bfloat16)
        q[:, :256], s[:, 0] = 0, 0.0           # an all-zero block
        if nb >= 4:                             # a sender's NaN / inf block
            s[0, 1], s[n - 1, 2] = math.nan, math.inf
        if n >= 2 and nb >= 5:                  # exact half-way quotients
            _half_way_block(q, s, 3)
        if kernel == "dequant_accumulate":
            return (lambda: (K.dequant_accumulate(q, s),),
                    lambda: (K.dequant_accumulate_plain(q, s),), _bits)
        d = sig[3]
        return (lambda: K.dequant_accumulate_requantize(q, s, divisor=d),
                lambda: K.dequant_accumulate_requantize_plain(q, s, divisor=d),
                _bits)
    if kernel == "dequantize_rows":
        n, sp = sig[1], sig[2]
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, sp // 256, device=dev, generator=gen) * 1e-2).to(
            torch.bfloat16)
        s[0, 0] = 0.0                           # an all-zero scale block
        if sp // 256 >= 3:                      # a NaN and an inf scale block
            s[0, 1], s[n - 1, 2] = math.nan, math.inf
        return (lambda: (K.dequantize_rows(q, s),),
                lambda: (K.dequantize_rows_plain(q, s),), _bits)
    if kernel == "adasum_pair_combine" and isinstance(sig[1], tuple):
        offsets, dtype = sig[1], getattr(torch, sig[2])
        a = (torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2).to(
            dtype)
        b = (torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2).to(
            dtype)
        return (lambda: (K.adasum_pair_combine_packed(a, b, offsets),),
                lambda: (K.adasum_segment_combine_plain(a, b, offsets),),
                _adasum_close)
    if kernel == "adasum_pair_combine":
        L, dtype = sig[1], getattr(torch, sig[2])
        a = (torch.randn(L, device=dev, generator=gen) * 1e-2).to(dtype)
        b = (torch.randn(L, device=dev, generator=gen) * 1e-2).to(dtype)
        return (lambda: (K.adasum_pair_combine(a, b),),
                lambda: (K.adasum_pair_combine_plain(a, b),), _adasum_close)
    if kernel == "adasum_segment_combine":
        offsets = sig[1]
        a = torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2
        b = torch.randn(offsets[-1], device=dev, generator=gen) * 1e-2
        return (lambda: (K.adasum_segment_combine(a, b, offsets),),
                lambda: (K.adasum_segment_combine_plain(a, b, offsets),),
                _adasum_close)
    _, lengths, offsets, count, kw = sig
    kw = dict(kw)
    # g: the leaves at their logged offsets in one buffer; mu, nu fresh
    slots = [(n + 7) // 4 * 4 for n in lengths]   # 16-byte aligned, with room
    starts = np.cumsum([0] + slots)[:-1] + np.asarray(offsets)
    gbuf = torch.randn(int(starts[-1]) + lengths[-1], device=dev,
                       generator=gen) * 1e-2
    gs = [gbuf[int(a):int(a) + n] for a, n in zip(starts, lengths)]
    mus = [torch.randn(n, device=dev, generator=gen) * 1e-3 for n in lengths]
    nus = [torch.rand(n, device=dev, generator=gen) * 1e-6 for n in lengths]
    big = [int(a) for a, n in zip(starts, lengths) if n >= 8]
    if big:                                 # a NaN and an inf gradient
        gbuf[torch.tensor([a + i for a in big for i in (1, 5)], device=dev)] = \
            torch.tensor([math.nan, math.inf] * len(big), device=dev)
    c = K.adam_constants(kw["lr"], kw["b1"], kw["b2"], kw["eps"],
                         kw["eps_root"], count)
    call = (lambda: sum(K.fused_adam_multi(gs, mus, nus, count, **kw), []),
            lambda: [x for out in zip(*(K.fused_adam_plain(g, m, v, c)
                                        for g, m, v in zip(gs, mus, nus)))
                     for x in out],
            _ulps)
    call[0].tensors = (gs, mus, nus)
    return call


def _bits(out, ref):
    for i, (a, b) in enumerate(zip(out, ref)):
        if not same_bits(a, b):
            return f"output {i} differs (max abs err {max_abs(a, b)})"
    return None


def _adasum_close(out, ref):
    """rtol 2e-5 / atol 2e-6 (the kernel and the plain version sum in
    other orders); a 16-bit element may instead be one ULP of its type
    off, where the f32 value sits on that type's rounding boundary."""
    import torch

    (o,), (r,) = out, ref
    if o.shape != r.shape or o.dtype != r.dtype:
        return f"shape/dtype {o.shape}/{o.dtype} vs {r.shape}/{r.dtype}"
    of, rf = o.float(), r.float()
    if not bool(torch.isfinite(of).all()):
        return "non-finite output"
    bar = ADASUM_ATOL + ADASUM_RTOL * rf.abs()
    if o.dtype != torch.float32:             # one ULP: 8 or 11 significand bits
        bits = 8 if o.dtype == torch.bfloat16 else 11
        _, e = torch.frexp(torch.maximum(of.abs(), rf.abs()))
        bar = torch.maximum(bar, torch.ldexp(torch.ones_like(of), e - bits))
    if bool(((of - rf).abs() > bar).any()):
        return f"off by up to {max_abs(o, r)}"
    return None


def _bf16_ulps(a, b, floor):
    """``(|a - b|, bf16's ULP at the larger of |a|, |b|)`` with magnitudes
    below ``floor`` taken as ``floor``."""
    import torch

    a, b = a.float(), b.float()
    big = torch.maximum(a.abs(), b.abs())
    _, e = torch.frexp(big.clamp_min(floor))
    return (a - b).abs(), torch.ldexp(torch.ones_like(big), e - 8)


def flash_unfloored_misses(out, ref) -> int:
    """Elements of a bf16 ``out`` more than one bf16 ULP from the plain
    version with no floor: how many the floor of the bar lets through."""
    diff, ulp = _bf16_ulps(out[0], ref[0], 2.0 ** -126)
    return int((diff > ulp).sum())


def _flash_close(out, ref):
    import torch

    (o, lse), (ro, rlse) = out, ref
    if o.shape != ro.shape or o.dtype != ro.dtype or lse.shape != rlse.shape:
        return f"shapes/dtypes {o.shape}/{o.dtype} vs {ro.shape}/{ro.dtype}"
    if not (bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())):
        return "non-finite output"
    if o.dtype == torch.bfloat16:
        diff, bar = _bf16_ulps(o, ro, FLASH_ULP_FLOOR)
        if bool((diff > bar).any()):
            worst = float((diff / bar).max())
            return f"out more than one bf16 ULP off ({worst:.2f} ULP)"
    elif max_abs(o, ro) > FLASH_TOL:
        return f"out off by {max_abs(o, ro)}"
    if bool(((lse - rlse).abs() > FLASH_TOL * rlse.abs().clamp_min(1.0)).any()):
        return f"lse off by {max_abs(lse, rlse)}"
    return None


def _ulps(out, ref):
    """``out``/``ref``: the updates, then the mu's, then the nu's."""
    n = len(out) // 3
    for i, (a, b) in enumerate(zip(out, ref)):
        if not within_ulps(a, b):
            return (f"{('update', 'mu', 'nu')[i // n]} of leaf {i % n} more "
                    f"than {ADAM_ULPS} ULP from the plain version (max abs "
                    f"err {max_abs(a, b)})")
    return None


def library_adam_ms(calls, count: int, kw: dict) -> float:
    """``torch._fused_adam_`` over the same tensors as one step's fused
    Adam calls, in one multi-tensor call (a yardstick; the port never
    calls it)."""
    import torch

    gs, mus, nus = ([x for c in calls for x in c.tensors[i]] for i in range(3))
    params = [torch.zeros_like(g) for g in gs]
    m2, v2 = [m.clone() for m in mus], [v.clone() for v in nus]
    steps = [torch.tensor(float(count), device=gs[0].device) for _ in gs]
    return cuda_ms(lambda: torch._fused_adam_(
        params, list(gs), m2, v2, [], steps, lr=kw["lr"], beta1=kw["b1"],
        beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
        maximize=False))


def library_flash_ms(calls) -> float:
    """``F.scaled_dot_product_attention`` over the same tensors as one
    step's flash_fwd calls, ``[B, H, T, D]`` views (a yardstick the port
    never calls: it emits no lse)."""
    import torch.nn.functional as F

    def run():
        for c in calls:
            q, k, v, causal, scale = c.tensors
            F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, scale=scale,
                enable_gqa=q.shape[2] != k.shape[2])

    return cuda_ms(run)


def kernel_phase(step_calls: dict, main_modes: dict) -> dict:
    """Replay each mode's logged step on fresh inputs: hold every call
    against its plain version, then time the kernel, plain and library
    replays. Returns the per-kernel record, its per-step numbers summed
    over ``main_modes[kernel]``."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {k: dict(max_abs_err=0.0, calls_checked=0, by_mode={})
            for k in K.KERNELS}
    for mode, sigs in step_calls.items():
        for kernel in K.KERNELS:
            ks = [s for s in sigs if s[0] == kernel]
            if not ks:
                continue
            calls = [make_call(s, gen) for s in ks]
            row = rows[kernel]
            for sig, (run, plain, compare) in zip(ks, calls):
                out, ref = run(), plain()
                bad = compare(out, ref)
                if bad:
                    fail(f"{kernel} at {sig[:3]} ({mode}): {bad}")
                if kernel.startswith("adasum") and not all(
                        map(same_bits, out, run())):
                    fail(f"{kernel} at {sig[:3]} ({mode}): two launches on "
                         "the same inputs differ")
                row["max_abs_err"] = max(
                    [row["max_abs_err"]]
                    + [max_abs(a, b) for a, b in zip(out, ref)])
                row["calls_checked"] += 1
                if kernel == "flash_fwd" and out[0].dtype == torch.bfloat16:
                    row["out_elements"] = (row.get("out_elements", 0)
                                           + out[0].numel())
                    row["over_one_unfloored_ulp"] = (
                        row.get("over_one_unfloored_ulp", 0)
                        + flash_unfloored_misses(out, ref))
            b, by = bound_ms(ks)
            lib = None
            if kernel == "fused_adam" and hasattr(torch, "_fused_adam_"):
                lib = library_adam_ms([c[0] for c in calls], ks[0][3],
                                      dict(ks[0][4]))
            elif kernel == "flash_fwd":
                lib = library_flash_ms([c[0] for c in calls])
            row["by_mode"][mode] = dict(
                calls=len(ks), shapes=len(set(ks)),
                ms=cuda_ms(lambda: [c[0]() for c in calls]),
                device_ms=cuda_device_ms(lambda: [c[0]() for c in calls]),
                plain_ms=cuda_ms(lambda: [c[1]() for c in calls]),
                bound_ms=b, bound_by=by, library_ms=lib)
            if kernel.startswith("adasum"):
                row["by_mode"][mode]["two_pass_bound_ms"] = two_pass_bound_ms(ks)
            del calls
            torch.cuda.empty_cache()
    for kernel, row in rows.items():
        main = [row["by_mode"][m] for m in main_modes[kernel]
                if m in row["by_mode"]]
        keys = ("ms", "device_ms", "plain_ms", "bound_ms") + (
            ("two_pass_bound_ms",) if kernel.startswith("adasum") else ())
        for key in keys:
            row[key] = sum(m[key] for m in main)
        row["bound_by"] = ("bytes" if all(m["bound_by"] == "bytes"
                                          for m in main) else "operations")
        libs = [m["library_ms"] for m in main if m["library_ms"] is not None]
        row["library_ms"] = sum(libs) if libs else None
    return rows


def flat_buffer_checks(L: int) -> None:
    """ResNet-50's whole flat buffer, whose length does not divide the
    block, through the padding the path uses; and the reduce-scatter
    epilogues at eight synthetic senders."""
    import torch

    from horovod_tpu_torch.compression import _pad_to_block
    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(L, device=gen.device, generator=gen)
    _special_blocks(x, gen)
    xp = _pad_to_block(x, K.INT8_BLOCK)
    bad = _bits(K.quantize_roundtrip(xp), K.quantize_plain(xp, roundtrip=True))
    if bad:
        fail(f"quantize roundtrip at the flat buffer [{L}]: {bad}")
    s = -(-L // 8)
    sp = s + (-s) % 256
    for sig in (("dequant_accumulate", 8, sp),
                ("dequant_accumulate_requantize", 8, sp, 8),
                ("dequant_accumulate_requantize", 8, sp, 6),
                ("dequant_accumulate_requantize", 8, sp, 3),
                ("dequant_accumulate_requantize", 8, sp, None),
                ("dequantize_rows", 8, sp)):
        run, plain, compare = make_call(sig, gen)
        bad = compare(run(), plain())
        if bad:
            fail(f"{sig} (flat buffer, 8 senders): {bad}")


def adam_epilogue_check(L: int) -> dict:
    """B5's int8 epilogue at ``L`` (ZeRO-1's shard of ResNet-50, whose
    length does not divide the block) and at lengths shorter than a
    block: ``fused_adam_update(..., requant_block=256)`` against its plain
    version, bit for bit (update, moments, q and scales), with a NaN and
    an infinite gradient. Returns what was checked and its time."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(17)
    g = torch.randn(L, device=gen.device, generator=gen) * 1e-2
    mu = torch.randn(L, device=gen.device, generator=gen) * 1e-3
    nu = torch.rand(L, device=gen.device, generator=gen) * 1e-6
    g[300], g[1000] = math.nan, math.inf
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    c = K.adam_constants(**kw, count=3)
    for n in (L, 1000, 7):
        *out, (q, sc) = K.fused_adam_update(g[:n], mu[:n], nu[:n], 3,
                                            requant_block=256, **kw)
        *ref, (rq, rsc) = K.fused_adam_requant_plain(g[:n], mu[:n], nu[:n], c)
        bad = _bits((*out, q, sc), (*ref, rq, rsc))
        if bad:
            fail(f"fused_adam requant epilogue at [{n}]: {bad}")
    return dict(lengths=[L, 1000, 7], bit_equal=True, ms=cuda_ms(
        lambda: K.fused_adam_update(g, mu, nu, 3, requant_block=256, **kw)))


def ptxas_usage(log: str) -> dict:
    """Registers and spills of each kernel, from ``-Xptxas -v``'s report."""
    import re

    usage, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            base = re.search(r"flash_fwd_(?:mma|f32)|[a-z_]+_kernel",
                             m.group(1).split("_cu_")[-1])
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            name = (base.group(0) if base else m.group(1)) + (
                f"<{', '.join(args)}>" if args else "")
            usage[name] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            usage[name].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def adasum_extra_checks() -> list:
    """The Adasum combines at what the path does not give: zero operands
    (their coefficient is 0, and combine(0, 0) is 0), lengths that are no
    multiple of the kernel's chunk or a warp, an operand at an odd
    element offset (bit-equal to its aligned copy, which the kernel reads
    in vectors), every operand type, a segment of length 1 and an empty
    one, and packed 16-bit leaf tables whose leaves do not start on 16
    bytes. Each within the bar and bit-identical across two launches.
    Returns what was checked."""
    import torch

    from horovod_tpu_torch.ops import kernels as K

    gen = torch.Generator(device="cuda").manual_seed(11)
    dev = gen.device
    done = []

    def check(name, run, plain):
        out, ref = run(), plain()
        bad = _adasum_close(out, ref)
        if bad is None and not all(map(same_bits, out, run())):
            bad = "two launches on the same inputs differ"
        if bad:
            fail(f"adasum extra check {name}: {bad}")
        done.append(name)

    for L in (1, 7, 8193, 1 << 20):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            buf = torch.randn(2 * L + 1, device=dev, generator=gen).to(dtype)
            a, b = buf[1:L + 1], buf[L + 1:]     # a at an odd element offset
            check(f"pair L={L} {dtype} odd offset",
                  lambda: (K.adasum_pair_combine(a, b),),
                  lambda: (K.adasum_pair_combine_plain(a, b),))
            # element loads at the odd offset, vector loads on the aligned
            # copies: the same groups, so the same bits
            if not same_bits(K.adasum_pair_combine(a, b),
                             K.adasum_pair_combine(a.clone(), b.clone())):
                fail(f"adasum extra check: pair L={L} {dtype} at an odd "
                     "offset differs from its aligned copy")
    z, b = torch.zeros(600, device=dev), torch.randn(600, device=dev,
                                                     generator=gen)
    check("pair zero a", lambda: (K.adasum_pair_combine(z, b),),
          lambda: (K.adasum_pair_combine_plain(z, b),))
    if bool(K.adasum_pair_combine(z, z).any()):
        fail("adasum extra check: combine(0, 0) is not 0")
    offsets = (0, 1000, 1001, 1001, 9500, 30000)   # length 1, empty, tails
    a = torch.randn(offsets[-1], device=dev, generator=gen)
    b = torch.randn(offsets[-1], device=dev, generator=gen)
    a[1001:9500] = 0.0                                # a zero segment of a
    check(f"segments {offsets}",
          lambda: (K.adasum_segment_combine(a, b, offsets),),
          lambda: (K.adasum_segment_combine_plain(a, b, offsets),))
    for dtype in (torch.bfloat16, torch.float16):  # leaves off 16 bytes
        a16, b16 = a.to(dtype), b.to(dtype)
        check(f"packed {dtype} {offsets}",
              lambda: (K.adasum_pair_combine_packed(a16, b16, offsets),),
              lambda: (K.adasum_segment_combine_plain(a16, b16, offsets),))
    return done


def flash_extra_checks() -> list:
    """flash_fwd against its plain version at shapes the path does not
    give: GQA, non-causal, a T that is not a multiple of the tile, head
    dim 128, f32 inputs. Returns the shapes checked."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(7)
    cases = [  # (q shape, kv heads, causal, dtype)
        ((8, 2048, 16, 64), 4, True, "bfloat16"),
        ((8, 2048, 16, 64), 16, False, "bfloat16"),
        ((8, 1000, 16, 64), 16, True, "bfloat16"),
        ((2, 512, 8, 128), 8, True, "bfloat16"),
        ((2, 300, 4, 64), 2, True, "float32"),
    ]
    done = []
    for (b, t, h, d), h_kv, causal, dtype in cases:
        qs, ks = (b, t, h, d), (b, t, h_kv, d)
        strides = lambda sh: (sh[1] * sh[2] * sh[3], sh[2] * sh[3], sh[3], 1)  # noqa: E731
        sig = ("flash_fwd", qs, ks, dtype, causal, d ** -0.5, strides(qs),
               strides(ks), strides(ks))
        run, plain, compare = make_call(sig, gen)
        bad = compare(run(), plain())
        if bad:
            fail(f"flash_fwd at {sig[1:5]}: {bad}")
        done.append(sig[1:5])
        del run, plain
    torch.cuda.empty_cache()
    return done


def flash_bwd_ms(sigs) -> float:
    """CUDA-event time of the plain flash backward of all the logged
    flash_fwd calls of one step, each at its call's shape and strides."""
    import torch

    from horovod_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bwd = []
    for sig in sigs:
        run, _, _ = make_call(sig, gen)
        q, k, v, causal, scale = run.tensors
        out, lse = run()
        dout = torch.randn(out.shape, device=out.device,
                           generator=gen).to(out.dtype)
        bwd.append((q, k, v, out, lse, dout, causal, scale))
    return cuda_ms(lambda: [fa.flash_bwd(q, k, v, out, lse, dout, causal=c,
                                         sm_scale=s)
                            for q, k, v, out, lse, dout, c, s in bwd])


# --------------------------------------------------------------------------
# phase 3: a small input, GPU against CPU


def small_run(device: str) -> list:
    """Three ZeRO-1 int8 + EF fused-Adam steps of a narrow f32 ResNet in a
    world of one on ``device``; returns the losses."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import BottleneckBlock, ResNet

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = ResNet([1, 1, 1, 1], BottleneckBlock, num_filters=8,
                   num_classes=10, dtype=torch.float32, seed=7)
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 32, 32, 3, generator=gen)
    y = torch.randint(0, 10, (8,), generator=gen)
    model.to(device)
    x, y = x.to(device), y.to(device)
    tx = hvd.DistributedOptimizer(hvd.fused_adam(1e-2),
                                  compression=hvd.Compression.int8,
                                  error_feedback=True, shard_optimizer=True)
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, shard_optimizer=True)
    losses = []
    for _ in range(3):
        st, loss = step(st, x, y)
        losses.append(float(loss))
    return losses


def cpu_reference() -> None:
    import horovod_tpu_torch as hvd

    hvd.init(device="cpu")
    try:
        print(json.dumps(small_run("cpu")))
    finally:
        hvd.shutdown()


# --------------------------------------------------------------------------
# phases 4 and 5: ResNet-50 end to end


def run_steps(mode: str, step, st, x, y, steps: int):
    """``steps`` calls of ``step(st, x, y)`` with every kernel-wrapper
    call logged, launch counts set to 0 just before; fails unless the
    loss is finite and falls on the repeated batch, the logged calls
    match the launch counts and every kernel of the mode's path launched.
    Returns ``(st, losses, step seconds, launches, last step's calls)``."""
    from horovod_tpu_torch.ops import kernels as K

    calls: list = []
    K.reset_launches()                  # count the main path's run only
    losses, times = [], []
    with logging_calls(calls):
        for _ in range(steps):
            calls.append([])
            t0 = time.perf_counter()
            st, loss = step(st, x, y)
            losses.append(float(loss))  # device->host read fences the step
            times.append(time.perf_counter() - t0)
    launches = dict(K.launches)
    if not all(math.isfinite(v) for v in losses):
        fail(f"{mode}: non-finite loss {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{mode}: loss did not fall on the repeated batch: {losses}")
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != launches[k]:
            fail(f"{mode}: {launches[k]} launches of {k} but {logged} "
                 "logged calls: a caller bypasses ops.kernels' wrappers")
    for k in NEED[mode]:
        if launches[k] < 1:
            fail(f"{mode}: kernel {k} was not launched on the main path "
                 f"({launches})")
    return st, losses, times, launches, calls[-1]


def phase_timer():
    """``(marks, on_phase)``: a ``make_train_step`` phase hook that, once
    ``marks`` holds a start time, synchronises the device and records the
    time each part of the step ends."""
    import torch

    marks: dict = {}

    def on_phase(name):                 # armed only for the split step
        if marks:
            torch.cuda.synchronize()
            marks[name] = time.perf_counter()

    return marks, on_phase


def split_step(mode: str, step, st, x, y, marks) -> tuple:
    """One more step of ``step``, split into forward / backward /
    optimizer / loss allreduce by the phase hook: ``(st, {part: s})``."""
    import torch

    torch.cuda.synchronize()
    marks["start"] = time.perf_counter()
    st, loss = step(st, x, y)
    if not math.isfinite(float(loss)):
        fail(f"{mode}: non-finite loss {float(loss)} in the split step")
    names = list(marks)
    split = {b: marks[b] - marks[a] for a, b in zip(names, names[1:])}
    marks.clear()
    return st, split


def build_resnet(seed: int, device):
    """ResNet-50 at full width: bf16 compute, f32 parameters, random
    weights from ``seed``."""
    import torch

    from horovod_tpu_torch.models import ResNet50

    return ResNet50(dtype=torch.bfloat16, seed=seed, device=device)


def make_tx(mode: str):
    """The DistributedOptimizer of each ResNet-50 mode, fused Adam at 1e-3
    inside: ZeRO-1 and allreduce mode with int8 + EF, ZeRO-3 (its gather
    wire is ``HOROVOD_FSDP_WIRE``), Adasum with no compression (the
    grouped butterfly) and with ``Compression.fp16`` (the leaves packed
    in bf16, one combine of the leaf table a level)."""
    import horovod_tpu_torch as hvd

    adam = hvd.fused_adam(1e-3)
    if mode in ("zero1", "allreduce"):
        return hvd.DistributedOptimizer(adam, compression=hvd.Compression.int8,
                                        error_feedback=True,
                                        shard_optimizer=mode == "zero1")
    if mode == "zero3":
        return hvd.DistributedOptimizer(adam, shard_params=True)
    if mode == "adasum_fp16":
        return hvd.DistributedOptimizer(adam, op=hvd.Adasum,
                                        compression=hvd.Compression.fp16)
    return hvd.DistributedOptimizer(adam, op=hvd.Adasum)


def expected_launches(mode: str, n: int, leaves: int) -> dict:
    """Exact kernel launches a step where the path fixes them: fused Adam
    once over the one f32 shard (ZeRO-1, ZeRO-3) or over all ``leaves``,
    ``ADAM_MAX_LEAVES`` a launch; ZeRO-3's gather runs twice (forward,
    and the backward's recompute) over the one f32 group; allreduce
    mode's fused int8 exchange runs once over its one f32 group; Adasum's
    butterfly has log2(N) levels, each one grouped combine (``adasum``)
    or one combine of the packed bf16 leaf table (``adasum_fp16``)."""
    from horovod_tpu_torch.ops import kernels as K

    levels = n.bit_length() - 1
    adam = {"fused_adam": 1 if mode in ("zero1", "zero3")
            else -(-leaves // K.ADAM_MAX_LEAVES)}
    if mode == "zero3":
        return {"quantize": 2, "dequantize_rows": 2, **adam}
    if mode == "allreduce":
        return {"quantize": 1, "dequant_accumulate": 0,
                "dequant_accumulate_requantize": 1, "dequantize_rows": 1,
                **adam}
    if mode == "adasum":
        return {"adasum_segment_combine": levels, "adasum_pair_combine": 0,
                **adam}
    if mode == "adasum_fp16":
        return {"adasum_segment_combine": 0, "adasum_pair_combine": levels,
                **adam}
    return adam


def expected_exchanges(mode: str, n: int) -> int:
    """Point-to-point exchanges (``batch_isend_irecv``) of one optimizer
    update: one a butterfly level in the Adasum modes, none elsewhere."""
    return n.bit_length() - 1 if mode.startswith("adasum") else 0


def train(mode: str, steps: int, x, y, model_seed: int = 0) -> dict:
    """``steps`` steps of ResNet-50 on this rank's batch ``x, y`` in one
    optimizer mode; fails unless the loss is finite and falls and every
    kernel of the mode's path launched (exactly as often as
    :func:`expected_launches` says), the optimizer update made exactly
    :func:`expected_exchanges` point-to-point exchanges a step and, in
    allreduce mode, exactly :func:`allreduce_nccl_calls` NCCL calls.
    ``nccl_calls`` is the collective calls a step, in the optimizer update
    and in the rest of the step (running stats, loss);
    ``step_calls`` is the kernel calls
    of the last step; ``split_s`` one more step split into its parts;
    ``checksum`` sums the full parameters (unpacked from the shards under
    ZeRO-3)."""
    import torch

    import horovod_tpu_torch as hvd

    dev = hvd.device()
    model = build_resnet(model_seed, dev)
    leaves = len(model.jax_params())
    nccl_want = allreduce_nccl_calls(list(model.jax_params().values()))
    with torch.no_grad():           # before ZeRO-3 empties the parameters
        logits = model(x)
    if tuple(logits.shape) != (x.shape[0], 1000) or not bool(
            torch.isfinite(logits).all()):
        fail(f"ResNet-50 logits: shape {tuple(logits.shape)} or non-finite")
    del logits
    zero3 = mode == "zero3"
    wire = os.environ.pop("HOROVOD_FSDP_WIRE", None)
    if zero3:
        os.environ["HOROVOD_FSDP_WIRE"] = "int8"
    nccl, where = {}, ["step"]
    try:
        tx = make_tx(mode)
        update = tx.update

        def counted_update(*args, **kw):    # the optimizer update's calls
            where.append("update")
            try:
                return update(*args, **kw)
            finally:
                where.pop()

        tx = tx._replace(update=counted_update)
        marks, on_phase = phase_timer()
        step = hvd.make_train_step(model, tx, shard_optimizer=mode == "zero1",
                                   shard_params=zero3, on_phase=on_phase)
        st = tx.init(step.params if zero3 else model.jax_params())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with counting_collectives(nccl, where):
            st, losses, times, launches, calls = run_steps(mode, step, st, x,
                                                           y, steps)
        peak = torch.cuda.max_memory_allocated()
        st, split = split_step(mode, step, st, x, y, marks)
    finally:
        os.environ.pop("HOROVOD_FSDP_WIRE", None)
        if wire is not None:
            os.environ["HOROVOD_FSDP_WIRE"] = wire
    for k, per_step in expected_launches(mode, hvd.size(), leaves).items():
        if launches[k] != per_step * steps:
            fail(f"{mode}: {launches[k]} launches of {k} in {steps} steps, "
                 f"expected {per_step} a step ({launches})")
    p2p = nccl.get("update", {}).get("batch_isend_irecv", 0)
    if p2p != expected_exchanges(mode, hvd.size()) * steps:
        fail(f"{mode}: the optimizer update made {p2p} point-to-point "
             f"exchanges in {steps} steps, expected "
             f"{expected_exchanges(mode, hvd.size())} a step")
    if mode == "allreduce" and \
            sum(nccl.get("update", {}).values()) != nccl_want * steps:
        fail(f"allreduce: the optimizer update made {nccl.get('update')} NCCL "
             f"calls in {steps} steps, expected {nccl_want} a step")
    nccl = {part: {k: v / steps for k, v in c.items()}
            for part, c in nccl.items()}
    params = hvd.fsdp_unpack_params(step.params) if zero3 else model.jax_params()
    checksum = float(sum(p.detach().double().sum() for p in params.values()))
    steady = times[1:] if len(times) > 1 else times
    return dict(mode=mode, steps=steps, losses=losses, launches=launches,
                step_s=times, img_per_s=x.shape[0] * len(steady) / sum(steady),
                peak_gib=peak / 2 ** 30, split_s=split, checksum=checksum,
                nccl_calls=nccl, nccl_update_want=nccl_want, step_calls=calls)


def adasum_replay(x, y) -> dict:
    """The combine rank 0 makes at level 1 of a world of two, on one GPU:
    ResNet-50's gradient trees on ``x, y``'s two halves (rank 0's rows,
    then rank 1's) through the port's own functions: ``_segment_combine``
    (the grouped route, one f32 group); ``adasum_pair_combine_packed``
    over the leaves packed (``_leaf_table``, ``_pack``) in bf16 (the compressed route; ``Compression.fp16``
    puts bf16 on the wire) and in f16; ``_pair_combine`` per leaf in
    bf16, f16 and f32. Every call is logged; the grouped and the packed
    bf16 ones are the replay's launches. Each combine must agree with its
    plain version on the same operands, each packed leaf equal its
    per-leaf combine bit for bit, and the grouped result the per-leaf
    f32 one. ``projection`` is each leaf's ``|a·b| / (2 min(|a|²,
    |b|²))`` over the leaves where both are nonzero (min, median, max):
    how far these correlated halves put the combine from a plain sum;
    ``zero_leaves`` counts the leaves with a zero operand."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import adasum as A
    from horovod_tpu_torch.ops import kernels as K
    from horovod_tpu_torch.optim import tree_keys

    model = build_resnet(0, hvd.device())
    model.train()
    half = x.shape[0] // 2
    trees = []
    for rows in (slice(0, half), slice(half, None)):
        for p in model.parameters():
            p.grad = None
        hvd.softmax_xent(model(x[rows]), y[rows]).backward()
        g = model.jax_grads()
        # contiguous, as adasum_allreduce hands them to the combine
        trees.append([g[k].contiguous() for k in tree_keys(g)])
    del model
    ga, gb = trees
    sizes = tuple(a.numel() for a in ga)
    wires = (torch.bfloat16, torch.float16)
    dtypes = wires + (torch.float32,)
    name = {d: str(d).replace("torch.", "") for d in dtypes}
    calls: list = []
    modes = []
    K.reset_launches()
    with logging_calls(calls):
        calls.append([])
        modes.append("adasum_l1_replay_grouped")
        (fa, offsets), (fb, _) = A._flatten_group(ga), A._flatten_group(gb)
        grouped = A._segment_combine(fa, fb, offsets)
        packed = {}
        for dtype in wires:
            calls.append([])
            modes.append(f"adasum_l1_replay_packed_{name[dtype]}")
            starts, table = A._leaf_table(sizes, dtype.itemsize)
            pa, pb = (A._pack([t.to(dtype) for t in tree], table)
                      for tree in (ga, gb))
            packed[dtype] = (K.adasum_pair_combine_packed(pa, pb, table), pa,
                             pb, table, starts)
            if dtype == torch.bfloat16:  # the replay's launches
                launches = dict(K.launches)
        leaf = {}
        for dtype in dtypes:
            calls.append([])
            modes.append(f"adasum_l1_replay_leaf_{name[dtype]}")
            leaf[dtype] = [A._pair_combine(a.to(dtype), b.to(dtype))
                           for a, b in zip(ga, gb)]
        torch.cuda.synchronize()
    for k in K.KERNELS:
        logged = sum(sig[0] == k for c in calls for sig in c)
        if logged != K.launches[k]:
            fail(f"adasum_l1: {K.launches[k]} launches of {k} but {logged} "
                 "logged calls")
    want = {"adasum_segment_combine": 1, "adasum_pair_combine": 1}
    if any(launches[k] != v for k, v in want.items()):
        fail(f"adasum_l1: launches {launches}, expected {want}")
    err = 0.0
    ref = K.adasum_segment_combine_plain(fa, fb, offsets)
    bad = _adasum_close((grouped,), (ref,))
    if bad:
        fail(f"adasum_l1: the grouped combine against its plain version: {bad}")
    err = max(err, max_abs(grouped, ref))
    for dtype, (out, pa, pb, table, starts) in packed.items():
        ref = K.adasum_segment_combine_plain(pa, pb, table)
        bad = _adasum_close((out,), (ref,))
        if bad:
            fail(f"adasum_l1: the packed {name[dtype]} combine against its "
                 f"plain version: {bad}")
        err = max(err, max_abs(out, ref))
        for i, (lo, own) in enumerate(zip(starts, leaf[dtype])):
            if not same_bits(out[lo:lo + own.numel()], own.reshape(-1)):
                fail(f"adasum_l1: leaf {i} of the packed {name[dtype]} "
                     "combine differs from its per-leaf combine")
    for dtype in dtypes:
        for i, (a, b, out) in enumerate(zip(ga, gb, leaf[dtype])):
            ref = K.adasum_pair_combine_plain(a.to(dtype), b.to(dtype))
            bad = _adasum_close((out,), (ref,))
            if bad:
                fail(f"adasum_l1: leaf {i} in {name[dtype]} against its plain "
                     f"version: {bad}")
            err = max(err, max_abs(out, ref))
    for i, (lo, hi) in enumerate(zip(offsets, offsets[1:])):
        if not same_bits(grouped[lo:hi], leaf[torch.float32][i].reshape(-1)):
            fail(f"adasum_l1: the grouped combine of leaf {i} differs from "
                 "its per-leaf f32 combine")
    sums = [((a.double() * b.double()).sum(), torch.minimum(
        a.double().square().sum(), b.double().square().sum()))
        for a, b in zip(ga, gb)]
    # over the leaves whose operands are both nonzero (a zero-initialised
    # BatchNorm scale zeroes the gradient of the conv before it)
    proj = torch.stack([dot.abs() / (2 * n) for dot, n in sums if n > 0])
    return dict(mode="adasum_l1_replay", leaves=len(ga),
                group_elements=offsets[-1], launches=launches,
                packed_bit_equal_per_leaf=[name[d] for d in wires],
                max_abs_err_vs_plain=err,
                projection=[float(proj.min()), float(proj.median()),
                            float(proj.max())],
                zero_leaves=sum(int(n == 0) for _, n in sums),
                step_calls=dict(zip(modes, calls)))


def train_lm(steps: int) -> dict:
    """The LM slice: ``steps`` steps of the flagship TransformerLM through
    ``make_train_step`` with ``DistributedOptimizer(adamw(1e-4))`` and
    ``lm_xent``; fails unless the loss is finite and falls and flash_fwd
    launched once per layer and step. Then one more step of the same step
    function, split into its parts (``make_train_step``'s ``on_phase``)
    by synchronised host timers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import TransformerLM

    marks, on_phase = phase_timer()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 matmuls in f32
    dev = hvd.device()
    model = TransformerLM(**LM, dtype=torch.bfloat16,
                          attention_fn=hvd.flash_attention, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    tok = np.random.RandomState(0).randint(
        0, LM["vocab"], (LM_BATCH, LM_SEQ)).astype(np.int32)
    x = torch.from_numpy(tok).to(dev)
    y = torch.from_numpy(np.roll(tok, -1, axis=1)).to(dev)
    tx = hvd.DistributedOptimizer(hvd.adamw(1e-4))
    st = tx.init(model.jax_params())
    step = hvd.make_train_step(model, tx, loss_fn=hvd.lm_xent,
                               on_phase=on_phase)
    with torch.no_grad():
        logits = model(x)
    if tuple(logits.shape) != (LM_BATCH, LM_SEQ, LM["vocab"]) or not bool(
            torch.isfinite(logits).all()):
        fail(f"LM logits: shape {tuple(logits.shape)} or non-finite")
    del logits
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, losses, times, launches, calls = run_steps("lm", step, st, x, y, steps)
    if launches["flash_fwd"] != LM["depth"] * steps:
        fail(f"lm: {launches['flash_fwd']} flash_fwd launches in {steps} "
             f"steps of a depth-{LM['depth']} model ({launches})")
    peak = torch.cuda.max_memory_allocated()
    st, split = split_step("lm", step, st, x, y, marks)
    steady = times[1:]
    return dict(mode="lm", steps=steps, params=n_params, losses=losses,
                launches=launches, step_s=times,
                tokens_per_s=LM_BATCH * LM_SEQ * len(steady) / sum(steady),
                peak_gib=peak / 2 ** 30, split_s=split,
                split_step_s=sum(split.values()), step_calls=calls)


def _world_rank(modes) -> list:
    """One rank of the multi-GPU run: each mode in turn, 4 steps, each
    rank on its own rows of one global batch."""
    import torch

    import horovod_tpu_torch as hvd

    gen = torch.Generator().manual_seed(0)
    n = hvd.size()
    x = torch.randn(64 * n, 224, 224, 3, generator=gen)
    y = torch.randint(0, 1000, (64 * n,), generator=gen)
    xs, ys = hvd.shard_batch(x).to(hvd.device()), hvd.shard_batch(y).to(
        hvd.device())
    return [train(mode, 4, xs, ys) for mode in modes]


def run_gpus(n: int, modes) -> list:
    """Phase 5: rank 0's results of ``modes``, after checking that every
    rank reports the same losses and parameters."""
    from horovod_tpu_torch.testing import run_world

    try:
        res = run_world(_world_rank, n, modes, device=None, timeout=900)
    except RuntimeError as e:
        fail(f"{n} GPUs: {e}")
    for r, runs in enumerate(res):
        for o, o0 in zip(runs, res[0]):
            if o["losses"] != o0["losses"] or o["checksum"] != o0["checksum"]:
                fail(f"{n} GPUs, {o['mode']}: rank {r} diverged from rank 0")
    return res[0]


def _summary(run: dict) -> str:
    return json.dumps({k: v for k, v in run.items() if k != "step_calls"})


def main() -> None:
    if len(sys.argv) > 1 and sys.argv[1] == "--cpu-reference":
        sys.path.insert(0, ROOT)
        cpu_reference()
        return
    gpus = 1
    if len(sys.argv) > 2 and sys.argv[1] == "--gpus":
        gpus = int(sys.argv[2])

    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a GPU")
    if torch.cuda.device_count() < gpus:
        fail(f"--gpus {gpus}: only {torch.cuda.device_count()} GPUs")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    print(smi, flush=True)

    sys.path.insert(0, ROOT)
    try:
        import horovod_tpu_torch as hvd
        from horovod_tpu_torch.models import ResNet50
        from horovod_tpu_torch.ops import _build, kernels as K
    except ImportError as e:
        fail(f"horovod_tpu_torch is not importable next to chip_smoke.py: {e}")

    try:
        release = subprocess.run([_build.nvcc(), "--version"],
                                 capture_output=True, text=True, timeout=60,
                                 check=True).stdout.strip().splitlines()[-2]
    except (OSError, RuntimeError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvcc: {e}")
    print(f"nvcc: {release}", flush=True)
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          + ", ".join(f"{n} {r['seconds']:.2f} s" for n, r in report.items()),
          flush=True)
    usage = {n: ptxas_usage(r["log"]) for n, r in report.items()}
    print(f"ptxas: {json.dumps(usage)}", flush=True)

    cpu = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--cpu-reference"], capture_output=True, text=True,
                         timeout=300)
    if cpu.returncode != 0:
        fail(f"CPU reference run failed:\n{cpu.stderr[-2000:]}")
    ref = json.loads(cpu.stdout.strip().splitlines()[-1])
    hvd.init()
    try:
        got = small_run(hvd.device())
        # f32 on both sides with TF32 off: the convolutions sum in another
        # order, and the int8 wire may turn that into one quantum of
        # difference in a few gradient elements
        if not all(abs(a - b) <= 2e-3 * abs(b) + 1e-4 for a, b in zip(got, ref)):
            fail(f"small input: GPU losses {got} vs CPU {ref}")
        print(f"small input: GPU losses {got}, CPU losses {ref}", flush=True)
        torch.backends.cudnn.allow_tf32 = True

        gen = torch.Generator(device=hvd.device()).manual_seed(0)
        x = torch.randn(64, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (64,), device=hvd.device(), generator=gen)
        runs = [train("zero1", 10, x, y), train("allreduce", 5, x, y),
                train("zero3", 10, x, y), train("adasum", 5, x, y)]
        x = torch.randn(128, 224, 224, 3, device=hvd.device(), generator=gen)
        y = torch.randint(0, 1000, (128,), device=hvd.device(), generator=gen)
        replay = adasum_replay(x, y)
        del x, y
        torch.cuda.empty_cache()
        runs.append(train_lm(LM_STEPS))
        torch.cuda.empty_cache()
    finally:
        hvd.shutdown()
    for run in runs:
        print(f"e2e {run['mode']}: {_summary(run)}", flush=True)
    by_mode = {run["mode"]: run for run in runs}
    ar = by_mode["allreduce"]
    print(f"e2e allreduce: NCCL calls a step in the optimizer update "
          f"{json.dumps(ar['nccl_calls']['update'])}, "
          f"{sum(ar['nccl_calls']['update'].values()):g} in all (expected "
          f"{ar['nccl_update_want']}); in the rest of the step (running "
          f"stats, loss) {json.dumps(ar['nccl_calls'].get('step', {}))}",
          flush=True)
    z1, z3 = by_mode["zero1"], by_mode["zero3"]
    print(f"e2e zero3 (int8 gather): {z3['img_per_s']:.2f} img/s per GPU, "
          f"peak {z3['peak_gib']:.2f} GiB; zero1: {z1['img_per_s']:.2f} img/s, "
          f"peak {z1['peak_gib']:.2f} GiB ({smi})", flush=True)
    print(f"e2e adasum: {by_mode['adasum']['img_per_s']:.2f} img/s per GPU; "
          "at a world of one the butterfly has no level, so no Adasum kernel "
          "runs: the level-1 replay and --gpus N launch them", flush=True)
    print(f"adasum level-1 replay: {_summary(replay)}", flush=True)
    if gpus == 1:
        print("adasum_pair_combine and adasum_segment_combine: no run on one "
              "GPU launches them; their launches, shapes and per-step numbers "
              "below are the level-1 replay's (grouped, and per leaf in bf16)",
              flush=True)
    lm = by_mode["lm"]
    print(f"e2e lm: {lm['tokens_per_s']:.1f} tokens/s per GPU over steps "
          f"2-{lm['steps']} ({smi}; TF32 off for matmuls)", flush=True)
    step_calls = {run["mode"]: run["step_calls"] for run in runs}
    step_calls.update(replay["step_calls"])
    if gpus > 1:
        torch.cuda.empty_cache()
        for run in run_gpus(gpus, WORLD_MODES):
            run["mode"] = f"{run['mode']}@{gpus}"
            print(f"e2e {gpus} GPUs {run['mode']}: {_summary(run)}", flush=True)
            print(f"e2e {run['mode']}: {run['img_per_s']:.2f} img/s per GPU, "
                  f"peak {run['peak_gib']:.2f} GiB ({smi})", flush=True)
            step_calls[run["mode"]] = run["step_calls"]
            runs.append(run)

    meta = list(ResNet50(device="meta").jax_params().values())
    step_calls[PER_LEAF] = per_leaf_calls(meta, 1)
    L = sum(v.numel() for v in meta)
    flat_buffer_checks(L)
    epilogue = adam_epilogue_check(L)
    print(f"fused_adam requant epilogue agrees bit for bit: "
          f"{json.dumps(epilogue)}", flush=True)
    rows = kernel_phase(step_calls, main_modes(gpus))
    for name, r in rows.items():
        print(f"kernel {name}: {json.dumps(r)}", flush=True)
    extra = flash_extra_checks()
    print(f"flash_fwd extra shapes agree: {extra}", flush=True)
    print(f"adasum extra checks agree: {adasum_extra_checks()}", flush=True)
    flash_sigs = [s for s in lm["step_calls"] if s[0] == "flash_fwd"]
    flash = rows["flash_fwd"]
    # the same calls' bound at the f32 rate outside the tensor cores, the
    # arithmetic the kernel uses
    flash["bound_f32_ms"] = 1e3 * sum(
        max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
        for nbytes, ops, _ in map(call_bound, flash_sigs))
    flash["plain_bwd_ms"] = flash_bwd_ms(flash_sigs)
    print(f"lm step split (s): {json.dumps(lm['split_s'])}, sum "
          f"{lm['split_step_s']:.4f}; per step: "
          f"flash_fwd {flash['ms']:.3f} ms, its plain backward "
          f"{flash['plain_bwd_ms']:.3f} ms ({len(flash_sigs)} calls)", flush=True)

    kernels = []
    for name in K.KERNELS:
        r = rows[name]
        by_mode = {run["mode"]: run["launches"][name] for run in runs}
        if not any(by_mode.values()):   # the Adasum combines on one GPU
            by_mode[replay["mode"]] = replay["launches"][name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=TPU_KERNELS[name], launches=sum(by_mode.values()),
            launches_by_mode=by_mode,
            max_abs_err=r["max_abs_err"], ms=r["ms"], kernel_ms=r["ms"],
            device_ms=r["device_ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
        if "two_pass_bound_ms" in r:
            kernels[-1]["two_pass_bound_ms"] = r["two_pass_bound_ms"]
        for mode in YARDSTICKS:           # the calls before they were fused
            if mode in r["by_mode"]:
                kernels[-1]["per_leaf_yardstick"] = r["by_mode"][mode]
    next(k for k in kernels if k["name"] == "flash_fwd").update(
        bound_f32_ms=flash["bound_f32_ms"],
        library="F.scaled_dot_product_attention (no lse)",
        tensor_core_route="mma.sync (m16n8k16 bf16, P split hi/lo; "
                          "cp.async double buffer; bf16 inputs)",
        ptxas=usage["flash_attention"])
    next(k for k in kernels
         if k["name"] == "dequant_accumulate_requantize").update(
        ptxas=usage["int8_wire"])
    next(k for k in kernels if k["name"] == "fused_adam").update(
        launch_cap=K.ADAM_MAX_LEAVES, requant_epilogue=epilogue,
        ptxas=usage["fused_adam"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
