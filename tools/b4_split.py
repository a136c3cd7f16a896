#!/usr/bin/env python3
"""Split the time of ``dequant_accumulate_requantize`` (B4, the int8
wire's allreduce epilogue) into its parts, and time its redesign and B3's
against the kernels before it, on one GPU, at the shapes ResNet-50's
allreduce-mode and ZeRO-1 steps give them.

    python3 tools/b4_split.py [--reps 6] [--iters 20]

Builds, beside the package's kernels, a copy of B4 as it was before its
redesign (a warp a 256-element scale block, 8-byte loads a sender, an
IEEE divide for Average and one for every quotient) in variants that
each drop one part:

- ``no_average_divide``: the ``acc / N`` divide left out;
- ``quotient_multiply``: ``rintf(x * (1 / sf))`` in place of
  ``rintf(x / sf)`` (not bit-exact: it shows the divide's cost only);
- ``no_warp_max``: the lane's own max used as the block's (no shuffles);
- ``one_row``: every sender's sum reads row 0 (the loads of one row);
- ``all_cut``: all four left out at once;
- ``no_conversions``: the int-to-float, rounding and float-to-int
  conversions done without conversion instructions (same bits);
- ``stream8`` / ``stream16``: no arithmetic, the rows read and the output
  written with 8- or 16-byte accesses a lane (the memory floor of each
  access width).

Beside them: the package's B4 launched alone (``kernel``) and through its
wrapper ``ops.kernels.dequant_accumulate_requantize`` (``shipped``, and
``shipped_device`` with the calls queued behind a sleep of the card, so
that the wrapper's host time drops out); the parent's exact variants,
the kernel and the wrapper must give the plain version's bits. B4's
shapes are ``[1, S]`` with divisor 1 (a world of one: the divide is
skipped) and ``[4, S / 4]`` with divisor 4, S from
``collective._quant_rows_layout`` over ResNet-50's quantizable leaves;
B3's are ZeRO-1's flat buffer as ``[1, L]`` and ``[4, L / 4]``, the old
kernel (``b3_parent``) against the package's (``b3_kernel``), bit for
bit. Each is timed with CUDA events over ``--iters`` calls back to back
(as ``chip_smoke.cuda_ms``), in turns (the order reversed every turn).
Last, the host microseconds of a wrapper call and of its parts. Prints
the card's name and power limit, then one JSON line: per shape and
variant every turn's ms and their median.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256, kLane = 8, kThreads = 256;

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// exact int8 -> float without a conversion instruction (int8_wire.cuh)
__device__ __forceinline__ float byte_float(uint32_t w, int i) {
  return __fsub_rn(__uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                               0x7540 + i)), 8388736.0f);
}

// The kernel before its redesign, with switches that drop one part each;
// kConv false: its three conversions an element done as int8_wire.cuh
// does them (same bits).
template <bool kDiv, bool kQuotDiv, bool kWarpMax, bool kAllRows,
          bool kConv = true>
__global__ void variant_kernel(const int8_t* __restrict__ q,
                               const __nv_bfloat16* __restrict__ s,
                               int8_t* __restrict__ q2,
                               __nv_bfloat16* __restrict__ s2,
                               int n, long long sp, int divisor) {
  const long long blk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk * kBlock >= sp) return;
  const long long e = blk * kBlock + lane * kLane;
  const long long nbs = sp / kBlock;
  float acc[kLane];
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.0f;
  for (int r = 0; r < n; ++r) {
    const int rr = kAllRows ? r : 0;
    union { uint2 u; int8_t b[kLane]; } pk;
    pk.u = *reinterpret_cast<const uint2*>(q + rr * sp + e);
    const float sc = __bfloat162float(s[rr * nbs + blk]);
#pragma unroll
    for (int i = 0; i < kLane; ++i) {
      const float f = kConv ? static_cast<float>(pk.b[i])
                            : byte_float(i < 4 ? pk.u.x : pk.u.y, i & 3);
      acc[i] = __fadd_rn(acc[i], __fmul_rn(f, sc));
    }
  }
  if (kDiv && divisor > 1) {
    const float dd = static_cast<float>(divisor);
#pragma unroll
    for (int i = 0; i < kLane; ++i) acc[i] = __fdiv_rn(acc[i], dd);
  }
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kLane; ++i) a = max_nan(a, fabsf(acc[i]));
  if (kWarpMax) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      a = max_nan(a, __shfl_xor_sync(0xffffffffu, a, o));
  }
  const __nv_bfloat16 sc = __float2bfloat16_rn(__fdiv_rn(a, 127.0f));
  const float sf = __bfloat162float(sc);
  const float rcp = kQuotDiv ? 0.0f : __frcp_rn(sf);
  union { int8_t b[kLane]; uint2 u; } out;
#pragma unroll
  for (int i = 0; i < kLane; ++i) {
    float v = 0.0f;
    if (sf > 0.0f) {
      v = kQuotDiv ? __fdiv_rn(acc[i], sf) : __fmul_rn(acc[i], rcp);
      v = kConv ? rintf(v) : __fsub_rn(__fadd_rn(v, 12582912.0f), 12582912.0f);
      v = (v != v) ? 0.0f : fminf(fmaxf(v, -127.0f), 127.0f);
    }
    out.b[i] = kConv ? static_cast<int8_t>(static_cast<int>(v))
                     : static_cast<int8_t>(__float_as_uint(
                           __fadd_rn(v, 12582912.0f)) & 0xff);
  }
  if (lane == 0) s2[blk] = sc;
  *reinterpret_cast<uint2*>(q2 + e) = out.u;
}

// No arithmetic: the n rows read (xor-combined) and one row written, W
// bytes a lane; the thread at a block's start copies row 0's scale.
template <typename W>
__global__ void stream_kernel(const int8_t* __restrict__ q,
                              const __nv_bfloat16* __restrict__ s,
                              int8_t* __restrict__ q2,
                              __nv_bfloat16* __restrict__ s2,
                              int n, long long sp) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x)
      * static_cast<long long>(sizeof(W));
  if (e >= sp) return;
  W v = *reinterpret_cast<const W*>(q + e);
  for (int r = 1; r < n; ++r) {
    const W w = *reinterpret_cast<const W*>(q + r * sp + e);
    v.x ^= w.x; v.y ^= w.y;
  }
  *reinterpret_cast<W*>(q2 + e) = v;
  if (e % kBlock == 0) s2[e / kBlock] = s[e / kBlock];
}

// B3 (dequant_accumulate) before its redesign
__global__ void b3_parent_kernel(const int8_t* __restrict__ q,
                                 const __nv_bfloat16* __restrict__ s,
                                 float* __restrict__ out, int n, long long sp) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kLane;
  if (e >= sp) return;
  const long long nbs = sp / kBlock;
  const long long blk = e / kBlock;
  float acc[kLane];
#pragma unroll
  for (int i = 0; i < kLane; ++i) acc[i] = 0.0f;
  for (int r = 0; r < n; ++r) {
    union { uint2 u; int8_t b[kLane]; } pk;
    pk.u = *reinterpret_cast<const uint2*>(q + r * sp + e);
    const float sc = __bfloat162float(s[r * nbs + blk]);
#pragma unroll
    for (int i = 0; i < kLane; ++i)
      acc[i] = __fadd_rn(acc[i], __fmul_rn(static_cast<float>(pk.b[i]), sc));
  }
  float4* d = reinterpret_cast<float4*>(out + e);
  d[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  d[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

unsigned int grid_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int b3_parent(const void* q, const void* s, void* out, int n,
                         long long sp, void* stream) {
  b3_parent_kernel<<<grid_for(sp / kLane), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), n, sp);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int b4_variant(int v, const void* q_, const void* s_, void* q2_,
                          void* s2_, int n, long long sp, int divisor,
                          void* stream_) {
  auto q = static_cast<const int8_t*>(q_);
  auto s = static_cast<const __nv_bfloat16*>(s_);
  auto q2 = static_cast<int8_t*>(q2_);
  auto s2 = static_cast<__nv_bfloat16*>(s2_);
  auto st = static_cast<cudaStream_t>(stream_);
  const unsigned int g = grid_for(sp / kLane);
  switch (v) {
    case 0: variant_kernel<true, true, true, true><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 1: variant_kernel<false, true, true, true><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 2: variant_kernel<true, false, true, true><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 3: variant_kernel<true, true, false, true><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 4: variant_kernel<true, true, true, false><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 5: variant_kernel<false, false, false, false><<<g, kThreads, 0, st>>>(
        q, s, q2, s2, n, sp, divisor); break;
    case 6: stream_kernel<uint2><<<g, kThreads, 0, st>>>(q, s, q2, s2, n, sp);
      break;
    case 7: stream_kernel<uint4><<<grid_for(sp / 16), kThreads, 0, st>>>(
        q, s, q2, s2, n, sp); break;
    case 8: variant_kernel<true, true, true, true, false>
        <<<g, kThreads, 0, st>>>(q, s, q2, s2, n, sp, divisor); break;
    default: return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
"""

VARIANTS = ("parent", "no_average_divide", "quotient_multiply", "no_warp_max",
            "one_row", "all_cut", "stream8", "stream16", "no_conversions")
#: the variants of the old kernel that keep its bits
EXACT = ("parent", "no_conversions")


def variant_library(build):
    """The variants' library, built beside the package's kernels."""
    tag = hashlib.sha256((SOURCE + " ".join(build.NVCC_FLAGS)).encode())
    base = os.path.join(build.build_dir(), f"b4_split-{tag.hexdigest()[:16]}")
    if not os.path.exists(base + ".so"):
        with open(base + ".cu", "w") as fh:
            fh.write(SOURCE)
        out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                              base + ".so", base + ".cu"],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"b4_split: nvcc failed:\n{out.stdout}{out.stderr}")
    lib = ctypes.CDLL(base + ".so")
    fn = lib.b4_variant
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b3 = lib.b3_parent
    b3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_void_p]
    b3.restype = ctypes.c_int
    return fn, b3


def warm_ms(torch, run, iters: int) -> float:
    """Mean ms of ``iters`` calls of ``run()`` back to back, after two."""
    run()
    run()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_ms(torch, run, iters: int) -> float:
    """As :func:`warm_ms`, with the calls queued behind a 2 ms sleep of
    the card: the device's time alone, without the host's per call."""
    run()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e-3 * 1.98e9))
    s.record()
    for _ in range(iters):
        run()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def host_us(torch, run, iters: int) -> float:
    """Host microseconds a call of ``run()`` takes to return (enqueue)."""
    import time

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def same(torch, a, b) -> bool:
    itype = torch.int8 if a.element_size() == 1 else torch.int16
    return torch.equal(a.view(itype), b.view(itype))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6,
                    help="turns of each variant (default 6)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls timed back to back in each turn (default 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("b4_split: needs a GPU")
    sys.path.insert(0, ROOT)
    from horovod_tpu_torch.compression import INT8_BLOCK, Compression
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import _build, collective as C, kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fn, b3_parent = variant_library(_build)
    sym = "hvd_dequant_accumulate_requantize"
    kernel_fns = {"kernel": K._fn("int8_wire", sym)}
    b3_fns = {"b3_parent": b3_parent,
              "b3_kernel": K._fn("int8_wire", "hvd_dequant_accumulate")}
    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream(dev).cuda_stream
    meta = ResNet50(device="meta").jax_params().values()
    sizes = tuple(p.numel() for p in meta
                  if Compression.int8.quantizes(p.shape, p.dtype))
    gen = torch.Generator(device=dev).manual_seed(0)
    result = {"device": smi, "reps": args.reps, "iters": args.iters,
              "shapes": {}}
    for n in (1, 4):
        sp = C._quant_rows_layout(sizes, n, INT8_BLOCK)[2]
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, sp // INT8_BLOCK, device=dev, generator=gen)
             * 1e-2).to(torch.bfloat16)
        q2 = torch.empty(sp, dtype=torch.int8, device=dev)
        s2 = torch.empty(sp // INT8_BLOCK, dtype=torch.bfloat16, device=dev)
        args_ = (q.data_ptr(), s.data_ptr(), q2.data_ptr(), s2.data_ptr(), n,
                 sp, n, stream)

        def launch(v, args_=args_):
            rc = fn(v, *args_)
            if rc:
                sys.exit(f"b4_split: variant {v} launch failed: {rc}")

        def launch_kernel(f, args_=args_):
            rc = f(*args_)
            if rc:
                sys.exit(f"b4_split: kernel launch failed: {rc}")

        runs = {name: (lambda v=v: launch(v)) for v, name in enumerate(VARIANTS)}
        runs.update({name: (lambda f=f: launch_kernel(f))
                     for name, f in kernel_fns.items()})
        runs["shipped"] = lambda q=q, s=s, n=n: \
            K.dequant_accumulate_requantize(q, s, divisor=n)
        plain = K.dequant_accumulate_requantize_plain(q, s, divisor=n)
        for name in EXACT + tuple(kernel_fns) + ("shipped",):
            q2.zero_()
            s2.zero_()
            out = runs[name]() or (q2, s2)
            if not all(same(torch, a, b) for a, b in zip(out, plain)):
                sys.exit(f"b4_split: at [{n}, {sp}] {name} and the plain "
                         "version differ")
        times = {name: [] for name in runs}
        times["shipped_device"] = []
        for rep in range(args.reps):
            order = list(times) if rep % 2 == 0 else list(times)[::-1]
            for name in order:
                if name == "shipped_device":
                    times[name].append(device_ms(torch, runs["shipped"],
                                                 args.iters))
                else:
                    times[name].append(warm_ms(torch, runs[name], args.iters))
        wire = n * sp + 2 * n * (sp // INT8_BLOCK)
        nbytes = wire + sp + 2 * (sp // INT8_BLOCK)
        result["shapes"][f"[{n}, {sp}] / {n}"] = {
            "bound_ms": 1e3 * nbytes / 3.35e12,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "host_us": {k: host_us(torch, runs[k], 200)
                        for k in ("kernel", "shipped")},
            "ms": times}
        del q, s, q2, s2
    flat = sum(p.numel() for p in ResNet50(device="meta").jax_params().values())
    for n in (1, 4):                    # B3 at ZeRO-1's flat buffer
        sp = (flat + (-flat) % (n * INT8_BLOCK)) // n
        q = torch.randint(-127, 128, (n, sp), device=dev, generator=gen,
                          dtype=torch.int8)
        s = (torch.rand(n, sp // INT8_BLOCK, device=dev, generator=gen)
             * 1e-2).to(torch.bfloat16)
        out = torch.empty(sp, dtype=torch.float32, device=dev)
        runs = {name: (lambda f=f, a=(q.data_ptr(), s.data_ptr(),
                                      out.data_ptr(), n, sp, stream): f(*a))
                for name, f in b3_fns.items()}
        plain = K.dequant_accumulate_plain(q, s)
        for name, run in runs.items():
            out.zero_()
            if run() or not torch.equal(out.view(torch.int32),
                                        plain.view(torch.int32)):
                sys.exit(f"b4_split: B3 {name} at [{n}, {sp}] differs")
        times = {name: [] for name in runs}
        for rep in range(args.reps):
            order = list(runs) if rep % 2 == 0 else list(runs)[::-1]
            for name in order:
                times[name].append(warm_ms(torch, runs[name], args.iters))
        result["shapes"][f"B3 [{n}, {sp}]"] = {
            "bound_ms": 1e3 * (n * sp + 2 * n * (sp // INT8_BLOCK) + 4 * sp)
            / 3.35e12,
            "median_ms": {k: statistics.median(v) for k, v in times.items()},
            "ms": times}
        del q, s, out
    # where a wrapper call's host time goes
    q = torch.zeros(4, 4096, dtype=torch.int8, device=dev)
    s = torch.zeros(4, 16, dtype=torch.bfloat16, device=dev)
    q2 = torch.empty(4096, dtype=torch.int8, device=dev)
    s2 = torch.empty(16, dtype=torch.bfloat16, device=dev)

    def ctx():
        with torch.cuda.device(dev):
            pass

    raw = kernel_fns["kernel"]
    result["host_us_small"] = {name: host_us(torch, run, 500) for name, run in {
        "torch.empty": lambda: torch.empty(4096, dtype=torch.int8, device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "device_ctx": ctx,
        "on_cuda": lambda: K._on_cuda(q, s),
        "check_wire": lambda: K._check_wire(q, s, INT8_BLOCK),
        "ctypes_launch": lambda: raw(q.data_ptr(), s.data_ptr(), q2.data_ptr(),
                                     s2.data_ptr(), 4, 4096, 4, stream),
        "wrapper": lambda: K.dequant_accumulate_requantize(q, s, divisor=4),
    }.items()}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
