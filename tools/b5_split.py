#!/usr/bin/env python3
"""Split the time of ``fused_adam``'s bf16 instantiation (B5 on bf16
leaves) into its parts, and time its redesign against the kernel before
it, on one GPU, at ResNet-50's 161 leaves in bf16 (25,557,032 elements,
one launch, as ``resnet50_bf16_guarded`` steps).

    python3 tools/b5_split.py [--reps 6] [--iters 20]

Builds, beside the package's kernels, a copy of the bf16 kernel as it was
before its redesign (every operation in f32 and rounded to bf16 with the
conversion instructions, three ``__fdiv_rn`` and one ``__fsqrt_rn`` an
element, 256 threads a block, one 16-byte group a thread a chunk, 16
blocks an SM) in variants that each change one part:

- ``no_conversions``: each rounding to bf16 as integer round-to-nearest-
  even on the f32 bits, NaN kept (same bits);
- ``constant_multiply``: the divides by b1c and b2c as multiplies by
  their f32 reciprocals (for their cost);
- ``two_groups``: 128 threads a block, a thread's two 16-byte groups
  loaded before either is computed;
- ``all_three``: the three together;
- ``stream16``: no arithmetic, g, mu, nu read and written back with
  16-byte accesses in the parent's loop.

The redesign's arithmetic (the package's ``bf::adam_pair``, its source
included) in a loop without the shipped kernel's tail and unaligned
paths: ``r128`` at the shipped shape (128 threads, two groups a thread,
16 blocks an SM), ``r128_resident`` with only as many blocks as stay
resident, ``r256`` at 256 threads and one group a thread,
``r128_copy`` the shipped shape without arithmetic (the memory floor of
its access pattern), and ``r128_cs`` / ``r128_copy_cs`` the same with
streaming (evict-first) loads and stores.

Beside them: the package's kernel launched alone (``kernel``) and through
``ops.kernels.fused_adam_multi`` (``shipped``, and ``shipped_device``
with the calls queued behind a sleep of the card that outlasts their
enqueueing, so that the wrapper's host time drops out), and
``torch._fused_adam_`` over the same tensors (``library``, a yardstick
the port never calls). Every variant that keeps the plain version's
arithmetic is checked bit for bit against ``ops.kernels.fused_adam_plain``
first (the parent, ``no_conversions``, ``two_groups``, the ``r*`` loops
that compute, the kernel, the wrapper; ``constant_multiply``'s and
``all_three``'s bits are reported), and so is the package's kernel at
every bf16 pattern (``chip_smoke.adam_bf16_edge_check``). Each is timed
with CUDA events over ``--iters`` calls back to back
(``chip_smoke.cuda_ms``), in turns (the order reversed every turn).
Last, the instructions of each kernel by kind, from ``cuobjdump -sass``
(conversions, MUFU, f32 and bf16x2 arithmetic, integer), and its
registers from ``-Xptxas -v``. Prints the card's name and power limit,
then one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kChunk = 2048;
constexpr int kMaxLeaves = 256;

struct Consts {
  float omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr;
};

struct Table {
  const void* g[kMaxLeaves];
  const void* mu[kMaxLeaves];
  const void* nu[kMaxLeaves];
  void* u[kMaxLeaves];
  void* mu2[kMaxLeaves];
  void* nu2[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];
  Consts c;
  int n_leaves;
};

// x rounded to bf16, kept as f32: the conversion instructions (kConv), or
// integer round-to-nearest-even on the bits, a NaN kept as it is
template <bool kConv>
__device__ __forceinline__ float r(float x) {
  if (kConv) return __bfloat162float(__float2bfloat16_rn(x));
  const uint32_t b = __float_as_uint(x);
  const uint32_t y = (b + 0x7fffu + ((b >> 16) & 1u)) & 0xffff0000u;
  return x != x ? x : __uint_as_float(y);
}

// the bf16 bits of x (a bf16 value, or a NaN)
template <bool kConv>
__device__ __forceinline__ uint32_t bits16(float x) {
  if (kConv) return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return __float_as_uint(x) >> 16;
}

template <bool kConv, bool kMul>
__device__ __forceinline__ float adam_elem(float g, float& mu, float& nu,
                                           const Consts& c, float rb1,
                                           float rb2) {
  const float m2 = r<kConv>(__fadd_rn(r<kConv>(__fmul_rn(c.omb1, g)),
                                      r<kConv>(__fmul_rn(c.b1, mu))));
  const float v2 = r<kConv>(__fadd_rn(
      r<kConv>(__fmul_rn(c.omb2, r<kConv>(__fmul_rn(g, g)))),
      r<kConv>(__fmul_rn(c.b2, nu))));
  const float q2 = kMul ? __fmul_rn(v2, rb2) : __fdiv_rn(v2, c.b2c);
  const float den = r<kConv>(__fadd_rn(
      r<kConv>(__fsqrt_rn(r<kConv>(__fadd_rn(r<kConv>(q2), c.eps_root)))),
      c.eps));
  const float q1 = kMul ? __fmul_rn(m2, rb1) : __fdiv_rn(m2, c.b1c);
  mu = m2;
  nu = v2;
  return r<kConv>(__fmul_rn(c.neg_lr, r<kConv>(__fdiv_rn(r<kConv>(q1), den))));
}

__device__ __forceinline__ void unpack(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = __uint_as_float(w[k] << 16);
    x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <bool kConv>
__device__ __forceinline__ uint4 pack(const float (&x)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    w[k] = bits16<kConv>(x[2 * k]) | (bits16<kConv>(x[2 * k + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the parent kernel (kConv, !kMul, 256 threads) and its variants; kCopy:
// no arithmetic. Every leaf here is 16-byte aligned and a multiple of 8.
template <bool kConv, bool kMul, int kThr, bool kCopy>
__global__ void __launch_bounds__(kThr)
variant_kernel(const __grid_constant__ Table t) {
  constexpr int G = kChunk / (8 * kThr);
  Consts c = t.c;
  c = Consts{r<true>(c.omb1), r<true>(c.b1), r<true>(c.omb2), r<true>(c.b2),
             r<true>(c.b1c), r<true>(c.b2c), r<true>(c.eps),
             r<true>(c.eps_root), r<true>(c.neg_lr)};
  const float rb1 = __frcp_rn(c.b1c), rb2 = __frcp_rn(c.b2c);
  const int chunks = t.first[t.n_leaves];
  int i = 0, first = 0, end = 0;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    if (ch >= end) {
      int hi = t.n_leaves - 1;
      while (i < hi) {
        const int mid = (i + hi + 1) >> 1;
        if (t.first[mid] <= ch) i = mid; else hi = mid - 1;
      }
      first = t.first[i];
      end = t.first[i + 1];
    }
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(t.g[i]);
    const __nv_bfloat16* mu = static_cast<const __nv_bfloat16*>(t.mu[i]);
    const __nv_bfloat16* nu = static_cast<const __nv_bfloat16*>(t.nu[i]);
    __nv_bfloat16* u = static_cast<__nv_bfloat16*>(t.u[i]);
    __nv_bfloat16* mu2 = static_cast<__nv_bfloat16*>(t.mu2[i]);
    __nv_bfloat16* nu2 = static_cast<__nv_bfloat16*>(t.nu2[i]);
    const long long b0 = static_cast<long long>(ch - first) * kChunk;
    const long long b1 = min(b0 + kChunk, t.n[i]);
    uint4 vg[G], vm[G], vv[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long e = b0 + 8 * (threadIdx.x + j * kThr);
      if (e + 8 <= b1) {
        vg[j] = __ldg(reinterpret_cast<const uint4*>(g + e));
        vm[j] = __ldg(reinterpret_cast<const uint4*>(mu + e));
        vv[j] = __ldg(reinterpret_cast<const uint4*>(nu + e));
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long e = b0 + 8 * (threadIdx.x + j * kThr);
      if (e + 8 > b1) continue;
      if (kCopy) {
        *reinterpret_cast<uint4*>(u + e) = vg[j];
        *reinterpret_cast<uint4*>(mu2 + e) = vm[j];
        *reinterpret_cast<uint4*>(nu2 + e) = vv[j];
        continue;
      }
      float x[8], m[8], v[8];
      unpack(vg[j], x);
      unpack(vm[j], m);
      unpack(vv[j], v);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        x[k] = adam_elem<kConv, kMul>(x[k], m[k], v[k], c, rb1, rb2);
      *reinterpret_cast<uint4*>(u + e) = pack<kConv>(x);
      *reinterpret_cast<uint4*>(mu2 + e) = pack<kConv>(m);
      *reinterpret_cast<uint4*>(nu2 + e) = pack<kConv>(v);
    }
  }
}

template <bool kConv, bool kMul, int kThr, bool kCopy>
int run(const Table& t, int grid, cudaStream_t st) {
  variant_kernel<kConv, kMul, kThr, kCopy><<<grid, kThr, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int b5_variant(int v, const long long* ptrs, const long long* n,
                          const int* first, int k, float omb1, float b1,
                          float omb2, float b2, float b1c, float b2c,
                          float eps, float eps_root, float neg_lr,
                          void* stream) {
  if (k < 1 || k > kMaxLeaves) return static_cast<int>(cudaErrorInvalidValue);
  Table t{};
  for (int i = 0; i < k; ++i) {
    const long long* p = ptrs + 6 * i;
    t.g[i] = reinterpret_cast<const void*>(p[0]);
    t.mu[i] = reinterpret_cast<const void*>(p[1]);
    t.nu[i] = reinterpret_cast<const void*>(p[2]);
    t.u[i] = reinterpret_cast<void*>(p[3]);
    t.mu2[i] = reinterpret_cast<void*>(p[4]);
    t.nu2[i] = reinterpret_cast<void*>(p[5]);
    t.n[i] = n[i];
    t.first[i] = first[i];
    if ((n[i] & 7) || ((p[0] | p[1] | p[2] | p[3] | p[4] | p[5]) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first[k] = first[k];
  t.c = Consts{omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr};
  t.n_leaves = k;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = first[k] < 16 * sms ? first[k] : 16 * sms;
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return run<true, false, 256, false>(t, grid, st);
    case 1: return run<false, false, 256, false>(t, grid, st);
    case 2: return run<true, true, 256, false>(t, grid, st);
    case 3: return run<true, false, 128, false>(t, grid, st);
    case 4: return run<false, true, 128, false>(t, grid, st);
    case 5: return run<true, false, 256, true>(t, grid, st);
    default: return -1;
  }
}
"""

#: the redesign's arithmetic (the package's source, included) in simpler
#: loops at other block shapes: threads a block, no arithmetic (the
#: memory floor of the access pattern), and the grid: 16 blocks an SM as
#: shipped, or (0) as many as stay resident
REDESIGN_SOURCE = r"""
#include "fused_adam.cu"

namespace {

// kCs: streaming loads and stores (ld.global.cs / st.global.cs)
template <bool kCs>
__device__ __forceinline__ uint4 ld16(const uint4* p) {
  return kCs ? __ldcs(p) : __ldg(p);
}
template <bool kCs>
__device__ __forceinline__ void st16(uint4* p, const uint4& x) {
  if (kCs) __stcs(p, x); else *p = x;
}

template <int kThr, bool kCopy, bool kCs>
__global__ void __launch_bounds__(kThr)
redesign_kernel(const __grid_constant__ AdamTable t) {
  constexpr int G = kChunk / (8 * kThr);
  const bf::Consts c = bf::consts(t);
  const int chunks = t.first[t.n_leaves];
  int i = 0, end = 0;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    if (ch >= end) {
      i = leaf_of(t, ch, i);
      end = t.first[i + 1];
    }
    const long long b0 = (ch - t.first[i]) * (kChunk / 8);  // groups
    const long long b1 = min(b0 + kChunk / 8, t.n[i] / 8);
    uint4 vg[G], vm[G], vv[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long e = b0 + threadIdx.x + j * kThr;
      if (e < b1) {
        vg[j] = ld16<kCs>(static_cast<const uint4*>(t.g[i]) + e);
        vm[j] = ld16<kCs>(static_cast<const uint4*>(t.mu[i]) + e);
        vv[j] = ld16<kCs>(static_cast<const uint4*>(t.nu[i]) + e);
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const long long e = b0 + threadIdx.x + j * kThr;
      if (e >= b1) continue;
      uint4 x = vg[j];
      if (!kCopy) {
        x.x = bf::adam_pair(vg[j].x, vm[j].x, vv[j].x, c);
        x.y = bf::adam_pair(vg[j].y, vm[j].y, vv[j].y, c);
        x.z = bf::adam_pair(vg[j].z, vm[j].z, vv[j].z, c);
        x.w = bf::adam_pair(vg[j].w, vm[j].w, vv[j].w, c);
      }
      st16<kCs>(static_cast<uint4*>(t.u[i]) + e, x);
      st16<kCs>(static_cast<uint4*>(t.mu2[i]) + e, vm[j]);
      st16<kCs>(static_cast<uint4*>(t.nu2[i]) + e, vv[j]);
    }
  }
}

template <int kThr, bool kCopy, bool kCs = false>
int run_redesign(const AdamTable& t, int per, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (per == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, redesign_kernel<kThr, kCopy, kCs>, kThr, 0);
  const int chunks = t.first[t.n_leaves];
  const int grid = chunks < per * sms ? chunks : per * sms;
  redesign_kernel<kThr, kCopy, kCs><<<grid, kThr, 0, st>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int b5_redesign(int v, const long long* ptrs, const long long* n,
                           const int* first, int k, float omb1, float b1,
                           float omb2, float b2, float b1c, float b2c,
                           float eps, float eps_root, float neg_lr,
                           void* stream) {
  AdamTable t{};
  for (int i = 0; i < k; ++i) {
    const long long* p = ptrs + 6 * i;
    t.g[i] = reinterpret_cast<const void*>(p[0]);
    t.mu[i] = reinterpret_cast<const void*>(p[1]);
    t.nu[i] = reinterpret_cast<const void*>(p[2]);
    t.u[i] = reinterpret_cast<void*>(p[3]);
    t.mu2[i] = reinterpret_cast<void*>(p[4]);
    t.nu2[i] = reinterpret_cast<void*>(p[5]);
    t.n[i] = n[i];
    t.first[i] = first[i];
    if ((n[i] & 7) || ((p[0] | p[1] | p[2] | p[3] | p[4] | p[5]) & 15))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first[k] = first[k];
  t.c = AdamConsts{omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr};
  t.n_leaves = k;
  auto st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: return run_redesign<128, false>(t, 16, st);
    case 1: return run_redesign<128, false>(t, 0, st);
    case 2: return run_redesign<256, false>(t, 16, st);
    case 3: return run_redesign<128, true>(t, 16, st);
    case 4: return run_redesign<128, false, true>(t, 16, st);
    case 5: return run_redesign<128, true, true>(t, 16, st);
    default: return -1;
  }
}
"""

#: REDESIGN_SOURCE's kernels, by the code b5_redesign takes
REDESIGNS = ("r128", "r128_resident", "r256", "r128_copy", "r128_cs",
             "r128_copy_cs")
#: those that compute the update
REDESIGN_EXACT = ("r128", "r128_resident", "r256", "r128_cs")

VARIANTS = ("parent", "no_conversions", "constant_multiply", "two_groups",
            "all_three", "stream16")
#: the variants that keep the plain version's arithmetic
EXACT = ("parent", "no_conversions", "two_groups")
#: instruction kinds counted in the SASS (by opcode, modifiers dropped)
KINDS = {
    "conversion": ("F2F", "F2FP", "I2F", "F2I", "I2FP", "F2IP"),
    "mufu": ("MUFU",),
    "f32": ("FFMA", "FMUL", "FADD", "FSETP", "FSEL", "FMNMX", "FCHK"),
    "bf16x2": ("HFMA2", "HMUL2", "HADD2", "HSETP2", "HMNMX2"),
    "integer": ("IMAD", "IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL",
                "LEA", "IABS", "IMNMX"),
    "memory": ("LDG", "STG", "LDC", "ULDC"),
}


def _build_lib(build, name: str, source: str, extra=()):
    """Build ``source`` beside the package's kernels (once for its text,
    flags and the package's sources): the library's path and the log of
    its build (``-Xptxas -v``)."""
    tag = hashlib.sha256((source + " ".join(build.NVCC_FLAGS)).encode())
    for f in sorted(os.listdir(build.CSRC)):
        with open(os.path.join(build.CSRC, f), "rb") as fh:
            tag.update(fh.read())
    base = os.path.join(build.build_dir(), f"{name}-{tag.hexdigest()[:16]}")
    if not os.path.exists(base + ".so"):
        with open(base + ".cu", "w") as fh:
            fh.write(source)
        out = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, *extra, "-o",
                              base + ".so", base + ".cu"],
                             capture_output=True, text=True)
        if out.returncode:
            sys.exit(f"b5_split: nvcc failed:\n{out.stdout}{out.stderr}")
        with open(base + ".log", "w") as fh:
            fh.write(out.stdout + out.stderr)
    with open(base + ".log") as fh:
        return base + ".so", fh.read()


def c_function(path: str, symbol: str):
    """``symbol`` (b5_variant's C signature) of the library at ``path``."""
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] + [
        ctypes.c_float] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sass_counts(build, path: str) -> dict:
    """Instructions of each kernel in ``path`` by kind: ``{kernel: {kind:
    count, "total": n}}`` (the name shortened to its template arguments)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = short_name(m.group(1))
            counts[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if m and name:
            op = m.group(1)
            kind = next((k for k, ops in KINDS.items() if op in ops), "other")
            counts[name][kind] += 1
            counts[name]["total"] += 1
    return {k: dict(v) for k, v in counts.items()}


def short_name(mangled: str) -> str:
    """``variant_kernel<1, 0, 256, 0>``-like names from a mangled one."""
    base = re.search(r"\d+([a-z_]+_kernel)", mangled)
    args = re.findall(r"L[ib](\d+)E", mangled)
    return (base.group(1) if base else mangled) + (
        f"<{', '.join(args)}>" if args else "")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=6,
                    help="turns of each variant (default 6)")
    ap.add_argument("--iters", type=int, default=20,
                    help="calls timed back to back in each turn (default 20)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("b5_split: needs a GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from horovod_tpu_torch.models import ResNet50
    from horovod_tpu_torch.ops import _build, kernels as K

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    built = _build.build_all(["fused_adam"])["fused_adam"]
    variant_path, variant_log = _build_lib(_build, "b5_split", SOURCE)
    redesign_path, redesign_log = _build_lib(
        _build, "b5_redesign", REDESIGN_SOURCE, ("-I", _build.CSRC))
    fn = c_function(variant_path, "b5_variant")
    rfn = c_function(redesign_path, "b5_redesign")
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    meta = ResNet50(device="meta").jax_params().values()
    lengths = [p.numel() for p in meta]
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    gs = [(torch.randn(n, device=dev, generator=gen) * 1e-2).to(bf)
          for n in lengths]
    mus = [(torch.randn(n, device=dev, generator=gen) * 1e-3).to(bf)
           for n in lengths]
    nus = [(torch.rand(n, device=dev, generator=gen) * 1e-6).to(bf)
           for n in lengths]
    for g in gs[:8]:                    # a NaN and an inf gradient
        g[1], g[5] = math.nan, math.inf
    outs = [[torch.empty_like(g) for g in gs] for _ in range(3)]
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0)
    count = 3
    c = K.adam_constants(count=count, **kw)
    consts = [c[k] for k in ("omb1", "b1", "omb2", "b2", "b1c", "b2c", "eps",
                             "eps_root", "neg_lr")]
    ptrs = np.asarray([[x.data_ptr() for x in row] for row in zip(
        gs, mus, nus, *outs)], dtype=np.int64)
    n = np.asarray(lengths, dtype=np.int64)
    (_, first), = K.adam_launch_plan(tuple(lengths))
    table = (ptrs.ctypes.data, n.ctypes.data, first.ctypes.data, len(gs))
    kernel = K._fn("fused_adam", "hvd_fused_adam")

    def launch_variant(v):
        rc = fn(v, *table, *consts, stream)
        if rc:
            sys.exit(f"b5_split: variant {VARIANTS[v]} launch failed: {rc}")

    def launch_kernel():
        rc = kernel(*table, K.ADAM_DTYPES[bf], None, None, None, *consts,
                    stream)
        if rc:
            sys.exit(f"b5_split: kernel launch failed: {rc}")

    def launch_redesign(v):
        rc = rfn(v, *table, *consts, stream)
        if rc:
            sys.exit(f"b5_split: {REDESIGNS[v]} launch failed: {rc}")

    runs = {name: (lambda v=v: launch_variant(v))
            for v, name in enumerate(VARIANTS)}
    runs.update({name: (lambda v=v: launch_redesign(v))
                 for v, name in enumerate(REDESIGNS)})
    runs["kernel"] = launch_kernel
    runs["shipped"] = lambda: K.fused_adam_multi(gs, mus, nus, count, **kw)
    params = [torch.zeros_like(g) for g in gs]
    m2, v2 = [m.clone() for m in mus], [v.clone() for v in nus]
    steps = [torch.tensor(float(count), device=dev) for _ in gs]
    runs["library"] = lambda: torch._fused_adam_(
        params, gs, m2, v2, [], steps, lr=kw["lr"], beta1=kw["b1"],
        beta2=kw["b2"], weight_decay=0.0, eps=kw["eps"], amsgrad=False,
        maximize=False)
    plain = [K.fused_adam_plain(g, m, v, c) for g, m, v in zip(gs, mus, nus)]

    def matches(out) -> bool:
        return all(S.same_bits(a, b) for leaf, ref in zip(zip(*out), plain)
                   for a, b in zip(leaf, ref))

    bit_equal = {}
    for name in VARIANTS[:-1] + REDESIGN_EXACT + ("kernel", "shipped"):
        for o in outs:
            for x in o:
                x.fill_(0)
        out = runs[name]() or outs
        torch.cuda.synchronize()
        bit_equal[name] = matches(out)
        if name in EXACT + REDESIGN_EXACT + ("kernel", "shipped") \
                and not bit_equal[name]:
            sys.exit(f"b5_split: {name} and the plain version differ")
    edge = S.adam_bf16_edge_check()
    times = {name: [] for name in runs}
    times["shipped_device"] = []
    for rep in range(args.reps):
        order = list(times) if rep % 2 == 0 else list(times)[::-1]
        for name in order:
            if name == "shipped_device":
                times[name].append(S.cuda_device_ms(runs["shipped"],
                                                    args.iters))
            else:
                times[name].append(S.cuda_ms(runs[name], args.iters))
    elements = sum(lengths)
    result = {
        "device": smi, "reps": args.reps, "iters": args.iters,
        "leaves": len(lengths), "elements": elements,
        "bound_ms": 1e3 * 12 * elements / 3.35e12,
        "median_ms": {k: statistics.median(v) for k, v in times.items()},
        "bit_equal": bit_equal, "edge": edge,
        "sass": {**sass_counts(_build, variant_path),
                 **sass_counts(_build, redesign_path),
                 **sass_counts(_build, built["path"])},
        "ptxas": {**S.ptxas_usage(variant_log), **S.ptxas_usage(redesign_log),
                  **S.ptxas_usage(built["log"])},
        "ms": times,
    }
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
