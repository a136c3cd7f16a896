// Fused Adam update on Hopper: moments, bias correction and the -lr step
// in one pass, over every tensor of a step in one launch.
//
// Replaces horovod_tpu/ops/pallas_kernels.py: fused_adam_update /
// _adam_kernel, its optional requant_block epilogue included (the update
// quantized to the blockwise int8 wire image in the same pass).
//
// Expression order is optax's scale_by_adam -> scale(-lr):
//   mu' = (1-b1)*g + b1*mu
//   nu' = (1-b2)*(g*g) + b2*nu
//   u   = -lr * ((mu'/b1c) / (sqrt(nu'/b2c + eps_root) + eps))
// each operation rounded on its own (__f*_rn: no FMA contraction). The
// constants (1-b1), (1-b2), -lr and the bias corrections b1c = 1-b1^t,
// b2c = 1-b2^t arrive as f32 values computed on the host, as JAX casts
// its Python doubles.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Per element it reads g, mu,
// nu and writes u, mu', nu' (24 bytes in f32, 12 in bf16) for ~12
// operations: 0.5-1 operations per byte against the card's ~20.
//
// Dispatch. The reference runs one Pallas call per leaf, all fused into
// one XLA program under jit; here a step's leaves (161 for ResNet-50) go
// to ONE launch. Its table (each leaf's six pointers, its length, its
// first chunk and whether all six pointers are 16-byte aligned) is the
// kernel's __grid_constant__ parameter: no host-to-device copy, nothing
// to synchronise (CUDA 12.1 allows 32,764 bytes of parameters on sm_90;
// kMaxLeaves fits the table in them). The leaves are cut into chunks of
// kChunk elements, chunk c being chunk c - first[i] of the last leaf i
// with first[i] <= c; 16 blocks an SM walk the chunks grid-stride, a
// block looking its leaf up again only when a chunk leaves it, in 16-byte
// groups where the leaf is aligned and one element a thread otherwise
// (Adasum's leaves are views into one group buffer at any offset). A flat
// shard (ZeRO-1, ZeRO-3) thus keeps the grid and the loop of the one-leaf
// kernel this replaces.
//
// Element types. One launch takes leaves of one type (the wrapper groups
// a call's leaves by dtype): adam_kernel f32 leaves, the expressions
// above, 256 threads a block, one 16-byte group (4 f32) a thread a chunk;
// adam_pair_kernel bf16 leaves.
//
// bf16 leaves take the reference's bf16 arithmetic: every operation on two
// bf16 values, its f32 result (__f*_rn) rounded to bf16, the constants
// rounded to bf16 first, the square root correctly rounded in f32 before
// its own rounding (what optax's weakly typed constants and the
// reference's kernel compute). Done so, an operation and its rounding are
// two to four instructions an element (a conversion among them, on the
// SM's quarter-rate pipe) and each divide a multi-instruction __fdiv_rn.
// adam_pair_kernel gets the same bits two elements a 32-bit word:
// - * and + are one fma.rn.bf16x2 (a*b + -0, a*1 + b), the exact result
//   rounded once to bf16, which equals the f32 rounding followed by the
//   bf16 one for every pair of bf16 operands;
// - the divides by b1c and b2c multiply by their f32 reciprocals (once a
//   launch), the divide by den multiplies by rcp.approx(den), the square
//   root is sqrt.approx: each within 2^-22 of the correctly rounded f32
//   value, which decides no bf16 rounding of a quotient or root of bf16
//   values in the normal range. Where an operand or a quotient leaves
//   that range (a reciprocal that is not a normal f32, a den quotient
//   nearer 0 than 2^-125, a root of a subnormal or a negative), the pair
//   takes __fdiv_rn / __fsqrt_rn;
// - the four f32 results round to bf16 two at a time (cvt.rn.bf16x2.f32).
// tests/test_torch_adam_bf16_rounding.py holds a numpy model of these
// lines against the f32 operation followed by bf16 rounding. A bf16 block
// (adam_pair_kernel) is 128 threads, two 16-byte groups (8 bf16 each) a
// thread a chunk, both loaded before either is computed.
//
// Bias corrections. By value, or (bc non-null) read from a device buffer
// [b1c, b2c]: a guarded optimizer's step count lives on the device (a
// skipped step keeps it without a host read), so its bias corrections
// are computed there, as the reference's kernel takes its traced ones.
//
// The epilogue (f32, one leaf only): each warp takes whole 256-element
// blocks, eight elements a lane, quantizes the update with int8_wire.cuh's
// requant_lane and writes q and the bf16 scale. The tail past the leaf's
// length is the update of zero g, mu, nu, as the reference pads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_wire.cuh"

#if CUDART_VERSION < 12010
#error "fused_adam.cu passes a 16 KB table as a kernel parameter: CUDA 12.1 or later"
#endif

namespace {

constexpr int kThreads = 256;           // f32: a 16-byte group a thread
constexpr int kThreads16 = 128;         // bf16: two 16-byte groups a thread
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 2048;      // ops.kernels.ADAM_CHUNK
constexpr int kGroups16 = kChunk / (8 * kThreads16);
constexpr int kMaxLeaves = 256;         // ops.kernels.ADAM_MAX_LEAVES
static_assert(kChunk % (4 * kThreads) == 0 && kGroups16 == 2 &&
                  kChunk % hvdt::kBlock == 0,
              "a chunk is whole 16-byte rounds and whole int8 blocks");

struct AdamConsts {
  float omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr;
};

struct AdamTable {
  const void* g[kMaxLeaves];
  const void* mu[kMaxLeaves];
  const void* nu[kMaxLeaves];
  void* u[kMaxLeaves];
  void* mu2[kMaxLeaves];
  void* nu2[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];            // each leaf's first chunk; the total
  unsigned char vec[kMaxLeaves];        // all six pointers 16-byte aligned
  int8_t* q;                            // the epilogue's outputs, or null
  __nv_bfloat16* s;
  const float* bc;                      // device [b1c, b2c], or null
  AdamConsts c;
  int n_leaves;
};
static_assert(sizeof(AdamTable) <= 32764, "kernel parameters over 32,764 B");

// one f32 element: the expressions of the header
__device__ __forceinline__ float adam_elem(float g, float& mu, float& nu,
                                           const AdamConsts& c) {
  const float m2 = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, mu));
  const float v2 = __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(g, g)),
                             __fmul_rn(c.b2, nu));
  const float den = __fadd_rn(
      __fsqrt_rn(__fadd_rn(__fdiv_rn(v2, c.b2c), c.eps_root)), c.eps);
  mu = m2;
  nu = v2;
  return __fmul_rn(c.neg_lr, __fdiv_rn(__fdiv_rn(m2, c.b1c), den));
}

// the f32 step's constants: bias corrections from the device buffer when
// there is one
__device__ __forceinline__ AdamConsts consts_f32(const AdamTable& t) {
  AdamConsts c = t.c;
  if (t.bc != nullptr) {
    c.b1c = t.bc[0];
    c.b2c = t.bc[1];
  }
  return c;
}

// bf16, two elements a 32-bit word (the low half the first) --------------
namespace bf {

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// f32 l and h rounded to bf16 (to nearest even) and packed
__device__ __forceinline__ uint32_t pack(float l, float h) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
  return d;
}

// a * b + c on both halves, the exact result rounded once to bf16
__device__ __forceinline__ uint32_t fma2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a * b (+ -0 keeps an exact product's sign of zero) and a + b
__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  return fma2(a, b, 0x80008000u);
}
__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  return fma2(a, 0x3f803f80u, b);
}

// 1 / b is a normal f32, or b is 0, inf or NaN (whose reciprocals give
// the quotient's own inf, 0 or NaN)
__device__ __forceinline__ bool rcp_fits(float b) {
  const float a = fabsf(b);
  return (a >= 0x1p-126f && a <= 0x1p126f) || a == 0.0f ||
         a == __int_as_float(0x7f800000) || a != a;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// a / b for a launch's constant b, rcp = __frcp_rn(b), fast = rcp_fits(b)
__device__ __forceinline__ uint32_t div_const(uint32_t a, float b, float rcp,
                                              bool fast) {
  if (fast) return pack(__fmul_rn(lo(a), rcp), __fmul_rn(hi(a), rcp));
  return pack(__fdiv_rn(lo(a), b), __fdiv_rn(hi(a), b));
}

// a quotient the approximate reciprocal may give: 0, or not below 2^-125
__device__ __forceinline__ bool quotient_fits(float q) {
  return !(fabsf(q) < 0x1p-125f) || q == 0.0f;
}

// a / d, both pairs of bf16 values
__device__ __forceinline__ uint32_t div_pair(uint32_t a, uint32_t d) {
  const float dl = lo(d), dh = hi(d);
  if (rcp_fits(dl) && rcp_fits(dh)) {
    const float ql = __fmul_rn(lo(a), rcp_approx(dl));
    const float qh = __fmul_rn(hi(a), rcp_approx(dh));
    if (quotient_fits(ql) && quotient_fits(qh)) return pack(ql, qh);
  }
  return pack(__fdiv_rn(lo(a), dl), __fdiv_rn(hi(a), dh));
}

// a root's operand sqrt.approx takes: a normal, +inf, or 0 (kept as is)
__device__ __forceinline__ bool root_fits(float t) {
  return t >= 0x1p-126f || t == 0.0f;
}

__device__ __forceinline__ uint32_t root(uint32_t t) {
  const float l = lo(t), h = hi(t);
  if (root_fits(l) && root_fits(h))
    return pack(l == 0.0f ? l : sqrt_approx(l),
                h == 0.0f ? h : sqrt_approx(h));
  return pack(__fsqrt_rn(l), __fsqrt_rn(h));
}

// the step's constants: each bf16 value twice in a word; b1c, b2c as
// bf16 values with their f32 reciprocals
struct Consts {
  uint32_t omb1, b1, omb2, b2, eps, eps_root, neg_lr;
  float b1c, b2c, rcp1, rcp2;
  bool fast1, fast2;
};

__device__ __forceinline__ uint32_t twice(float x) {
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(x));
  return h | (h << 16);
}

__device__ __forceinline__ Consts consts(const AdamTable& t) {
  const AdamConsts a = consts_f32(t);
  Consts c;
  c.omb1 = twice(a.omb1);
  c.b1 = twice(a.b1);
  c.omb2 = twice(a.omb2);
  c.b2 = twice(a.b2);
  c.eps = twice(a.eps);
  c.eps_root = twice(a.eps_root);
  c.neg_lr = twice(a.neg_lr);
  c.b1c = lo(twice(a.b1c));
  c.b2c = lo(twice(a.b2c));
  c.rcp1 = __frcp_rn(c.b1c);
  c.rcp2 = __frcp_rn(c.b2c);
  c.fast1 = rcp_fits(c.b1c);
  c.fast2 = rcp_fits(c.b2c);
  return c;
}

// one Adam step of two elements: g, mu, nu in; u, mu', nu' out
__device__ __forceinline__ uint32_t adam_pair(uint32_t g, uint32_t& mu,
                                              uint32_t& nu, const Consts& c) {
  const uint32_t m2 = add(mul(c.omb1, g), mul(c.b1, mu));
  const uint32_t v2 = add(mul(c.omb2, mul(g, g)), mul(c.b2, nu));
  const uint32_t t2 = add(div_const(v2, c.b2c, c.rcp2, c.fast2), c.eps_root);
  const uint32_t den = add(root(t2), c.eps);
  mu = m2;
  nu = v2;
  return mul(c.neg_lr, div_pair(div_const(m2, c.b1c, c.rcp1, c.fast1), den));
}

}  // namespace bf

// the epilogue's 256-element blocks of [b0, b1): eight elements a lane
__device__ __forceinline__ void adam_requant(const AdamTable& t,
                                             const AdamConsts& c, long long b0,
                                             long long b1) {
  const float* g = static_cast<const float*>(t.g[0]);
  const float* mu = static_cast<const float*>(t.mu[0]);
  const float* nu = static_cast<const float*>(t.nu[0]);
  float* u = static_cast<float*>(t.u[0]);
  float* mu2 = static_cast<float*>(t.mu2[0]);
  float* nu2 = static_cast<float*>(t.nu2[0]);
  const long long n = t.n[0];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long blk = b0 + warp * hvdt::kBlock; blk < b1;
       blk += kWarps * hvdt::kBlock) {
    const long long e = blk + hvdt::kLane * lane;
    const bool whole = t.vec[0] && e + hvdt::kLane <= n;
    float x[hvdt::kLane], m[hvdt::kLane], v[hvdt::kLane];
    if (whole) {
      hvdt::load8(g + e, x);
      hvdt::load8(mu + e, m);
      hvdt::load8(nu + e, v);
    } else {
#pragma unroll
      for (int k = 0; k < hvdt::kLane; ++k) {
        const bool in = e + k < n;
        x[k] = in ? g[e + k] : 0.f;
        m[k] = in ? mu[e + k] : 0.f;
        v[k] = in ? nu[e + k] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < hvdt::kLane; ++k)
      x[k] = adam_elem(x[k], m[k], v[k], c);
    if (whole) {
      hvdt::store(u + e, x);
      hvdt::store(mu2 + e, m);
      hvdt::store(nu2 + e, v);
    } else {
#pragma unroll
      for (int k = 0; k < hvdt::kLane; ++k) {
        if (e + k < n) {
          u[e + k] = x[k];
          mu2[e + k] = m[k];
          nu2[e + k] = v[k];
        }
      }
    }
    uint2 q;
    float d[hvdt::kLane];
    const __nv_bfloat16 sc = hvdt::requant_lane(x, q, d);  // the whole warp
    *reinterpret_cast<uint2*>(t.q + e) = q;
    if (lane == 0) t.s[blk / hvdt::kBlock] = sc;
  }
}

// one f32 leaf's pointers, as a block keeps them while its chunks stay in it
struct Leaf {
  const float *g, *mu, *nu;
  float *u, *mu2, *nu2;
  long long n;
  int first, end;                       // its chunks [first, end)
  bool vec;
};

// elements [b0, b1) of an f32 leaf: 16-byte groups with a scalar tail, or
// one element a thread for an unaligned leaf
__device__ __forceinline__ void adam_chunk(const Leaf& f, const AdamConsts& c,
                                           long long b0, long long b1) {
  const float* __restrict__ g = f.g;
  const float* __restrict__ mu = f.mu;
  const float* __restrict__ nu = f.nu;
  float* __restrict__ u = f.u;
  float* __restrict__ mu2 = f.mu2;
  float* __restrict__ nu2 = f.nu2;
  if (f.vec) {
    for (long long e = b0 + 4 * threadIdx.x; e < b1; e += 4 * kThreads) {
      if (e + 4 <= b1) {                // read-only path for the inputs
        const float4 x = __ldg(reinterpret_cast<const float4*>(g + e));
        float4 m = __ldg(reinterpret_cast<const float4*>(mu + e));
        float4 v = __ldg(reinterpret_cast<const float4*>(nu + e));
        const float4 d = make_float4(adam_elem(x.x, m.x, v.x, c),
                                     adam_elem(x.y, m.y, v.y, c),
                                     adam_elem(x.z, m.z, v.z, c),
                                     adam_elem(x.w, m.w, v.w, c));
        *reinterpret_cast<float4*>(u + e) = d;
        *reinterpret_cast<float4*>(mu2 + e) = m;
        *reinterpret_cast<float4*>(nu2 + e) = v;
      } else {                          // the leaf's ragged tail
        for (long long k = e; k < b1; ++k) {
          float m = mu[k], v = nu[k];
          u[k] = adam_elem(g[k], m, v, c);
          mu2[k] = m;
          nu2[k] = v;
        }
      }
    }
  } else {
    for (long long k = b0 + threadIdx.x; k < b1; k += kThreads) {
      float m = mu[k], v = nu[k];
      u[k] = adam_elem(g[k], m, v, c);
      mu2[k] = m;
      nu2[k] = v;
    }
  }
}

// the last leaf i with first[i] <= ch, searching up from i
__device__ __forceinline__ int leaf_of(const AdamTable& t, int ch, int i) {
  int hi = t.n_leaves - 1;
  while (i < hi) {
    const int mid = (i + hi + 1) >> 1;
    if (t.first[mid] <= ch) i = mid; else hi = mid - 1;
  }
  return i;
}

// f32 leaves (with the int8 epilogue: one leaf)
template <bool kRequant>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ AdamTable t) {
  const AdamConsts c = consts_f32(t);
  const int chunks = t.first[t.n_leaves];
  int i = 0;
  Leaf f{};                             // f.end = 0: found at the first chunk
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    if (ch >= f.end) {
      i = leaf_of(t, ch, i);
      f = Leaf{static_cast<const float*>(t.g[i]),
               static_cast<const float*>(t.mu[i]),
               static_cast<const float*>(t.nu[i]), static_cast<float*>(t.u[i]),
               static_cast<float*>(t.mu2[i]), static_cast<float*>(t.nu2[i]),
               t.n[i], t.first[i], t.first[i + 1], t.vec[i] != 0};
    }
    const long long b0 = static_cast<long long>(ch - f.first) * kChunk;
    if constexpr (kRequant) {           // whole int8 blocks, zero-padded
      const long long nq =
          (f.n + hvdt::kBlock - 1) / hvdt::kBlock * hvdt::kBlock;
      adam_requant(t, c, b0, min(b0 + kChunk, nq));
    } else {
      adam_chunk(f, c, b0, min(b0 + kChunk, f.n));
    }
  }
}

// element k of bf16 leaf i, alone (the low half of a pair)
__device__ __forceinline__ void adam_one(const AdamTable& t, int i,
                                         const bf::Consts& c, long long k) {
  auto in = [&](const void* p) -> uint32_t {
    return __bfloat16_as_ushort(static_cast<const __nv_bfloat16*>(p)[k]);
  };
  auto out = [&](void* p, uint32_t w) {
    static_cast<__nv_bfloat16*>(p)[k] =
        __ushort_as_bfloat16(static_cast<unsigned short>(w));
  };
  uint32_t m = in(t.mu[i]), v = in(t.nu[i]);
  out(t.u[i], bf::adam_pair(in(t.g[i]), m, v, c));
  out(t.mu2[i], m);
  out(t.nu2[i], v);
}

// bf16 leaves. A chunk of leaf i: a thread's two 16-byte groups loaded
// before either is computed, then a scalar tail; one element a thread
// for an unaligned leaf. The leaf's pointers are read from the table at
// each chunk (nothing held across chunks but its index).
__global__ void __launch_bounds__(kThreads16)
adam_pair_kernel(const __grid_constant__ AdamTable t) {
  const bf::Consts c = bf::consts(t);
  const int chunks = t.first[t.n_leaves];
  int i = 0, end = 0;
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    if (ch >= end) {
      i = leaf_of(t, ch, i);
      end = t.first[i + 1];
    }
    const long long b0 = static_cast<long long>(ch - t.first[i]) * kChunk;
    const long long b1 = min(b0 + kChunk, t.n[i]);
    if (!t.vec[i]) {
      for (long long k = b0 + threadIdx.x; k < b1; k += kThreads16)
        adam_one(t, i, c, k);
      continue;
    }
    const uint4* g = static_cast<const uint4*>(t.g[i]);
    const uint4* mu = static_cast<const uint4*>(t.mu[i]);
    const uint4* nu = static_cast<const uint4*>(t.nu[i]);
    uint4 x[kGroups16], m[kGroups16], v[kGroups16];
#pragma unroll
    for (int j = 0; j < kGroups16; ++j) {
      const long long e = b0 / 8 + threadIdx.x + j * kThreads16;  // group
      if (8 * e + 8 <= b1) {
        x[j] = __ldg(g + e);
        m[j] = __ldg(mu + e);
        v[j] = __ldg(nu + e);
      }
    }
#pragma unroll
    for (int j = 0; j < kGroups16; ++j) {
      const long long e = b0 / 8 + threadIdx.x + j * kThreads16;
      if (8 * e + 8 <= b1) {
        x[j].x = bf::adam_pair(x[j].x, m[j].x, v[j].x, c);
        x[j].y = bf::adam_pair(x[j].y, m[j].y, v[j].y, c);
        x[j].z = bf::adam_pair(x[j].z, m[j].z, v[j].z, c);
        x[j].w = bf::adam_pair(x[j].w, m[j].w, v[j].w, c);
        static_cast<uint4*>(t.u[i])[e] = x[j];
        static_cast<uint4*>(t.mu2[i])[e] = m[j];
        static_cast<uint4*>(t.nu2[i])[e] = v[j];
      } else {                          // the leaf's ragged tail
        for (long long k = 8 * e; k < b1; ++k) adam_one(t, i, c, k);
      }
    }
  }
}

// the grid: 16 blocks an SM, or one a chunk when there are fewer
int grid_cap() {
  static int cap = 0;
  if (cap == 0) {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cap = 16 * sms;
  }
  return cap;
}

int launch(void (*kernel)(AdamTable), int threads, const long long* ptrs,
           const long long* n, const int* first, int k, void* q, void* s,
           const float* bc, const AdamConsts& c, cudaStream_t stream) {
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
    t.vec[i] = ((p[0] | p[1] | p[2] | p[3] | p[4] | p[5]) & 15) == 0;
    if (first[i + 1] - first[i] != (n[i] + kChunk - 1) / kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first[k] = first[k];
  t.q = static_cast<int8_t*>(q);
  t.s = static_cast<__nv_bfloat16*>(s);
  t.bc = bc;
  t.c = c;
  t.n_leaves = k;
  if (first[k] == 0) return 0;
  const int cap = grid_cap();
  if (cap == 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidDevice);
  }
  const unsigned int grid =
      static_cast<unsigned int>(first[k] < cap ? first[k] : cap);
  kernel<<<grid, threads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k leaves (1 <= k <= kMaxLeaves) of one element type (dtype 0: f32,
// 1: bf16): ptrs [k][6] = g, mu, nu, u, mu2, nu2, n [k] their lengths,
// first [k + 1] each leaf's first chunk (ceil(n / kChunk) chunks a leaf;
// first[k] is the total). With q and s (f32, k == 1 only) the update's
// int8 wire image: q [ceil(n/256)*256], s bf16 [ceil(n/256)]. With bc
// the bias corrections are read from the device's [b1c, b2c] (f32), and
// the b1c, b2c arguments are ignored.
int hvd_fused_adam(const long long* ptrs, const long long* n, const int* first,
                   int k, int dtype, void* q, void* s, const float* bc,
                   float omb1, float b1, float omb2, float b2, float b1c,
                   float b2c, float eps, float eps_root, float neg_lr,
                   void* stream) {
  if (k < 1 || k > kMaxLeaves || (q == nullptr) != (s == nullptr) ||
      (q != nullptr && (k != 1 || dtype != 0)) || first[0] != 0 ||
      dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamConsts c{omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q != nullptr)
    return launch(adam_kernel<true>, kThreads, ptrs, n, first, k, q, s, bc, c,
                  st);
  if (dtype == 1)
    return launch(adam_pair_kernel, kThreads16, ptrs, n, first, k, q, s, bc,
                  c, st);
  return launch(adam_kernel<false>, kThreads, ptrs, n, first, k, q, s, bc, c,
                st);
}

}  // extern "C"
