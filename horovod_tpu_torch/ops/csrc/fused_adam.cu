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
// nu (12 bytes) and writes u, mu', nu' (12 bytes) for ~12 f32
// operations: 0.5 operations per byte against the card's ~20.
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
// block looking its leaf up again only when a chunk leaves it, in float4s
// where the leaf is aligned and one element a thread otherwise (Adasum's
// leaves are views into one group buffer at any offset). A flat shard
// (ZeRO-1, ZeRO-3) thus keeps the grid and the loop of the one-leaf
// kernel this replaces.
//
// The epilogue (one leaf only): each warp takes whole 256-element blocks,
// eight elements a lane, quantizes the update with int8_wire.cuh's
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 2048;      // ops.kernels.ADAM_CHUNK
constexpr int kMaxLeaves = 256;         // ops.kernels.ADAM_MAX_LEAVES
static_assert(kChunk % (4 * kThreads) == 0 && kChunk % hvdt::kBlock == 0,
              "a chunk is whole float4 rounds and whole int8 blocks");

struct AdamConsts {
  float omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr;
};

struct AdamTable {
  const float* g[kMaxLeaves];
  const float* mu[kMaxLeaves];
  const float* nu[kMaxLeaves];
  float* u[kMaxLeaves];
  float* mu2[kMaxLeaves];
  float* nu2[kMaxLeaves];
  long long n[kMaxLeaves];
  int first[kMaxLeaves + 1];            // each leaf's first chunk; the total
  unsigned char vec[kMaxLeaves];        // all six pointers 16-byte aligned
  int8_t* q;                            // the epilogue's outputs, or null
  __nv_bfloat16* s;
  AdamConsts c;
  int n_leaves;
};
static_assert(sizeof(AdamTable) <= 32764, "kernel parameters over 32,764 B");

__device__ __forceinline__ float adam_elem(float g, float& mu, float& nu,
                                           const AdamConsts& c) {
  const float m2 = __fadd_rn(__fmul_rn(c.omb1, g), __fmul_rn(c.b1, mu));
  const float v2 =
      __fadd_rn(__fmul_rn(c.omb2, __fmul_rn(g, g)), __fmul_rn(c.b2, nu));
  const float den =
      __fadd_rn(__fsqrt_rn(__fadd_rn(__fdiv_rn(v2, c.b2c), c.eps_root)), c.eps);
  mu = m2;
  nu = v2;
  return __fmul_rn(c.neg_lr, __fdiv_rn(__fdiv_rn(m2, c.b1c), den));
}

// the epilogue's 256-element blocks of [b0, b1): eight elements a lane
__device__ __forceinline__ void adam_requant(const AdamTable& t, long long b0,
                                             long long b1) {
  const float *g = t.g[0], *mu = t.mu[0], *nu = t.nu[0];
  float *u = t.u[0], *mu2 = t.mu2[0], *nu2 = t.nu2[0];
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
    for (int k = 0; k < hvdt::kLane; ++k) x[k] = adam_elem(x[k], m[k], v[k], t.c);
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

// one leaf's pointers, as a block keeps them while its chunks stay in it
struct Leaf {
  const float *g, *mu, *nu;
  float *u, *mu2, *nu2;
  long long n;
  int first, end;                       // its chunks [first, end)
  bool vec;
};

__device__ __forceinline__ float4 adam4(float4 g, float4& mu, float4& nu,
                                        const AdamConsts& c) {
  return make_float4(adam_elem(g.x, mu.x, nu.x, c), adam_elem(g.y, mu.y, nu.y, c),
                     adam_elem(g.z, mu.z, nu.z, c), adam_elem(g.w, mu.w, nu.w, c));
}

// elements [b0, b1) of a leaf: float4s with a scalar tail, or one element
// a thread for an unaligned leaf
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
        float4 mv = __ldg(reinterpret_cast<const float4*>(mu + e));
        float4 nv = __ldg(reinterpret_cast<const float4*>(nu + e));
        *reinterpret_cast<float4*>(u + e) =
            adam4(__ldg(reinterpret_cast<const float4*>(g + e)), mv, nv, c);
        *reinterpret_cast<float4*>(mu2 + e) = mv;
        *reinterpret_cast<float4*>(nu2 + e) = nv;
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

template <bool kRequant>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ AdamTable t) {
  const int chunks = t.first[t.n_leaves];
  int i = 0;
  Leaf f{};                             // f.end = 0: found at the first chunk
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    if (c >= f.end) {                   // the last leaf with first <= c
      int hi = t.n_leaves - 1;
      while (i < hi) {
        const int mid = (i + hi + 1) >> 1;
        if (t.first[mid] <= c) i = mid; else hi = mid - 1;
      }
      f = Leaf{t.g[i], t.mu[i], t.nu[i], t.u[i], t.mu2[i], t.nu2[i], t.n[i],
               t.first[i], t.first[i + 1], t.vec[i] != 0};
    }
    const long long b0 = static_cast<long long>(c - f.first) * kChunk;
    if (kRequant) {                     // whole int8 blocks, zero-padded
      const long long nq =
          (f.n + hvdt::kBlock - 1) / hvdt::kBlock * hvdt::kBlock;
      adam_requant(t, b0, min(b0 + kChunk, nq));
    } else {
      adam_chunk(f, t.c, b0, min(b0 + kChunk, f.n));
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

template <bool kRequant>
int launch(const long long* ptrs, const long long* n, const int* first, int k,
           void* q, void* s, const AdamConsts& c, cudaStream_t stream) {
  AdamTable t{};
  for (int i = 0; i < k; ++i) {
    const long long* p = ptrs + 6 * i;
    t.g[i] = reinterpret_cast<const float*>(p[0]);
    t.mu[i] = reinterpret_cast<const float*>(p[1]);
    t.nu[i] = reinterpret_cast<const float*>(p[2]);
    t.u[i] = reinterpret_cast<float*>(p[3]);
    t.mu2[i] = reinterpret_cast<float*>(p[4]);
    t.nu2[i] = reinterpret_cast<float*>(p[5]);
    t.n[i] = n[i];
    t.first[i] = first[i];
    t.vec[i] = ((p[0] | p[1] | p[2] | p[3] | p[4] | p[5]) & 15) == 0;
    if (first[i + 1] - first[i] != (n[i] + kChunk - 1) / kChunk)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  t.first[k] = first[k];
  t.q = static_cast<int8_t*>(q);
  t.s = static_cast<__nv_bfloat16*>(s);
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
  adam_kernel<kRequant><<<grid, kThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// k leaves (1 <= k <= kMaxLeaves): ptrs [k][6] = g, mu, nu, u, mu2, nu2
// (f32), n [k] their lengths, first [k + 1] each leaf's first chunk
// (ceil(n / kChunk) chunks a leaf; first[k] is the total). With q and s
// (k == 1 only) the update's int8 wire image: q [ceil(n/256)*256],
// s bf16 [ceil(n/256)].
int hvd_fused_adam(const long long* ptrs, const long long* n, const int* first,
                   int k, void* q, void* s, float omb1, float b1, float omb2,
                   float b2, float b1c, float b2c, float eps, float eps_root,
                   float neg_lr, void* stream) {
  if (k < 1 || k > kMaxLeaves || (q == nullptr) != (s == nullptr) ||
      (q != nullptr && k != 1) || first[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const AdamConsts c{omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q != nullptr) return launch<true>(ptrs, n, first, k, q, s, c, st);
  return launch<false>(ptrs, n, first, k, q, s, c, st);
}

}  // extern "C"
