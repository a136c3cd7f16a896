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
// Element types. The kernel is instantiated for f32 and bf16 leaves; one
// launch takes leaves of one type (the wrapper groups a call's leaves by
// dtype). For bf16 every operation takes two bf16 values and its f32
// result (__f*_rn) is rounded to bf16 (__float2bfloat16_rn), the constants
// rounded to bf16 first and the square root correctly rounded in f32
// before its own rounding: what optax's weakly typed constants and the
// reference's kernel compute for a bf16 leaf. The f32 instantiation is
// the expressions above, unchanged. A 16-byte access is 4 f32 or 8 bf16.
//
// Bias corrections. By value, or (bc non-null) read from a device buffer
// [b1c, b2c]: a guarded optimizer's step count lives on the device (a
// skipped step keeps it without a host read), so its bias corrections
// are computed there, as the reference's kernel takes its traced ones.
//
// The epilogue (f32, one leaf only): each warp takes whole 256-element blocks,
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
static_assert(kChunk % (8 * kThreads) == 0 && kChunk % hvdt::kBlock == 0,
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

// one element type's loads, stores and rounding
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kVec = 4;        // elements a 16-byte access
  __device__ static float load(const float* p) { return *p; }
  __device__ static void put(float* p, float x) { *p = x; }
  __device__ static float r(float x) { return x; }
  __device__ static void load_vec(const float* p, float (&x)[kVec]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
  __device__ static void store_vec(float* p, const float (&x)[kVec]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void put(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  // x's value rounded to bf16 (x is exactly representable afterwards)
  __device__ static float r(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  __device__ static void load_vec(const __nv_bfloat16* p, float (&x)[kVec]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[2 * k] = __uint_as_float(w[k] << 16);
      x[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static void store_vec(__nv_bfloat16* p, const float (&x)[kVec]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k]));
      const uint32_t hi =
          __bfloat16_as_ushort(__float2bfloat16_rn(x[2 * k + 1]));
      w[k] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// one element: every operation rounded by E::r (a no-op for f32, where
// this is the f32 expressions of the header exactly)
template <typename T>
__device__ __forceinline__ float adam_elem(float g, float& mu, float& nu,
                                           const AdamConsts& c) {
  using E = Elem<T>;
  const float m2 = E::r(__fadd_rn(E::r(__fmul_rn(c.omb1, g)),
                                  E::r(__fmul_rn(c.b1, mu))));
  const float v2 = E::r(__fadd_rn(E::r(__fmul_rn(c.omb2, E::r(__fmul_rn(g, g)))),
                                  E::r(__fmul_rn(c.b2, nu))));
  const float den = E::r(__fadd_rn(
      E::r(__fsqrt_rn(E::r(__fadd_rn(E::r(__fdiv_rn(v2, c.b2c)), c.eps_root)))),
      c.eps));
  mu = m2;
  nu = v2;
  return E::r(__fmul_rn(c.neg_lr, E::r(__fdiv_rn(E::r(__fdiv_rn(m2, c.b1c)), den))));
}

// the step's constants in the leaves' type: bias corrections from the
// device buffer when there is one, each constant rounded by E::r
template <typename T>
__device__ __forceinline__ AdamConsts consts_of(const AdamTable& t) {
  using E = Elem<T>;
  AdamConsts c = t.c;
  if (t.bc != nullptr) {
    c.b1c = t.bc[0];
    c.b2c = t.bc[1];
  }
  return AdamConsts{E::r(c.omb1), E::r(c.b1), E::r(c.omb2), E::r(c.b2),
                    E::r(c.b1c), E::r(c.b2c), E::r(c.eps), E::r(c.eps_root),
                    E::r(c.neg_lr)};
}

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
      x[k] = adam_elem<float>(x[k], m[k], v[k], c);
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
template <typename T>
struct Leaf {
  const T *g, *mu, *nu;
  T *u, *mu2, *nu2;
  long long n;
  int first, end;                       // its chunks [first, end)
  bool vec;
};

// elements [b0, b1) of a leaf: 16-byte groups with a scalar tail, or one
// element a thread for an unaligned leaf
template <typename T>
__device__ __forceinline__ void adam_chunk(const Leaf<T>& f, const AdamConsts& c,
                                           long long b0, long long b1) {
  using E = Elem<T>;
  constexpr int V = E::kVec;
  const T* __restrict__ g = f.g;
  const T* __restrict__ mu = f.mu;
  const T* __restrict__ nu = f.nu;
  T* __restrict__ u = f.u;
  T* __restrict__ mu2 = f.mu2;
  T* __restrict__ nu2 = f.nu2;
  if (f.vec) {
    for (long long e = b0 + V * threadIdx.x; e < b1; e += V * kThreads) {
      if (e + V <= b1) {                // read-only path for the inputs
        float x[V], m[V], v[V];
        E::load_vec(g + e, x);
        E::load_vec(mu + e, m);
        E::load_vec(nu + e, v);
#pragma unroll
        for (int k = 0; k < V; ++k) x[k] = adam_elem<T>(x[k], m[k], v[k], c);
        E::store_vec(u + e, x);
        E::store_vec(mu2 + e, m);
        E::store_vec(nu2 + e, v);
      } else {                          // the leaf's ragged tail
        for (long long k = e; k < b1; ++k) {
          float m = E::load(mu + k), v = E::load(nu + k);
          E::put(u + k, adam_elem<T>(E::load(g + k), m, v, c));
          E::put(mu2 + k, m);
          E::put(nu2 + k, v);
        }
      }
    }
  } else {
    for (long long k = b0 + threadIdx.x; k < b1; k += kThreads) {
      float m = E::load(mu + k), v = E::load(nu + k);
      E::put(u + k, adam_elem<T>(E::load(g + k), m, v, c));
      E::put(mu2 + k, m);
      E::put(nu2 + k, v);
    }
  }
}

template <typename T, bool kRequant>
__global__ void __launch_bounds__(kThreads)
adam_kernel(const __grid_constant__ AdamTable t) {
  const AdamConsts c = consts_of<T>(t);
  const int chunks = t.first[t.n_leaves];
  int i = 0;
  Leaf<T> f{};                          // f.end = 0: found at the first chunk
  for (int ch = blockIdx.x; ch < chunks; ch += gridDim.x) {
    if (ch >= f.end) {                  // the last leaf with first <= ch
      int hi = t.n_leaves - 1;
      while (i < hi) {
        const int mid = (i + hi + 1) >> 1;
        if (t.first[mid] <= ch) i = mid; else hi = mid - 1;
      }
      f = Leaf<T>{static_cast<const T*>(t.g[i]), static_cast<const T*>(t.mu[i]),
                  static_cast<const T*>(t.nu[i]), static_cast<T*>(t.u[i]),
                  static_cast<T*>(t.mu2[i]), static_cast<T*>(t.nu2[i]), t.n[i],
                  t.first[i], t.first[i + 1], t.vec[i] != 0};
    }
    const long long b0 = static_cast<long long>(ch - f.first) * kChunk;
    if constexpr (kRequant) {           // whole int8 blocks, zero-padded
      const long long nq =
          (f.n + hvdt::kBlock - 1) / hvdt::kBlock * hvdt::kBlock;
      adam_requant(t, c, b0, min(b0 + kChunk, nq));
    } else {
      adam_chunk<T>(f, c, b0, min(b0 + kChunk, f.n));
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

template <typename T, bool kRequant>
int launch(const long long* ptrs, const long long* n, const int* first, int k,
           void* q, void* s, const float* bc, const AdamConsts& c,
           cudaStream_t stream) {
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
  adam_kernel<T, kRequant><<<grid, kThreads, 0, stream>>>(t);
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
  if (q != nullptr) return launch<float, true>(ptrs, n, first, k, q, s, bc, c, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(ptrs, n, first, k, q, s, bc, c, st);
  return launch<float, false>(ptrs, n, first, k, q, s, bc, c, st);
}

}  // extern "C"
