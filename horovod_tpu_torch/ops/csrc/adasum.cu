// The Adasum pairwise combine on Hopper, single-tensor and segmented.
//
// Replaces (horovod_tpu/ops/pallas_kernels.py):
//   hvd_adasum_combine, one segment  <- adasum_pair_combine /
//                                       _pair_reduce_kernel, _blend_kernel
//   hvd_adasum_combine, n segments   <- adasum_segment_combine /
//                                       _seg_reduce_kernel, _seg_blend_kernel
// and, over a table of 16-bit leaves packed into one buffer, the first
// again for every leaf at once (ops/adasum.py's compressed butterfly).
//
// Per segment s of the flat operands a, b (one segment: the whole tensor):
//   dot = sum a*b, na = sum a*a, nb = sum b*b            (f32)
//   ca  = na == 0 ? 0 : 1 - dot / (2 * max(na, 1e-30))   (cb alike)
//   out = ca * a + cb * b, in a's type
// with the operands widened to f32 before any product, as the Pallas
// kernel does (the reference's discrete jnp.vdot sums 16-bit operands in
// their own type; the port follows the kernel).
//
// Bound on an H100 SXM (3.35 TB/s): memory. Per element ~9 f32
// operations against 6-12 bytes read and written once, far below the
// card's ~20 operations per byte; the two passes read a and b twice. So
// the design is about bytes in flight and launches:
//   - 16-byte vector loads and stores: each thread takes groups of
//     V = 16 / sizeof(T) consecutive elements (8 bf16/f16, 4 f32),
//     neighbouring threads on neighbouring groups. A group is cut from the
//     segment's first element, so where a, b (and out) start a segment on
//     a 16-byte boundary, a group is one vector; elsewhere (a tensor at an
//     odd element offset) the same groups are read element by element.
//     The arithmetic, and so the bits, do not depend on the alignment.
//     A whole aligned group takes a path with no per-element test, and
//     the blend narrows its 16-bit outputs two to a conversion (the same
//     round-to-nearest-even): a 2-byte element carries as many
//     instructions as a 4-byte one, so instructions, not only bytes,
//     count there.
//   - two launches on the caller's stream, nothing in between on the host:
//     1. reduce: one block per chunk of at most `chunk` elements of one
//        segment; each thread sums its groups in order, the block sums
//        its 256 threads' partials in a fixed tree and writes
//        partials[3 * chunk + {0, 1, 2}]. Then it takes a ticket on its
//        segment's counter (__threadfence, atomicAdd): the block that
//        draws the last ticket sums the segment's chunk partials in chunk
//        order, writes coef[2s], coef[2s + 1] and resets the counter to 0
//        for the next launch.
//     2. blend: the chunks again, in reverse order. Blocks start roughly
//        in index order, so the blend begins with the chunks the reduce
//        streamed last, while they may still be in the 50 MB L2.
// No float atomics: every sum is taken in an order fixed by the inputs'
// lengths and the chunk size, whichever block finishes last. So the two
// ranks of a butterfly pair, which combine the same (a, b), end
// bit-identical, and a leaf combined as a segment of a packed buffer
// gives the bits of its own combine (its groups and chunks are cut from
// its first element either way).
//
// Chunks never straddle a segment: the host derives, once per segment
// layout, each segment's first chunk (chunk_first [n_seg + 1]) and each
// chunk's segment (chunk_seg [n_chunks]). With no tables there is one
// segment [0, L) in ceil(L / chunk) chunks.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half narrow<__half>(float x) {
  return __float2half_rn(x);
}

// One group: 16 bytes, loaded and stored as one vector.
template <typename T>
struct alignas(16) Group {
  static constexpr int kN = 16 / sizeof(T);
  T v[kN];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One whole group at an aligned address, widened.
template <typename T>
__device__ __forceinline__ void load_vector(const T* p,
                                            float (&x)[Group<T>::kN]) {
  const Group<T> g = *reinterpret_cast<const Group<T>*>(p);
#pragma unroll
  for (int j = 0; j < Group<T>::kN; ++j) x[j] = widen(g.v[j]);
}

// One whole group, narrowed to T (two 16-bit values a conversion) and
// stored as one vector at an aligned address.
__device__ __forceinline__ void store_vector(float* p, const float (&r)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
}
__device__ __forceinline__ void store_vector(__nv_bfloat16* p,
                                             const float (&r)[8]) {
  alignas(16) __nv_bfloat162 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(r[2 * k], r[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}
__device__ __forceinline__ void store_vector(__half* p, const float (&r)[8]) {
  alignas(16) __half2 h[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2half2_rn(r[2 * k], r[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
}

__device__ __forceinline__ void accumulate3(float (&v)[3], float x, float y) {
  v[0] = __fadd_rn(v[0], __fmul_rn(x, y));
  v[1] = __fadd_rn(v[1], __fmul_rn(x, x));
  v[2] = __fadd_rn(v[2], __fmul_rn(y, y));
}

// The element range [begin, end) and segment of chunk c.
__device__ __forceinline__ int chunk_range(long long c, long long L,
                                           long long chunk,
                                           const long long* seg_off,
                                           const int* chunk_seg,
                                           const int* chunk_first,
                                           long long* begin, long long* end) {
  if (chunk_seg == nullptr) {
    *begin = c * chunk;
    *end = min(L, *begin + chunk);
    return 0;
  }
  const int s = chunk_seg[c];
  *begin = seg_off[s] + (c - chunk_first[s]) * chunk;
  *end = min(seg_off[s + 1], *begin + chunk);
  return s;
}

// Sum of each of three values over the block's threads in a fixed order
// (shuffle tree within each warp, then the warps' sums in warp order);
// thread 0 gets the totals. Every thread of the block must call it.
__device__ __forceinline__ void block_sum3(float (&v)[3]) {
  __shared__ float warp_sums[3][kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v[k] = __fadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], o));
    if (lane == 0) warp_sums[k][warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float t = warp_sums[k][0];
      for (int w = 1; w < kWarps; ++w) t = __fadd_rn(t, warp_sums[k][w]);
      v[k] = t;
    }
  }
}

// jnp.where(n == 0, 0, 1 - dot / (2 * jnp.maximum(n, 1e-30))); the
// maximum propagates a NaN, as jnp.maximum does (fmaxf would drop it).
__device__ __forceinline__ float coefficient(float dot, float n) {
  if (n == 0.0f) return 0.0f;
  const float m = (n > 1e-30f || n != n) ? n : 1e-30f;
  return __fsub_rn(1.0f, __fdiv_rn(dot, __fmul_rn(2.0f, m)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  long long L, long long chunk, const long long* seg_off,
                  const int* chunk_seg, const int* chunk_first, int n_chunks,
                  float* __restrict__ partials, float* __restrict__ coef,
                  unsigned int* __restrict__ counters) {
  constexpr int V = Group<T>::kN;
  const int c = blockIdx.x;
  long long begin, end;
  const int s = chunk_range(c, L, chunk, seg_off, chunk_seg, chunk_first,
                            &begin, &end);
  const bool vec = aligned16(a + begin) && aligned16(b + begin);
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (long long i = begin + static_cast<long long>(threadIdx.x) * V;
       i < end; i += static_cast<long long>(kThreads) * V) {
    if (vec && i + V <= end) {
      float x[V], y[V];
      load_vector(a + i, x);
      load_vector(b + i, y);
#pragma unroll
      for (int j = 0; j < V; ++j) accumulate3(v, x[j], y[j]);
    } else {
      const int n = end - i < V ? static_cast<int>(end - i) : V;
      for (int j = 0; j < n; ++j)
        accumulate3(v, widen(a[i + j]), widen(b[i + j]));
    }
  }
  block_sum3(v);

  // The segment's chunks [first, last); the block that finishes last sums
  // their partials.
  const int first = chunk_first == nullptr ? 0 : chunk_first[s];
  const int last = chunk_first == nullptr ? n_chunks : chunk_first[s + 1];
  __shared__ bool finisher;
  if (threadIdx.x == 0) {
    float* p = partials + 3 * static_cast<long long>(c);
    p[0] = v[0];
    p[1] = v[1];
    p[2] = v[2];
    __threadfence();
    const unsigned int ticket = atomicAdd(counters + s, 1u);
    finisher = ticket == static_cast<unsigned int>(last - first - 1);
  }
  __syncthreads();
  if (!finisher) return;
  __threadfence();
  float w[3] = {0.0f, 0.0f, 0.0f};
  for (int k = first + threadIdx.x; k < last; k += kThreads) {
    const float* p = partials + 3 * static_cast<long long>(k);
    w[0] = __fadd_rn(w[0], __ldcg(p));
    w[1] = __fadd_rn(w[1], __ldcg(p + 1));
    w[2] = __fadd_rn(w[2], __ldcg(p + 2));
  }
  block_sum3(w);
  if (threadIdx.x == 0) {
    coef[2 * s] = coefficient(w[0], w[1]);
    coef[2 * s + 1] = coefficient(w[0], w[2]);
    counters[s] = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    blend_kernel(const T* __restrict__ a, const T* __restrict__ b,
                 T* __restrict__ out, long long L, long long chunk,
                 const long long* seg_off, const int* chunk_seg,
                 const int* chunk_first, int n_chunks,
                 const float* __restrict__ coef) {
  constexpr int V = Group<T>::kN;
  const int c = n_chunks - 1 - static_cast<int>(blockIdx.x);
  long long begin, end;
  const int s = chunk_range(c, L, chunk, seg_off, chunk_seg, chunk_first,
                            &begin, &end);
  const float ca = coef[2 * s], cb = coef[2 * s + 1];
  const bool vec =
      aligned16(a + begin) && aligned16(b + begin) && aligned16(out + begin);
  for (long long i = begin + static_cast<long long>(threadIdx.x) * V;
       i < end; i += static_cast<long long>(kThreads) * V) {
    if (vec && i + V <= end) {
      float x[V], y[V], r[V];
      load_vector(a + i, x);
      load_vector(b + i, y);
#pragma unroll
      for (int j = 0; j < V; ++j)
        r[j] = __fadd_rn(__fmul_rn(ca, x[j]), __fmul_rn(cb, y[j]));
      store_vector(out + i, r);
    } else {
      const int n = end - i < V ? static_cast<int>(end - i) : V;
      for (int j = 0; j < n; ++j)
        out[i + j] = narrow<T>(__fadd_rn(__fmul_rn(ca, widen(a[i + j])),
                                         __fmul_rn(cb, widen(b[i + j]))));
    }
  }
}

template <typename T>
int combine(const void* a, const void* b, void* out, long long L,
            const long long* seg_off, const int* chunk_seg,
            const int* chunk_first, int n_chunks, long long chunk,
            float* partials, float* coef, unsigned int* counters,
            cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  reduce_kernel<T><<<n_chunks, kThreads, 0, stream>>>(
      ta, tb, L, chunk, seg_off, chunk_seg, chunk_first, n_chunks, partials,
      coef, counters);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_kernel<T><<<n_chunks, kThreads, 0, stream>>>(
      ta, tb, static_cast<T*>(out), L, chunk, seg_off, chunk_seg, chunk_first,
      n_chunks, coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b, out [L] of one type (dtype 0 f32, 1 bf16, 2 f16), L > 0, in
// n_chunks > 0 chunks of at most `chunk` elements (a multiple of 8).
// Segment tables (device memory): seg_off int64 [n_seg + 1] element
// offsets, chunk_seg int32 [n_chunks], chunk_first int32 [n_seg + 1]; all
// three NULL for one segment over [0, L). Scratch: partials f32
// [3 * n_chunks], coef f32 [2 * n_seg], counters uint32 [n_seg], zero
// before the launch and zero again after it (each segment's last block
// resets its counter), so launches on one stream may share them. Returns
// the first launch error, 0 when both launched.
int hvd_adasum_combine(const void* a, const void* b, void* out, int dtype,
                       long long L, int n_seg, const void* seg_off,
                       const void* chunk_seg, const void* chunk_first,
                       int n_chunks, long long chunk, void* partials,
                       void* coef, void* counters, void* stream) {
  if (n_seg <= 0 || n_chunks <= 0 || chunk <= 0 || chunk % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* so = static_cast<const long long*>(seg_off);
  const int* cs = static_cast<const int*>(chunk_seg);
  const int* cf = static_cast<const int*>(chunk_first);
  float* p = static_cast<float*>(partials);
  float* c = static_cast<float*>(coef);
  unsigned int* k = static_cast<unsigned int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return combine<float>(a, b, out, L, so, cs, cf, n_chunks, chunk, p, c,
                            k, st);
    case 1:
      return combine<__nv_bfloat16>(a, b, out, L, so, cs, cf, n_chunks, chunk,
                                    p, c, k, st);
    case 2:
      return combine<__half>(a, b, out, L, so, cs, cf, n_chunks, chunk, p, c,
                             k, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
