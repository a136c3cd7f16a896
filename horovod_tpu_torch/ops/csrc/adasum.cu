// The Adasum pairwise combine on Hopper, single-tensor and segmented.
//
// Replaces (horovod_tpu/ops/pallas_kernels.py):
//   hvd_adasum_combine, one segment  <- adasum_pair_combine /
//                                       _pair_reduce_kernel, _blend_kernel
//   hvd_adasum_combine, n segments   <- adasum_segment_combine /
//                                       _seg_reduce_kernel, _seg_blend_kernel
//
// Per segment s of the flat operands a, b (one segment: the whole tensor):
//   dot = sum a*b, na = sum a*a, nb = sum b*b            (f32)
//   ca  = na == 0 ? 0 : 1 - dot / (2 * max(na, 1e-30))   (cb alike)
//   out = ca * a + cb * b, in a's type
// with the operands widened to f32 before any product, as the Pallas
// kernel does (the reference's discrete jnp.vdot sums 16-bit operands in
// their own type; the port follows the kernel).
//
// Three launches on the caller's stream, nothing in between on the host:
//   1. reduce:   one block per chunk of at most `chunk` elements of one
//                segment; each thread strides over the chunk and the block
//                sums its 256 threads' partials in a fixed tree. Writes
//                partials[3 * chunk_index + {0, 1, 2}].
//   2. finalize: one block per segment sums that segment's chunk partials
//                in a fixed order and writes coef[2s], coef[2s + 1].
//   3. blend:    the chunks again, reading their segment's coefficients.
// No atomics: the sums, and so the result, depend only on the inputs and
// on the chunk size, so the two ranks of a butterfly pair, which combine
// the same (a, b), end bit-identical.
//
// Chunks never straddle a segment: the host derives, once per segment
// layout, each segment's first chunk (chunk_first [n_seg + 1]) and each
// chunk's segment (chunk_seg [n_chunks]). With no tables there is one
// segment [0, L) in ceil(L / chunk) chunks.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Per element it reads a and b
// twice (reduce, blend) and writes out once, ~9 f32 operations against
// 8-16 bytes moved, far below the card's ~20 operations per byte. Loads
// are one element per thread, neighbouring threads on neighbouring
// elements, which needs no alignment beyond the element's own: a leaf
// sliced out of a group buffer at any offset is read in place.
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
// thread 0 gets the totals.
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

template <typename T>
__global__ void reduce_kernel(const T* __restrict__ a,
                              const T* __restrict__ b, long long L,
                              long long chunk, const long long* seg_off,
                              const int* chunk_seg, const int* chunk_first,
                              float* __restrict__ partials) {
  long long begin, end;
  chunk_range(blockIdx.x, L, chunk, seg_off, chunk_seg, chunk_first, &begin,
              &end);
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    const float x = widen(a[i]), y = widen(b[i]);
    v[0] = __fadd_rn(v[0], __fmul_rn(x, y));
    v[1] = __fadd_rn(v[1], __fmul_rn(x, x));
    v[2] = __fadd_rn(v[2], __fmul_rn(y, y));
  }
  block_sum3(v);
  if (threadIdx.x == 0) {
    float* p = partials + 3 * static_cast<long long>(blockIdx.x);
    p[0] = v[0];
    p[1] = v[1];
    p[2] = v[2];
  }
}

// jnp.where(n == 0, 0, 1 - dot / (2 * jnp.maximum(n, 1e-30))); the
// maximum propagates a NaN, as jnp.maximum does (fmaxf would drop it).
__device__ __forceinline__ float coefficient(float dot, float n) {
  if (n == 0.0f) return 0.0f;
  const float m = (n > 1e-30f || n != n) ? n : 1e-30f;
  return __fsub_rn(1.0f, __fdiv_rn(dot, __fmul_rn(2.0f, m)));
}

__global__ void finalize_kernel(const float* __restrict__ partials,
                                int n_chunks, const int* chunk_first,
                                float* __restrict__ coef) {
  const int s = blockIdx.x;
  const int first = chunk_first == nullptr ? 0 : chunk_first[s];
  const int last = chunk_first == nullptr ? n_chunks : chunk_first[s + 1];
  float v[3] = {0.0f, 0.0f, 0.0f};
  for (int c = first + threadIdx.x; c < last; c += kThreads) {
    const float* p = partials + 3 * static_cast<long long>(c);
    v[0] = __fadd_rn(v[0], p[0]);
    v[1] = __fadd_rn(v[1], p[1]);
    v[2] = __fadd_rn(v[2], p[2]);
  }
  block_sum3(v);
  if (threadIdx.x == 0) {
    coef[2 * s] = coefficient(v[0], v[1]);
    coef[2 * s + 1] = coefficient(v[0], v[2]);
  }
}

template <typename T>
__global__ void blend_kernel(const T* __restrict__ a, const T* __restrict__ b,
                             T* __restrict__ out, long long L, long long chunk,
                             const long long* seg_off, const int* chunk_seg,
                             const int* chunk_first,
                             const float* __restrict__ coef) {
  long long begin, end;
  const int s = chunk_range(blockIdx.x, L, chunk, seg_off, chunk_seg,
                            chunk_first, &begin, &end);
  const float ca = coef[2 * s], cb = coef[2 * s + 1];
  for (long long i = begin + threadIdx.x; i < end; i += kThreads)
    out[i] = narrow<T>(__fadd_rn(__fmul_rn(ca, widen(a[i])),
                                 __fmul_rn(cb, widen(b[i]))));
}

template <typename T>
int combine(const void* a, const void* b, void* out, long long L, int n_seg,
            const long long* seg_off, const int* chunk_seg,
            const int* chunk_first, int n_chunks, long long chunk,
            float* partials, float* coef, cudaStream_t stream) {
  const T* ta = static_cast<const T*>(a);
  const T* tb = static_cast<const T*>(b);
  reduce_kernel<T><<<n_chunks, kThreads, 0, stream>>>(
      ta, tb, L, chunk, seg_off, chunk_seg, chunk_first, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<n_seg, kThreads, 0, stream>>>(partials, n_chunks,
                                                  chunk_first, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_kernel<T><<<n_chunks, kThreads, 0, stream>>>(
      ta, tb, static_cast<T*>(out), L, chunk, seg_off, chunk_seg,
      chunk_first, coef);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a, b, out [L] of one type (dtype 0 f32, 1 bf16, 2 f16), L > 0, in
// n_chunks > 0 chunks of at most `chunk` elements. Segment tables (device
// memory): seg_off int64 [n_seg + 1] element offsets, chunk_seg int32
// [n_chunks], chunk_first int32 [n_seg + 1]; all three NULL for one
// segment over [0, L). Scratch: partials f32 [3 * n_chunks], coef f32
// [2 * n_seg]. Returns the first launch error, 0 when all three launched.
int hvd_adasum_combine(const void* a, const void* b, void* out, int dtype,
                       long long L, int n_seg, const void* seg_off,
                       const void* chunk_seg, const void* chunk_first,
                       int n_chunks, long long chunk, void* partials,
                       void* coef, void* stream) {
  const long long* so = static_cast<const long long*>(seg_off);
  const int* cs = static_cast<const int*>(chunk_seg);
  const int* cf = static_cast<const int*>(chunk_first);
  float* p = static_cast<float*>(partials);
  float* c = static_cast<float*>(coef);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return combine<float>(a, b, out, L, n_seg, so, cs, cf, n_chunks, chunk,
                            p, c, st);
    case 1:
      return combine<__nv_bfloat16>(a, b, out, L, n_seg, so, cs, cf, n_chunks,
                                    chunk, p, c, st);
    case 2:
      return combine<__half>(a, b, out, L, n_seg, so, cs, cf, n_chunks, chunk,
                             p, c, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
