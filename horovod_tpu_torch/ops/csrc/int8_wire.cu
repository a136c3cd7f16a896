// The int8 wire on Hopper: blockwise quantize (+ roundtrip),
// dequantize-accumulate, dequantize-accumulate-requantize, and the
// per-row dequantize of the ZeRO-3 parameter gather.
//
// Replaces (horovod_tpu/ops/pallas_kernels.py):
//   hvd_quantize                        <- _quantize_call / _quantize_kernel
//                                          (quantize_blockwise, quantize_roundtrip)
//   hvd_dequant_accumulate              <- dequant_accumulate / _deq_acc_kernel
//   hvd_dequant_accumulate_requantize   <- dequant_accumulate_requantize /
//                                          _deq_acc_requant_kernel, _requant_rows
//   hvd_dequantize_rows                 <- dequantize_rows / _deq_rows_kernel
//
// Bound on an H100 SXM (3.35 TB/s): all three are single memory-bound
// passes with ~1 operation per byte, far below the card's ~20 f32
// operations per byte. Quantize moves 4 bytes in, 1 + 2/256 out per
// element (+4 with the roundtrip image); the accumulate kernels read
// n + 2n/256 bytes per shard element and write 4 (or 1 + 2/256).
//
// What the design does about it: every input byte is read once and
// every output written once; a warp owns one 256-element scale block, so
// the block's max-abs reduction is a register shuffle and no
// intermediate (the |x| row, the [n, sp] f32 dequant matrix, the reduced
// shard between accumulate and requantize) touches device memory.
// Lanes load 32 contiguous bytes (two float4) so a warp moves a whole
// contiguous 1 KB block per access. Tuning the loads further is left to
// a later change: correctness first, bit for bit.
#include "int8_wire.cuh"

namespace {

using hvdt::kBlock;
using hvdt::kLane;

constexpr int kThreads = 256;           // 8 warps = 8 scale blocks per CTA

__global__ void quantize_kernel(const float* __restrict__ x,
                                int8_t* __restrict__ q,
                                __nv_bfloat16* __restrict__ s,
                                float* __restrict__ d, long long nblocks) {
  const long long blk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= nblocks) return;           // warp-uniform: shuffles stay safe
  const long long e = blk * kBlock + lane * kLane;
  float v[kLane], dv[kLane];
  int8_t qi[kLane];
  hvdt::load8(x + e, v);
  const __nv_bfloat16 sc = hvdt::requant_lane(v, qi, dv);
  if (lane == 0) s[blk] = sc;
  hvdt::store8(q + e, qi);
  if (d != nullptr) hvdt::store8(d + e, dv);
}

__global__ void deq_acc_kernel(const int8_t* __restrict__ q,
                               const __nv_bfloat16* __restrict__ s,
                               float* __restrict__ out, int n, long long sp) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kLane;
  if (e >= sp) return;
  float acc[kLane];
  hvdt::accumulate_lane(q, s, n, sp, e, acc);
  hvdt::store8(out + e, acc);
}

__global__ void deq_acc_requant_kernel(const int8_t* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ s,
                                       int8_t* __restrict__ q2,
                                       __nv_bfloat16* __restrict__ s2,
                                       int n, long long sp, int divisor) {
  const long long blk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk * kBlock >= sp) return;       // warp-uniform
  const long long e = blk * kBlock + lane * kLane;
  float acc[kLane], dv[kLane];
  int8_t qi[kLane];
  hvdt::accumulate_lane(q, s, n, sp, e, acc);
  if (divisor > 0) {
    const float dd = static_cast<float>(divisor);
#pragma unroll
    for (int i = 0; i < kLane; ++i) acc[i] = __fdiv_rn(acc[i], dd);
  }
  const __nv_bfloat16 sc = hvdt::requant_lane(acc, qi, dv);
  if (lane == 0) s2[blk] = sc;
  hvdt::store8(q2 + e, qi);
}

// The gathered rows [n, sp] with sp % 256 == 0 are one flat run of
// n * sp / 256 scale blocks, so element e takes scale e / 256 whatever
// its row: one thread per 8 elements, out = f32(q) * f32(scale). The
// product of an int8 and a bf16 is exact in f32, so every element is
// bit-equal to the reference whatever the rounding mode; a NaN or an
// infinite scale gives NaN (0 * inf) or +-inf as IEEE says, as there.
__global__ void deq_rows_kernel(const int8_t* __restrict__ q,
                                const __nv_bfloat16* __restrict__ s,
                                float* __restrict__ out, long long total) {
  const long long e =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kLane;
  if (e >= total) return;
  union { uint2 u; int8_t b[kLane]; } pk;
  pk.u = *reinterpret_cast<const uint2*>(q + e);
  const float sc = __bfloat162float(s[e / kBlock]);
  float v[kLane];
#pragma unroll
  for (int i = 0; i < kLane; ++i)
    v[i] = __fmul_rn(static_cast<float>(pk.b[i]), sc);
  hvdt::store8(out + e, v);
}

unsigned int grid_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// x f32 [L] -> q int8 [L], s bf16 [L/256], and d f32 [L] when d != NULL.
// L must be a multiple of 256; every pointer 16-byte aligned.
int hvd_quantize(const void* x, void* q, void* s, void* d, long long L,
                 void* stream) {
  const long long nblocks = L / kBlock;
  quantize_kernel<<<grid_for(nblocks * 32), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<__nv_bfloat16*>(s), static_cast<float*>(d), nblocks);
  return static_cast<int>(cudaGetLastError());
}

// q int8 [n, sp], s bf16 [n, sp/256] -> out f32 [sp]; sp % 256 == 0.
int hvd_dequant_accumulate(const void* q, const void* s, void* out, int n,
                           long long sp, void* stream) {
  deq_acc_kernel<<<grid_for(sp / kLane), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), n, sp);
  return static_cast<int>(cudaGetLastError());
}

// As hvd_dequant_accumulate, then / divisor (when > 0), then requantize:
// -> q2 int8 [sp], s2 bf16 [sp/256].
int hvd_dequant_accumulate_requantize(const void* q, const void* s, void* q2,
                                      void* s2, int n, long long sp,
                                      int divisor, void* stream) {
  deq_acc_requant_kernel<<<grid_for(sp / kLane), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<int8_t*>(q2), static_cast<__nv_bfloat16*>(s2), n, sp,
      divisor);
  return static_cast<int>(cudaGetLastError());
}

// q int8 [n, sp], s bf16 [n, sp/256] -> out f32 [n, sp]; sp % 256 == 0,
// every pointer 16-byte aligned. Row r, element j: q[r, j] * s[r, j/256].
int hvd_dequantize_rows(const void* q, const void* s, void* out, int n,
                        long long sp, void* stream) {
  const long long total = static_cast<long long>(n) * sp;
  deq_rows_kernel<<<grid_for(total / kLane), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const __nv_bfloat16*>(s),
      static_cast<float*>(out), total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
