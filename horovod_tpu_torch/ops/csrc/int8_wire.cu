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
// Bound on an H100 SXM (3.35 TB/s): all are single passes with a few
// operations per byte, below the card's ~20 f32 operations per byte.
// Quantize moves 4 bytes in, 1 + 2/256 out per element (+4 with the
// roundtrip image); the accumulate kernels read n + 2n/256 bytes per
// shard element and write 4 (or 1 + 2/256).
//
// What the design does about it: every input byte is read once and
// every output written once; the lanes of a scale block reduce its max
// |x| by register shuffles, and no intermediate (the |x| row, the [n, sp]
// f32 dequant matrix, the reduced shard between accumulate and
// requantize) touches device memory. Quantize's lanes load 32 contiguous
// bytes (two float4), a warp a whole 1 KB block per access.
//
// The accumulate kernels (B3, B4) are built for 1, 2, 4 and 8 senders
// (any other count loops over the rows) and load every sender's row
// before the first sum. B4: a half-warp a scale block, 16 contiguous
// elements (one 16-byte load a sender) a lane. B3: a warp a block, lane l
// its elements [4l, 4l + 4) and [128 + 4l, 132 + 4l), so that each float4
// store of the warp writes 512 contiguous bytes. Arithmetic, not bytes,
// limited B4 before (tools/b4_split.py): an IEEE divide an element for
// the quotient, about a fifth of its time at one sender, and one for
// Average, a sixth at four. int8_wire.cuh's requantize takes the
// quotient by one fma, and Average by a power of two N multiplies by
// 2^-k: the same correctly rounded acc / N, subnormals, zeros, infinities
// and NaN included. Any other N keeps __fdiv_rn.
#include <type_traits>

#include "int8_wire.cuh"

namespace {

using hvdt::kBlock;
using hvdt::kLane;
using hvdt::kWide;

constexpr int kThreads = 256;           // 8 warps a CTA

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
  uint2 qi;
  hvdt::load8(x + e, v);
  const __nv_bfloat16 sc = hvdt::requant_lane(v, qi, dv);
  if (lane == 0) s[blk] = sc;
  *reinterpret_cast<uint2*>(q + e) = qi;
  if (d != nullptr) hvdt::store(d + e, dv);
}

// a warp a scale block: lane l sums elements [4l, 4l + 4) and [128 + 4l,
// 132 + 4l) of it, so each of its two float4 stores writes 512
// contiguous bytes of the warp
template <int kN>
__global__ void deq_acc_kernel(const int8_t* __restrict__ q,
                               const __nv_bfloat16* __restrict__ s,
                               float* __restrict__ out, int n, long long sp) {
  const long long blk =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (blk * kBlock >= sp) return;
  const long long e = blk * kBlock + 4 * (threadIdx.x & 31);
  float acc[8];
  hvdt::accumulate<kN, 2, 128>(q, s, n, sp, blk, e, acc);
  reinterpret_cast<float4*>(out + e)[0] =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
  reinterpret_cast<float4*>(out + e + 128)[0] =
      make_float4(acc[4], acc[5], acc[6], acc[7]);
}

// A warp takes scale blocks 2w and 2w + 1, a half-warp each (16
// contiguous elements a lane); the second may lie past the end, and its
// half-warp then shuffles zeros and stores nothing. Average: div > 1
// divides, else inv (1 or 2^-k) multiplies.
template <int kN>
__global__ void deq_acc_requant_kernel(const int8_t* __restrict__ q,
                                       const __nv_bfloat16* __restrict__ s,
                                       int8_t* __restrict__ q2,
                                       __nv_bfloat16* __restrict__ s2,
                                       int n, long long sp, int div,
                                       float inv) {
  const long long nbs = sp / kBlock;
  const int lane = threadIdx.x & 31;
  const long long blk = ((static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x) >> 5) * 2 + (lane >> 4);
  if (blk - (lane >> 4) >= nbs) return;  // warp-uniform: shuffles stay safe
  const bool live = blk < nbs;
  const long long e = blk * kBlock + (lane & 15) * kWide;
  float acc[kWide], v[kWide];
  if (live) {
    hvdt::accumulate<kN, 4, 4>(q, s, n, sp, blk, e, acc);
  } else {
#pragma unroll
    for (int i = 0; i < kWide; ++i) acc[i] = 0.0f;
  }
  if (div > 1) {
    const float dd = static_cast<float>(div);
#pragma unroll
    for (int i = 0; i < kWide; ++i) acc[i] = __fdiv_rn(acc[i], dd);
  } else if (inv != 1.0f) {
#pragma unroll
    for (int i = 0; i < kWide; ++i) acc[i] = __fmul_rn(acc[i], inv);
  }
  const hvdt::Scale sc = hvdt::requant<kWide>(acc, v);
  if (live) {
    *reinterpret_cast<uint4*>(q2 + e) = make_uint4(
        hvdt::pack4(v), hvdt::pack4(v + 4), hvdt::pack4(v + 8),
        hvdt::pack4(v + 12));
    if ((lane & 15) == 0) s2[blk] = sc.sc;
  }
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
  hvdt::store(out + e, v);
}

unsigned int grid_for(long long threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// launch(k) with k's ::value the sender count a kernel is built for: n
// itself for 1, 2, 4 and 8 senders, 0 (any n) otherwise
template <typename Launch>
void by_senders(int n, Launch&& launch) {
  switch (n) {
    case 1: launch(std::integral_constant<int, 1>()); break;
    case 2: launch(std::integral_constant<int, 2>()); break;
    case 4: launch(std::integral_constant<int, 4>()); break;
    case 8: launch(std::integral_constant<int, 8>()); break;
    default: launch(std::integral_constant<int, 0>());
  }
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
  by_senders(n, [&](auto k) {
    deq_acc_kernel<decltype(k)::value>
        <<<grid_for(sp / kLane), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int8_t*>(q),
            static_cast<const __nv_bfloat16*>(s), static_cast<float*>(out),
            n, sp);
  });
  return static_cast<int>(cudaGetLastError());
}

// As hvd_dequant_accumulate, then / divisor (when > 1), then requantize:
// -> q2 int8 [sp], s2 bf16 [sp/256].
int hvd_dequant_accumulate_requantize(const void* q, const void* s, void* q2,
                                      void* s2, int n, long long sp,
                                      int divisor, void* stream) {
  // acc * 2^-k and acc / 2^k are the same correctly rounded quotient
  const bool pow2 = divisor > 1 && (divisor & (divisor - 1)) == 0;
  const float inv = pow2 ? 1.0f / static_cast<float>(divisor) : 1.0f;
  by_senders(n, [&](auto k) {
    deq_acc_requant_kernel<decltype(k)::value>
        <<<grid_for((sp / kBlock + 1) / 2 * 32), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int8_t*>(q),
            static_cast<const __nv_bfloat16*>(s), static_cast<int8_t*>(q2),
            static_cast<__nv_bfloat16*>(s2), n, sp, pow2 ? 0 : divisor, inv);
  });
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
