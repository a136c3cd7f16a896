// Device code shared by the int8-wire kernels (int8_wire.cu).
//
// One warp owns one 256-element scale block: lane l holds elements
// [8l, 8l + 8) of it, read as two float4s. Every rounding is pinned with
// an explicit intrinsic so the result is bit-identical to the JAX
// package's discrete expressions (compression.quantize_blockwise):
//   amax = max(|x|); sc = bf16_rne(amax / 127); sf = f32(sc);
//   q = sf > 0 ? clip(round_half_even(x / sf), -127, 127) : 0
// The build passes no -use_fast_math, and __fdiv_rn keeps the divide an
// IEEE division (never a multiply by a reciprocal).
//
// Non-finite input follows the reference too: a NaN in a block makes its
// max and scale NaN and its q all 0 (NaN > 0 is false); an infinity makes
// the scale inf, so finite x / inf = 0 and inf / inf = NaN, which the int8
// cast turns into 0 as XLA's float-to-int conversion does. The roundtrip
// image q * sf is then NaN throughout such a block, as in the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdt {

constexpr int kBlock = 256;             // compression.INT8_BLOCK
constexpr int kLane = kBlock / 32;      // elements per lane

// max that propagates NaN, as jnp.max does (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kLane]) {
  const float4* s = reinterpret_cast<const float4*>(p);
  float4 a = s[0], b = s[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void store8(float* p, const float (&x)[kLane]) {
  float4* d = reinterpret_cast<float4*>(p);
  d[0] = make_float4(x[0], x[1], x[2], x[3]);
  d[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(int8_t* p, const int8_t (&q)[kLane]) {
  union { int8_t b[kLane]; uint2 u; } pk;
#pragma unroll
  for (int i = 0; i < kLane; ++i) pk.b[i] = q[i];
  *reinterpret_cast<uint2*>(p) = pk.u;
}

// Blockwise requantize of the warp's 256 values (8 per lane): the whole
// warp must call it. Returns the block's bf16 scale on every lane, the
// lane's int8 values in q and their dequantized image q * sf in d.
__device__ __forceinline__ __nv_bfloat16 requant_lane(
    const float (&x)[kLane], int8_t (&q)[kLane], float (&d)[kLane]) {
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kLane; ++i) a = max_nan(a, fabsf(x[i]));
  a = warp_max(a);
  const __nv_bfloat16 sc = __float2bfloat16_rn(__fdiv_rn(a, 127.0f));
  const float sf = __bfloat162float(sc);
#pragma unroll
  for (int i = 0; i < kLane; ++i) {
    float v = 0.0f;
    if (sf > 0.0f) {
      v = rintf(__fdiv_rn(x[i], sf));  // round half to even, as jnp.round
      // a NaN quotient (inf / inf) casts to 0; never convert a NaN
      v = (v != v) ? 0.0f : fminf(fmaxf(v, -127.0f), 127.0f);
    }
    q[i] = static_cast<int8_t>(static_cast<int>(v));
    d[i] = __fmul_rn(static_cast<float>(q[i]), sf);
  }
  return sc;
}

// Dequantize-accumulate of one lane's 8 elements over the n senders'
// rows of the post-all_to_all wire image (q [n, sp], s [n, sp/256]), in
// sender order from an f32 zero, exactly as the reference's
// deq.sum(axis=0): acc = acc + f32(q) * f32(s).
__device__ __forceinline__ void accumulate_lane(
    const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
    int n, long long sp, long long e, float (&acc)[kLane]) {
  const long long nbs = sp / kBlock;
  const long long blk = e / kBlock;
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
}

}  // namespace hvdt
