// Device code shared by the int8-wire kernels (int8_wire.cu) and fused
// Adam's int8 epilogue (fused_adam.cu).
//
// A 256-element scale block is held by 256 / E lanes of one warp, E
// consecutive elements a lane: E = 8 (kLane) gives a warp a block, E = 16
// (kWide, one 16-byte int8 load) a half-warp a block. Every rounding is
// pinned so the result is bit-identical to the JAX package's discrete
// expressions (compression.quantize_blockwise):
//   amax = max(|x|); sc = bf16_rne(amax / 127); sf = f32(sc);
//   q = sf > 0 ? clip(round_half_even(x / sf), -127, 127) : 0
// The build passes no -use_fast_math; amax / 127, once a block, is an
// IEEE division (__fdiv_rn).
//
// The quotient takes no divide an element. x / sf only feeds the rounding
// and the clip, so with rcp = __frcp_rn(sf) once a block, rint(x * rcp)
// (one fma, the product unrounded) rounds as fl(x / sf) wherever x * rcp
// lies farther than 2^-14 from a half-integer: for a normal sf both lie
// within 2^-24 |x / sf| of x / sf, under 2^-16 where the clip leaves q
// alone (|x / sf| < 128), and beyond it both clip to +-127. The elements
// nearer than that (about 2^-13 of random ones) take
// clip(rintf(__fdiv_rn(x, sf))) as before, and so does every element of a
// block whose sf is neither a normal f32 nor inf (rcp is made NaN). So q
// is bit-equal
// to clip(rintf(__fdiv_rn(x, sf))) for every x and sf;
// tests/test_torch_int8_rounding.py holds a numpy model of these lines
// against IEEE division.
//
// No type conversion either: an int8 becomes a float through its byte,
// biased by 128, placed in the mantissa of 2^23, and t + 1.5 * 2^23
// rounds t half to even, the low byte of the sum's bits being the int8.
//
// Non-finite input follows the reference: a NaN in a block makes its max
// and scale NaN and its q all 0 (NaN > 0 is false); an infinity makes the
// scale inf, so rcp = 0: finite x gives q 0 as x / inf does, and inf * 0
// = NaN takes the divide; inf / inf = NaN, which becomes 0 as XLA's
// float-to-int cast makes it. The roundtrip image q * sf is then NaN
// throughout such a block, as in the reference.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hvdt {

constexpr int kBlock = 256;             // compression.INT8_BLOCK
constexpr int kLane = kBlock / 32;      // elements a lane, a warp a block
constexpr int kWide = 16;               // elements a lane, a half-warp a block

// t + kRound, for |t| < 2^22, is round_half_even(t) + kRound exactly
constexpr float kRound = 12582912.0f;   // 1.5 * 2^23
// t nearer than this to an integer rounds as x / sf does
constexpr float kNearHalf = 0.5f - 0x1p-14f;

// max and min that propagate NaN, as jnp.max does (fmaxf would drop it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// max over each aligned group of kWidth lanes (a block's lanes)
template <int kWidth>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = kWidth / 2; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void load8(const float* p, float (&x)[kLane]) {
  const float4* s = reinterpret_cast<const float4*>(p);
  float4 a = s[0], b = s[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int kE>
__device__ __forceinline__ void store(float* p, const float (&x)[kE]) {
  float4* d = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < kE / 4; ++i)
    d[i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// the four int8 of w as exact floats, no conversion instruction
__device__ __forceinline__ void unpack4(uint32_t w, float* f) {
  const uint32_t b = w ^ 0x80808080u;   // int8 v -> uint8 v + 128
#pragma unroll
  for (int i = 0; i < 4; ++i)           // 2^23 + v + 128, less 2^23 + 128
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(b, 0x4B000000u, 0x7540 + i)),
                     8388736.0f);
}

// the int8 low bytes of four q + kRound (requant's u) in one word
__device__ __forceinline__ uint32_t pack4(const float* u) {
  const uint32_t lo = __byte_perm(__float_as_uint(u[0]), __float_as_uint(u[1]),
                                  0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(u[2]), __float_as_uint(u[3]),
                                  0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

struct Scale {
  __nv_bfloat16 sc;   // the block's bf16 scale
  float sf;           // f32(sc)
  float rcp;          // __frcp_rn(sf); NaN unless sf is a normal f32 or inf
};

__device__ __forceinline__ Scale block_scale(float amax) {
  Scale s;
  s.sc = __float2bfloat16_rn(__fdiv_rn(amax, 127.0f));
  s.sf = __bfloat162float(s.sc);
  s.rcp = __frcp_rn(s.sf);
  // sf below 2^-126 (rcp above 2^126 or inf), above 2^126 (rcp
  // subnormal: sf = bf16(amax / 127) never is), 0 or NaN
  if (!(s.rcp <= 0x1p126f && (s.rcp >= 0x1p-126f || s.rcp == 0.0f)))
    s.rcp = __int_as_float(0x7fc00000);
  return s;
}

// clip(round_half_even(x * rcp), -127, 127) + kRound, the product
// unrounded (one fma); ok when x * rcp lies farther than 2^-14 from a
// half-integer (NaN: never)
__device__ __forceinline__ float fast_biased(float x, float rcp, bool& ok) {
  const float u = __fmaf_rn(x, rcp, kRound);
  ok = fabsf(__fmaf_rn(x, rcp, -__fsub_rn(u, kRound))) < kNearHalf;
  return fminf(fmaxf(u, kRound - 127.0f), kRound + 127.0f);
}

// clip(round_half_even(x / sf), -127, 127) + kRound, 0 for a NaN quotient
__device__ __forceinline__ float exact_biased(float x, float sf) {
  const float v = rintf(__fdiv_rn(x, sf));
  return __fadd_rn(v != v ? 0.0f : fminf(fmaxf(v, -127.0f), 127.0f), kRound);
}

// Blockwise requantize of kE values a lane, 256 / kE lanes a block: every
// lane of the warp must call it. Returns the block's scale; u takes each
// value's q plus kRound: the low byte of its bits is q as an int8, and
// u - kRound is q as a float.
template <int kE>
__device__ __forceinline__ Scale requant(const float (&x)[kE],
                                         float (&u)[kE]) {
  float a = 0.0f;
#pragma unroll
  for (int i = 0; i < kE; ++i) a = max_nan(a, fabsf(x[i]));
  const Scale s = block_scale(group_max<kBlock / kE>(a));
  if (s.sf > 0.0f) {
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      bool ok;
      const float f = fast_biased(x[i], s.rcp, ok);
      u[i] = ok ? f : exact_biased(x[i], s.sf);
    }
  } else {
#pragma unroll
    for (int i = 0; i < kE; ++i) u[i] = kRound;
  }
  return s;
}

// A warp per block, 8 values a lane (B1 and B5's epilogue): the block's
// scale, the lane's int8 q packed in order, and their image q * sf.
__device__ __forceinline__ __nv_bfloat16 requant_lane(
    const float (&x)[kLane], uint2& q, float (&d)[kLane]) {
  float u[kLane];
  const Scale s = requant<kLane>(x, u);
  q = make_uint2(pack4(u), pack4(u + 4));
#pragma unroll
  for (int i = 0; i < kLane; ++i) d[i] = __fmul_rn(__fsub_rn(u[i], kRound), s.sf);
  return s.sc;
}

// The lane's kW words (4 int8 each) of one sender's row at p: one 16-byte
// load (kW = 4, kStride = 4), or a word every kStride bytes.
template <int kW, int kStride>
__device__ __forceinline__ void load_row(const int8_t* p, uint32_t (&w)[kW]) {
  if constexpr (kW == 4 && kStride == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kW; ++j)
      w[j] = *reinterpret_cast<const uint32_t*>(p + j * kStride);
  }
}

// acc = acc + f32(q) * f32(s) for the row's 4 * kW int8, in order
template <int kW>
__device__ __forceinline__ void add_row(const uint32_t (&w)[kW], float sc,
                                        float (&acc)[4 * kW]) {
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    float f[4];
    unpack4(w[j], f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      acc[4 * j + i] = __fadd_rn(acc[4 * j + i], __fmul_rn(f[i], sc));
  }
}

// Dequantize-accumulate of a lane's 4 * kW elements of scale block blk,
// the first at e, over the n senders' rows of the post-all_to_all wire
// image (q [n, sp], s [n, sp/256]) in sender order from an f32 zero,
// exactly as the reference's deq.sum(axis=0): acc = acc + f32(q) *
// f32(s). kN > 0 is n itself, and every sender's row is loaded before the
// first sum; kN = 0 takes any n, a row at a time.
template <int kN, int kW, int kStride>
__device__ __forceinline__ void accumulate(
    const int8_t* __restrict__ q, const __nv_bfloat16* __restrict__ s,
    int n, long long sp, long long blk, long long e, float (&acc)[4 * kW]) {
  const long long nbs = sp / kBlock;
#pragma unroll
  for (int i = 0; i < 4 * kW; ++i) acc[i] = 0.0f;
  if constexpr (kN > 0) {
    uint32_t w[kN][kW];
    float sc[kN];
#pragma unroll
    for (int r = 0; r < kN; ++r) {
      load_row<kW, kStride>(q + r * sp + e, w[r]);
      sc[r] = __bfloat162float(s[r * nbs + blk]);
    }
#pragma unroll
    for (int r = 0; r < kN; ++r) add_row<kW>(w[r], sc[r], acc);
  } else {
    for (int r = 0; r < n; ++r) {
      uint32_t w[kW];
      load_row<kW, kStride>(q + r * sp + e, w);
      add_row<kW>(w, __bfloat162float(s[r * nbs + blk]), acc);
    }
  }
}

}  // namespace hvdt
