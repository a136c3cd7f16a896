// Flash-attention forward on Hopper: causal or full online-softmax
// attention that emits out and the log-sum-exp rows, GQA zero-copy.
//
// Replaces horovod_tpu/ops/flash_attention.py: _flash_fwd_pallas /
// _flash_fwd_kernel. What it computes, as the reference does:
//   f32 scores of q against k scaled by sm_scale; the causal mask
//   q_id >= k_id with NEG_INF = -1e30 (a true -inf gives NaN in
//   m_prev - m_new); the online-softmax m, l, acc in f32; K tiles wholly
//   in the causal future skipped; out = acc / l rounded once to the
//   output type (bf16 by round-to-nearest-even), zeros where l == 0;
//   lse = m + log(max(l, 1e-30)), or LSE_MASKED = 1e30 where l == 0.
// logf and IEEE division: the file is built without fast math. The bf16
// kernel takes exp(x) as exp2f(x * log2(e)) on the scaled f32 score
// differences (one multiply and the hardware's 2^x), the f32 kernel expf.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H_kv, D], read through their
// strides (the last dim must be contiguous), so the views the model
// splits out of its fused qkv projection are read in place. Query head h
// of batch b reads kv row (b, h / (H / H_kv)): the reference's kv-row map
// (bh / H) * H_kv + (bh % H) / g, with no H-wide K/V ever built.
// out [B, Tq, H, D] and lse [B, H, Tq] are contiguous.
//
// Grid. The TPU kernel walks a sequential k-block grid axis carrying
// m/l/acc in VMEM scratch; on the GPU blocks share nothing, so one block
// owns a (batch*head, 64-row q tile) and loops over the 64-key K/V tiles
// up to its causal limit, m/l/acc in registers. Ragged edges are masked:
// rows past Tq are computed and not written, keys past Tk get p = 0.
// Longest causal tiles are launched first.
//
// bf16 inputs (flash_fwd_mma; every training path): tensor cores and
// asynchronous copies, FlashAttention-2's design on mma.sync. 4 warps, each
// owning 16 query rows. K/V tiles arrive by cp.async (16 bytes a thread,
// zero-filled past Tk) into a two-stage ring in shared memory, tile j+1
// in flight while tile j is computed; rows padded by 16 bytes so the
// ldmatrix reads hit distinct banks. S = Q.K^T by mma.m16n8k16 (bf16 in,
// f32 accumulate) from Q fragments held in registers and K fragments by
// ldmatrix; q and k go in unscaled (bf16 x bf16 products are exact) and S
// is multiplied by sm_scale in f32 (for D = 64 the scale is 2^-3, so
// this is exactly the reference's q*scale in f32). The f32 C fragment of
// S is the A fragment of P.V, never leaving registers; V fragments by
// ldmatrix.trans. P.V is issued as P_hi.V + P_lo.V into one f32
// accumulator, P_hi = bf16(p), P_lo = bf16(p - P_hi): P rounded to bf16
// alone puts early causal rows, where a few keys cancel, tens of bf16
// ULPs off (the rounding error is relative to |v|, not to |out|); the
// split keeps them within one. That is 1.5x the dot products the bound
// counts. wgmma with TMA-fed tiles is the next step toward the bound.
//
// f32 inputs (flash_fwd_f32; no training path gives them): 256 threads,
// thread (ty, tx) owns score rows ty + 16i and columns tx + 16j; f32 FMAs
// from shared memory, P through shared memory for P.V.
//
// Bound at the training path's shape (q/k/v [8, 2048, 16, 64] bf16,
// causal): 135 MB moved (0.040 ms at 3.35 TB/s) against 68.8 GFLOP of
// dot products over the 2048 * 2049 / 2 (query, key) pairs the causal
// mask keeps, per (batch, head): 0.070 ms at the bf16 tensor-core peak.
// It is bound by operations. The kernel computes the whole of the 528 of
// 1024 64x64 tiles the causal skip keeps, 3% more than the pairs, and
// the P split's third product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // q rows and k rows per tile
constexpr int kThreads = 256;     // flash_fwd_f32: 16 x 16
constexpr int kMmaThreads = 128;  // flash_fwd_mma: 4 warps of 16 q rows
constexpr float kNegInf = -1e30f;
constexpr float kLseMasked = 1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

struct Strides {
  long long b, t, h;              // elements; the d stride is 1
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) and cp.async

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zeros where !in (no global read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// p (two neighbouring columns) -> bf16 hi and lo parts, p ~= hi + lo
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(__fsub_rn(p0, __low2float(h)),
                                    __fsub_rn(p1, __high2float(h))));
}

template <int D>
__host__ __device__ constexpr int mma_stride() {  // bf16 row stride in smem
  return D + 8;
}

template <int D>
__host__ __device__ constexpr size_t mma_smem_bytes() {  // Q; K, V x 2
  return sizeof(bf16) * 5 * kTile * mma_stride<D>();
}

// rows [r0, r0 + 64) of a [T, D] matrix with row stride st -> smem
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long st, int r0, int T) {
  constexpr int kPieces = D / 8;              // 16 bytes a piece
  constexpr int SR = mma_stride<D>();
#pragma unroll
  for (int j = 0; j < kTile * kPieces / kMmaThreads; ++j) {
    const int i = threadIdx.x + j * kMmaThreads;
    const int r = i / kPieces, c = (i % kPieces) * 8, t = r0 + r;
    const bool in = t < T;
    cp_async16(smem_u32(dst + r * SR + c),
               src + (in ? static_cast<long long>(t) * st + c : 0), in);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ lse, int H, int H_kv, int T_q, int T_k,
              Strides sq, Strides sk, Strides sv, float sm_scale,
              int causal) {
  constexpr int SR = mma_stride<D>();
  constexpr int KT = D / 16;      // k-steps of Q.K^T
  constexpr int DN = D / 8;       // n-tiles (8 columns) of the output
  constexpr int NT = kTile / 8;   // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * SR;     // two stages
  bf16* Vs = Ks + 2 * kTile * SR;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;     // C fragment: row g, cols 2tq
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / H_kv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int row0 = q0 + warp * 16;            // this warp's first q row

  const bf16* qb = q + b * sq.b + h * sq.h;
  const bf16* kb = k + b * sk.b + hk * sk.h;
  const bf16* vb = v + b * sv.b + hk * sv.h;

  int n_k = (T_k + kTile - 1) / kTile;
  if (causal) n_k = min(n_k, (min(q0 + kTile, T_q) - 1) / kTile + 1);

  load_tile<D>(Qs, qb, sq.t, q0, T_q);
  load_tile<D>(Ks, kb, sk.t, 0, T_k);
  load_tile<D>(Vs, vb, sv.t, 0, T_k);
  cp_async_commit();

  uint32_t qf[KT][4];
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // rows g, g + 8

  for (int j = 0; j < n_k; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_k) {            // tile j + 1 in flight during tile j
      load_tile<D>(Ks + (stage ^ 1) * kTile * SR, kb, sk.t, (j + 1) * kTile,
                   T_k);
      load_tile<D>(Vs + (stage ^ 1) * kTile * SR, vb, sv.t, (j + 1) * kTile,
                   T_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm_x4(qf[kk], smem_u32(Qs + (warp * 16 + (lane & 15)) * SR +
                                 kk * 16 + (lane >> 4) * 8));
    }
    const bf16* Kt = Ks + stage * kTile * SR;
    const bf16* Vt = Vs + stage * kTile * SR;

    // S = Q.K^T, 16 rows x 64 keys a warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(Kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * SR +
                             kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax (f32)
    const int k0 = j * kTile;
    const bool edge = k0 + kTile > T_k || (causal && k0 + kTile - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fmul_rn(s[n][c], sm_scale);
        if (edge) {
          const int kj = k0 + n * 8 + 2 * tq + (c & 1);
          const int qi = row0 + g + 8 * (c >> 1);
          if (kj >= T_k)
            x = -INFINITY;        // past the ragged edge: p = 0
          else if (causal && qi < kj)
            x = kNegInf;          // the reference's mask
        }
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's four owners are one quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(__fmul_rn(m[r] - mx[r], kLog2e));
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[n][c] *= alpha[c >> 1];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(__fmul_rn(s[n][c] - m[c >> 1], kLog2e));
        s[n][c] = p;
        l[c >> 1] += p;           // this thread's share of the row sum
      }

    // acc += P_hi.V + P_lo.V; S's C fragments are P's A fragments
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DN / 2; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_u32(Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SR +
                               dp * 16 + (lane >> 4) * 8));
        mma_bf16(acc[2 * dp], ph, bv[0], bv[1]);
        mma_bf16(acc[2 * dp], pl, bv[0], bv[1]);
        mma_bf16(acc[2 * dp + 1], ph, bv[2], bv[3]);
        mma_bf16(acc[2 * dp + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();              // this stage is free for tile j + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + g + 8 * r;
    if (t >= T_q) continue;
    const bool pos = l[r] > 0.f;
    bf16* orow = out + ((static_cast<long long>(b) * T_q + t) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const float o0 = pos ? __fdiv_rn(acc[n][2 * r], l[r]) : 0.f;
      const float o1 = pos ? __fdiv_rn(acc[n][2 * r + 1], l[r]) : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * tq) =
          __floats2bfloat162_rn(o0, o1);
    }
    if (tq == 0)
      lse[static_cast<long long>(bh) * T_q + t] =
          pos ? m[r] + logf(fmaxf(l[r], 1e-30f)) : kLseMasked;
  }
}

// ---------------------------------------------------------------------------
// f32: FMAs from shared memory

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int H, int H_kv, int T_q, int T_k,
              Strides sq, Strides sk, Strides sv, float sm_scale,
              int causal) {
  constexpr int S = D + 1;        // padded row stride of Q/K/V tiles
  constexpr int SP = kTile + 1;   // padded row stride of the P tile
  constexpr int DC = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * S;
  float* Vs = Ks + kTile * S;
  float* Ps = Vs + kTile * S;

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int hk = h / (H / H_kv);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + hk * sk.h;
  const float* vb = v + b * sv.b + hk * sv.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    Qs[r * S + d] =
        t < T_q ? __fmul_rn(qb[t * sq.t + d], sm_scale) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int n_k = (T_k + kTile - 1) / kTile;
  if (causal) {
    const int q_last = min(q0 + kTile, T_q) - 1;
    n_k = min(n_k, q_last / kTile + 1);
  }

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the last tile's P.V is done with Ks/Vs/Ps
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int r = i / D, d = i % D, t = k0 + r;
      const bool in = t < T_k;
      Ks[r * S + d] = in ? kb[t * sk.t + d] : 0.f;
      Vs[r * S + d] = in ? vb[t * sv.t + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * S + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) c[jj] = Ks[(tx + 16 * jj) * S + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(a[i], c[jj], s[i][jj]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int kj = k0 + tx + 16 * jj;
        if (kj >= T_k)
          s[i][jj] = -INFINITY;       // past the ragged edge: p = 0
        else if (causal && qi < kj)
          s[i][jj] = kNegInf;         // the reference's mask
        mx = fmaxf(mx, s[i][jj]);
      }
      const float m_new = half_warp_max(mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * SP + tx + 16 * jj] = p;
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * SP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * S + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_q) continue;
    const bool pos = l[i] > 0.f;
    float* orow = out + ((static_cast<long long>(b) * T_q + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[tx + 16 * c] = pos ? __fdiv_rn(acc[i][c], l[i]) : 0.f;
    if (tx == 0)
      lse[static_cast<long long>(bh) * T_q + t] =
          pos ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kLseMasked;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int H_kv, int T_q, int T_k, Strides sq, Strides sk,
           Strides sv, float sm_scale, int causal, int is_bf16,
           cudaStream_t stream) {
  const dim3 grid((T_q + kTile - 1) / kTile, B * H);
  if (is_bf16) {
    // cp.async moves 16 bytes: every row must start 16-byte aligned
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                           reinterpret_cast<uintptr_t>(k) |
                           reinterpret_cast<uintptr_t>(v);
    const long long strides = sq.b | sq.t | sq.h | sk.b | sk.t | sk.h |
                              sv.b | sv.t | sv.h;
    if ((ptrs & 15) || (strides & 7))
      return static_cast<int>(cudaErrorMisalignedAddress);
    const size_t smem = mma_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_mma<D><<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out),
        static_cast<float*>(lse), H, H_kv, T_q, T_k, sq, sk, sv, sm_scale,
        causal);
  } else {
    const size_t smem = f32_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<D><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), H, H_kv, T_q, T_k, sq, sk, sv, sm_scale,
        causal);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Tq, H, D], k/v [B, Tk, H_kv, D] (strides in elements, d stride 1)
// -> out [B, Tq, H, D] (q's type), lse [B, H, Tq] f32, both contiguous.
// is_bf16 selects bf16 inputs/output (pointers 16-byte aligned, strides
// multiples of 8), else f32. D is 64 or 128.
int hvd_flash_fwd(const void* q, const void* k, const void* v, void* out,
                  void* lse, int B, int H, int H_kv, int T_q, int T_k, int D,
                  long long q_sb, long long q_st, long long q_sh,
                  long long k_sb, long long k_st, long long k_sh,
                  long long v_sb, long long v_st, long long v_sh,
                  float sm_scale, int causal, int is_bf16, void* stream) {
  const Strides sq{q_sb, q_st, q_sh}, sk{k_sb, k_st, k_sh},
      sv{v_sb, v_st, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || H < 1 || H_kv < 1 || H % H_kv || T_q < 1 || T_k < 1 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch<64>(q, k, v, out, lse, B, H, H_kv, T_q, T_k, sq, sk, sv,
                      sm_scale, causal, is_bf16, st);
  if (D == 128)
    return launch<128>(q, k, v, out, lse, B, H, H_kv, T_q, T_k, sq, sk, sv,
                       sm_scale, causal, is_bf16, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
