// Flash-attention forward on Hopper: causal or full online-softmax
// attention that emits out and the log-sum-exp rows, GQA zero-copy.
//
// Replaces horovod_tpu/ops/flash_attention.py: _flash_fwd_pallas /
// _flash_fwd_kernel. What it computes, as the reference does:
//   q scaled by sm_scale in f32 before the dot; f32 scores; the causal
//   mask q_id >= k_id with NEG_INF = -1e30 (a true -inf gives NaN in
//   m_prev - m_new); the online-softmax m, l, acc in f32; K tiles wholly
//   in the causal future skipped; out = acc / l rounded once to the
//   output type (bf16 by round-to-nearest-even), zeros where l == 0;
//   lse = m + log(max(l, 1e-30)), or LSE_MASKED = 1e30 where l == 0.
// expf/logf and IEEE division: the file is built without fast math.
//
// Layout: q [B, Tq, H, D], k/v [B, Tk, H_kv, D], read through their
// strides (the last dim must be contiguous), so the views the model
// splits out of its fused qkv projection are read in place. Query head h
// of batch b reads kv row (b, h / (H / H_kv)): the reference's kv-row map
// (bh / H) * H_kv + (bh % H) / g, with no H-wide K/V ever built.
// out [B, Tq, H, D] and lse [B, H, Tq] are contiguous.
//
// Design. The TPU kernel walks a sequential k-block grid axis carrying
// m/l/acc in VMEM scratch; on the GPU blocks share nothing, so one block
// owns a (batch*head, 64-row q tile) and loops over the 64-row K/V tiles
// up to its causal limit, m/l/acc in registers. Each K/V tile is staged
// once through shared memory as f32 (rows padded to D+1 floats so the
// strided reads below hit distinct banks). 256 threads: thread (ty, tx)
// owns score rows ty + 16i and columns tx + 16j (i, j < 4), and output
// columns tx + 16c; a row's 16 owners are one half-warp, so the row max
// and row sum are 4 shuffles. P goes through shared memory for P.V.
// Ragged edges are masked: rows past Tq are computed and not written,
// keys past Tk get p = 0. Longest causal tiles are launched first.
//
// Bound at the training path's shape (q/k/v [8, 2048, 16, 64] bf16,
// causal): 135 MB moved (0.040 ms at 3.35 TB/s) against 68.8 GFLOP of
// dot products over the 2048 * 2049 / 2 (query, key) pairs the causal
// mask keeps, per (batch, head): 0.070 ms at the bf16 tensor-core peak,
// 1.03 ms at the f32 rate outside the tensor cores. It is bound by
// operations. The kernel computes the whole of the 528 of 1024 64x64
// tiles the causal skip keeps, 3% more than the pairs. This first kernel does
// its dots as f32 FMAs from shared memory (one shared load per two
// FMAs), so the f32 figure is its own ceiling; tensor cores (wgmma) and
// TMA-fed tiles are the later step toward the bf16 bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;         // q rows and k rows per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr float kNegInf = -1e30f;
constexpr float kLseMasked = 1e30f;

struct Strides {
  long long b, t, h;              // elements; the d stride is 1
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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
constexpr size_t smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * (kTile + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
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

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D, t = q0 + r;
    Qs[r * S + d] =
        t < T_q ? __fmul_rn(to_f32(qb[t * sq.t + d]), sm_scale) : 0.f;
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
      Ks[r * S + d] = in ? to_f32(kb[t * sk.t + d]) : 0.f;
      Vs[r * S + d] = in ? to_f32(vb[t * sv.t + d]) : 0.f;
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
    T* orow = out + ((static_cast<long long>(b) * T_q + t) * H + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      store_out(orow + tx + 16 * c, pos ? __fdiv_rn(acc[i][c], l[i]) : 0.f);
    if (tx == 0)
      lse[static_cast<long long>(bh) * T_q + t] =
          pos ? m[i] + logf(fmaxf(l[i], 1e-30f)) : kLseMasked;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int H_kv, int T_q, int T_k, Strides sq, Strides sk,
           Strides sv, float sm_scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_q + kTile - 1) / kTile, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), H, H_kv, T_q, T_k, sq, sk, sv, sm_scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [B, Tq, H, D], k/v [B, Tk, H_kv, D] (strides in elements, d stride 1)
// -> out [B, Tq, H, D] (q's type), lse [B, H, Tq] f32, both contiguous.
// is_bf16 selects bf16 inputs/output, else f32. D is 64 or 128.
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
  if (is_bf16) {
    if (D == 64)
      return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, H_kv, T_q,
                                       T_k, sq, sk, sv, sm_scale, causal, st);
    if (D == 128)
      return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, H_kv, T_q,
                                        T_k, sq, sk, sv, sm_scale, causal, st);
  } else {
    if (D == 64)
      return launch<float, 64>(q, k, v, out, lse, B, H, H_kv, T_q, T_k, sq,
                               sk, sv, sm_scale, causal, st);
    if (D == 128)
      return launch<float, 128>(q, k, v, out, lse, B, H, H_kv, T_q, T_k, sq,
                                sk, sv, sm_scale, causal, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
