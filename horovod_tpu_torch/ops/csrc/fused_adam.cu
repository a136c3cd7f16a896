// Fused Adam update on Hopper: moments, bias correction and the -lr step
// in one pass.
//
// Replaces horovod_tpu/ops/pallas_kernels.py: fused_adam_update /
// _adam_kernel. (Its optional int8 requantize epilogue has no caller on
// the reference's training path; it is ported with the ZeRO-3 int8
// gather that would use it.)
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
// operations: 0.5 operations per byte against the card's ~20. The design
// reads and writes each array once, in float4s on a grid-stride loop
// (ragged tails and unaligned views take a scalar path).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct AdamConsts {
  float omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr;
};

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

__global__ void adam_kernel(const float* __restrict__ g,
                            const float* __restrict__ mu,
                            const float* __restrict__ nu,
                            float* __restrict__ u, float* __restrict__ mu2,
                            float* __restrict__ nu2, long long L,
                            AdamConsts c, int vec) {
  const long long groups = (L + 3) / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < groups; t += stride) {
    const long long e = t * 4;
    if (vec && e + 4 <= L) {
      const float4 gv = *reinterpret_cast<const float4*>(g + e);
      float4 mv = *reinterpret_cast<const float4*>(mu + e);
      float4 nv = *reinterpret_cast<const float4*>(nu + e);
      float4 uv;
      uv.x = adam_elem(gv.x, mv.x, nv.x, c);
      uv.y = adam_elem(gv.y, mv.y, nv.y, c);
      uv.z = adam_elem(gv.z, mv.z, nv.z, c);
      uv.w = adam_elem(gv.w, mv.w, nv.w, c);
      *reinterpret_cast<float4*>(u + e) = uv;
      *reinterpret_cast<float4*>(mu2 + e) = mv;
      *reinterpret_cast<float4*>(nu2 + e) = nv;
    } else {
      for (long long i = e; i < L && i < e + 4; ++i) {
        float m = mu[i], v = nu[i];
        u[i] = adam_elem(g[i], m, v, c);
        mu2[i] = m;
        nu2[i] = v;
      }
    }
  }
}

}  // namespace

extern "C" {

// g, mu, nu f32 [L] -> u, mu2, nu2 f32 [L].
// vec != 0 promises every pointer is 16-byte aligned.
int hvd_fused_adam(const void* g, const void* mu, const void* nu, void* u,
                   void* mu2, void* nu2, long long L, float omb1, float b1,
                   float omb2, float b2, float b1c, float b2c, float eps,
                   float eps_root, float neg_lr, int vec, void* stream) {
  const AdamConsts c{omb1, b1, omb2, b2, b1c, b2c, eps, eps_root, neg_lr};
  long long blocks = ((L + 3) / 4 + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;     // grid-stride beyond this
  adam_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(mu),
      static_cast<const float*>(nu), static_cast<float*>(u),
      static_cast<float*>(mu2), static_cast<float*>(nu2), L, c, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
