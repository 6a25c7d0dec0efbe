// flat_adam: one Adam step over one flat parameter vector.
//
// Replaces the update of prtp_tpu/trainer.py::make_flat_adam (:81-93) and
// optax.apply_updates: per element, with coupled L2 weight decay,
//   g  = g + wd * p                      (only where wd != 0)
//   mu = b1 * mu + (1 - b1) * g
//   nu = b2 * nu + (1 - b2) * (g * g)
//   p  = p + (-lr * (mu / bc1)) / (sqrt(nu / bc2) + eps)
// with bc = 1 - b ** t from the host (float32, as JAX computes it). Every
// operation rounds on its own, in JAX's order (__f*_rn: nvcc would fuse a
// multiply and an add into one FMA), so the kernel gives the plain
// PyTorch version's bits.
//
// Bound on Hopper: bytes. p, g, mu and nu are read and p, mu and nu
// written: 28 bytes an element, about 15 float operations. The
// full-width regression PathModel has 2.73 M parameters: 76 MB a step,
// 23 us at 3.35 TB/s.
//
// Design: one launch, a grid-stride loop of float4 loads and stores (16
// bytes a lane, neighbouring lanes on neighbouring addresses), in place;
// the first threads of block 0 take the n % 4 tail elements. A vector
// off 16-byte alignment takes the scalar kernel (N = 1).

#include <math.h>

#include "common.cuh"

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ void adam_one(float& p, float g, float& mu,
                                         float& nu, const AdamArgs& a) {
  if (a.wd != 0.f) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  mu = __fadd_rn(__fmul_rn(a.b1, mu), __fmul_rn(a.omb1, g));
  nu = __fadd_rn(__fmul_rn(a.b2, nu), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  const float mu_hat = __fdiv_rn(mu, a.bc1);
  const float nu_hat = __fdiv_rn(nu, a.bc2);
  p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-a.lr, mu_hat),
                             __fadd_rn(__fsqrt_rn(nu_hat), a.eps)));
}

template <int N>
__global__ void __launch_bounds__(256)
    flat_adam_kernel(float* __restrict__ p, const float* __restrict__ g,
                     float* __restrict__ mu, float* __restrict__ nu,
                     int64_t n, AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       v < n / N; v += stride) {
    const int64_t o = v * N;
    float pv[N], gv[N], mv[N], nv[N];
    load_vec<N>(g + o, gv);
    if constexpr (N == 4) {
      const float4 tp = *reinterpret_cast<const float4*>(p + o);
      const float4 tm = *reinterpret_cast<const float4*>(mu + o);
      const float4 tn = *reinterpret_cast<const float4*>(nu + o);
      pv[0] = tp.x; pv[1] = tp.y; pv[2] = tp.z; pv[3] = tp.w;
      mv[0] = tm.x; mv[1] = tm.y; mv[2] = tm.z; mv[3] = tm.w;
      nv[0] = tn.x; nv[1] = tn.y; nv[2] = tn.z; nv[3] = tn.w;
    } else {
      pv[0] = p[o];
      mv[0] = mu[o];
      nv[0] = nu[o];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) adam_one(pv[i], gv[i], mv[i], nv[i], a);
    store_vec<N>(p + o, pv);
    store_vec<N>(mu + o, mv);
    store_vec<N>(nu + o, nv);
  }
  if (N > 1 && blockIdx.x == 0 && threadIdx.x < n % N) {
    const int64_t o = n / N * N + threadIdx.x;
    float pv = p[o], mv = mu[o], nv = nu[o];
    adam_one(pv, g[o], mv, nv, a);
    p[o] = pv;
    mu[o] = mv;
    nu[o] = nv;
  }
}

// p, g, mu, nu: (n,) float32; p, mu, nu updated in place.
PRTP_EXPORT int flat_adam_launch(void* p, const void* g, void* mu, void* nu,
                                 int64_t n, float lr, float b1, float omb1,
                                 float b2, float omb2, float eps, float wd,
                                 float bc1, float bc2, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AdamArgs a{lr, b1, omb1, b2, omb2, eps, wd, bc1, bc2};
  float* pp = static_cast<float*>(p);
  const float* gp = static_cast<const float*>(g);
  float* mp = static_cast<float*>(mu);
  float* np_ = static_cast<float*>(nu);
  constexpr int kThreads = 256;
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(mu) | reinterpret_cast<uintptr_t>(nu);
  auto blocks = [](int64_t lanes) {
    const int64_t b = (lanes + kThreads - 1) / kThreads;
    return static_cast<unsigned>(b < 132 * 16 ? (b > 0 ? b : 1) : 132 * 16);
  };
  if (align % 16 == 0)
    flat_adam_kernel<4><<<blocks(n / 4), kThreads, 0, s>>>(pp, gp, mp, np_,
                                                           n, a);
  else
    flat_adam_kernel<1><<<blocks(n), kThreads, 0, s>>>(pp, gp, mp, np_, n, a);
  return static_cast<int>(cudaGetLastError());
}
