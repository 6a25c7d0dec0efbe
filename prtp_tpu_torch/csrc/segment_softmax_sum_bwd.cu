// segment_softmax_sum_bwd: the per-edge cotangent of the segment
// reduce's cell-half softmax-weighted sum, read straight from the final
// node state hf.
//
// Replaces, for each level pair k > 0, the backward that XLA's autodiff
// takes through prtp_tpu/ops/segment.py::segment_softmax_sum_fused
// (:51-63) under reduce_mode='segment' (prtp_tpu/models/gnn.py:184-186):
// the transposed segment sums, the exp's and the division's cotangents
// gathered back to the edges. For an edge e of destination slot s and a
// channel c, with x = hf[src[e], c] and the forward's per-slot shift mx,
// denominator den and output out (segment_softmax_sum):
//   w = exp(x - mx[s, c]) / max(den[s, c], 1e-12)
//   d_msg[e, c] = (g[s, c] * w) * ((1 + x) - out[s, c])
// (the max's own cotangent, which cancels exactly, is left out). Reading
// hf is exact: every source row of a level is final once that level has
// been written. Under the edge-sharded step a rank passes its own block
// of edges with the slots' combined mx, den and out.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table and the offsets, four (S, D) slot tables read and the (E, D)
// cotangent written, over 3.35 TB/s; an exp and a few float operations
// an element. chip_smoke.py (phase 11) prints the bound at the
// headline's shapes beside the kernel's time.
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one destination slot, one float4 of channels a lane (a
// whole warp at D = 128); it loads the slot's four float4s of g, out, mx
// and den once, then walks the slot's edges, one load of hf and one
// store a float4 each. D % 4 != 0 or a pointer off 16-byte alignment
// takes the scalar path (N = 1). Launched plainly.

#include <math.h>

#include "common.cuh"

template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_softmax_sum_bwd_kernel(const float* __restrict__ h,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ off,
                                   const float* __restrict__ out,
                                   const float* __restrict__ mx,
                                   const float* __restrict__ den,
                                   const float* __restrict__ g,
                                   float* __restrict__ d_msg, int64_t segs,
                                   int d, int group) {
  const RowLanes rl = row_lanes(group);
  if (rl.row >= segs) return;
  const int vecs = d / N;
  const int32_t begin = __ldg(off + rl.row);
  const int32_t end = __ldg(off + rl.row + 1);
  if (begin == end) return;
  const int64_t o = rl.row * d;
  for (int c = rl.lane; c < vecs; c += group) {
    float f[N], m[N], dd[N], gs[N], x[N], r[N];
    load_vec<N>(out + o + c * N, f);
    load_vec<N>(mx + o + c * N, m);
    load_vec<N>(den + o + c * N, dd);
    load_vec<N>(g + o + c * N, gs);
#pragma unroll
    for (int i = 0; i < N; ++i) dd[i] = fmaxf(dd[i], 1e-12f);
    for (int32_t e = begin; e < end; ++e) {
      load_vec<N>(h + static_cast<int64_t>(__ldg(src + e)) * d + c * N, x);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float w = expf(x[i] - m[i]) / dd[i];
        r[i] = (gs[i] * w) * ((1.f + x[i]) - f[i]);
      }
      store_vec<N>(d_msg + static_cast<int64_t>(e) * d + c * N, r);
    }
  }
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, out, mx, den, g: (segs, d) float32, d_msg:
// (off[segs], d) float32.
PRTP_EXPORT int segment_softmax_sum_bwd_launch(
    const void* h, const void* src, const void* off, const void* out,
    const void* mx, const void* den, const void* g, void* d_msg,
    int64_t segs, int d, void* stream) {
  if (segs == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  const float* fp = static_cast<const float*>(out);
  const float* mp = static_cast<const float*>(mx);
  const float* dp = static_cast<const float*>(den);
  const float* gp = static_cast<const float*>(g);
  float* rp = static_cast<float*>(d_msg);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(mx) | reinterpret_cast<uintptr_t>(den) |
      reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(d_msg);
  const bool vec4 = d % 4 == 0 && align % 16 == 0;
  const int group = lane_group(vec4 ? d / 4 : d);
  const unsigned grid = mailbox_grid(segs, group);
  if (vec4)
    segment_softmax_sum_bwd_kernel<4><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, fp, mp, dp, gp, rp, segs, d, group);
  else
    segment_softmax_sum_bwd_kernel<1><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, fp, mp, dp, gp, rp, segs, d, group);
  return static_cast<int>(cudaGetLastError());
}
