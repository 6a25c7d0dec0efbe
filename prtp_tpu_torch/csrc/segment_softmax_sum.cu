// segment_softmax_sum: the segment reduce's cell-half softmax-weighted sum
// over a level's flat edge table, read straight from the node state h.
//
// Replaces, for each level pair k > 0 of the pair step under
// reduce_mode='segment' (prtp_tpu/models/gnn.py::_PairStep.__call__,
// :184-186), the edge gather `msg = h[xs["cell_src"]]` and
// prtp_tpu/ops/segment.py::segment_softmax_sum_fused (:51-63). The
// (E, D) message table is never built. The edges are sorted by
// destination slot; slot s owns edges [off[s], off[s + 1]). For a slot s
// and a channel c, over its edges e:
//   mx    = max_e h[src[e], c]   (NaN if any is NaN, as XLA's max; 0 when
//                                 not finite: JAX's isfinite guard, so an
//                                 empty slot's shift is 0)
//   den   = sum_e exp(h[src[e], c] - mx)
//   numer = sum_e exp(h[src[e], c] - mx) * h[src[e], c]
//   out[s, c] = numer / max(den, 1e-12)    (or numer, with `partial`)
// and mx_out[s, c] = mx, den_out[s, c] = den, which the backward
// (segment_softmax_sum_bwd) and the edge-sharded step's combine over
// ranks (prtp_tpu_torch/parallel/graph_shard.py) read. An empty slot gives
// out 0, mx 0 and den 0, never NaN. With `partial` the kernel writes the
// numerator: a rank of the edge-sharded step holds only a block of the
// edges, and the ranks' partial sums are rescaled to the common max and
// added before the division.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table and the offsets, and three (S, D) outputs written, over 3.35
// TB/s; an exp and a few float operations an element, far below the f32
// rate. The saved shift and denominator count among the outputs, though
// JAX's fused op returns only `out` (its backward recomputes them);
// chip_smoke.py (phase 11) prints the bound at the headline's shapes
// with them and without them, beside the kernel's time.
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one destination slot, one float4 of channels a lane (a
// whole warp at D = 128), walking the slot's edge range twice (the max,
// then the exp sums); each edge's source index is a broadcast load, and
// the second pass finds its rows in L1 or L2. A slot's in-degree is
// small (a cell's fan-in), so the walk is short. D % 4 != 0 or a pointer
// off 16-byte alignment takes the scalar path (N = 1). Launched plainly.

#include <math.h>

#include "common.cuh"

template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_softmax_sum_kernel(const float* __restrict__ h,
                               const int32_t* __restrict__ src,
                               const int32_t* __restrict__ off,
                               float* __restrict__ out,
                               float* __restrict__ mx_out,
                               float* __restrict__ den_out, int64_t segs,
                               int d, int partial, int group) {
  const RowLanes rl = row_lanes(group);
  if (rl.row >= segs) return;
  const int vecs = d / N;
  const int32_t begin = __ldg(off + rl.row);
  const int32_t end = __ldg(off + rl.row + 1);
  const int64_t o = rl.row * d;
  for (int c = rl.lane; c < vecs; c += group) {
    float mx[N], den[N], num[N], x[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      mx[i] = -INFINITY;
      den[i] = num[i] = 0.f;
    }
    for (int32_t e = begin; e < end; ++e) {
      load_vec<N>(h + static_cast<int64_t>(__ldg(src + e)) * d + c * N, x);
#pragma unroll
      for (int i = 0; i < N; ++i) mx[i] = nan_max(mx[i], x[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (!isfinite(mx[i])) mx[i] = 0.f;
    for (int32_t e = begin; e < end; ++e) {
      load_vec<N>(h + static_cast<int64_t>(__ldg(src + e)) * d + c * N, x);
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ex = expf(x[i] - mx[i]);
        den[i] += ex;
        num[i] += ex * x[i];
      }
    }
    float res[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      res[i] = partial ? num[i] : num[i] / fmaxf(den[i], 1e-12f);
    store_vec<N>(out + o + c * N, res);
    store_vec<N>(mx_out + o + c * N, mx);
    store_vec<N>(den_out + o + c * N, den);
  }
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, out, mx, den: (segs, d) float32.
PRTP_EXPORT int segment_softmax_sum_launch(const void* h, const void* src,
                                           const void* off, void* out,
                                           void* mx, void* den, int64_t segs,
                                           int d, int partial, void* stream) {
  if (segs == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  float* outp = static_cast<float*>(out);
  float* mp = static_cast<float*>(mx);
  float* dp = static_cast<float*>(den);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out) |
      reinterpret_cast<uintptr_t>(mx) | reinterpret_cast<uintptr_t>(den);
  const bool vec4 = d % 4 == 0 && align % 16 == 0;
  const int group = lane_group(vec4 ? d / 4 : d);
  const unsigned grid = mailbox_grid(segs, group);
  if (vec4)
    segment_softmax_sum_kernel<4><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, outp, mp, dp, segs, d, partial, group);
  else
    segment_softmax_sum_kernel<1><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, outp, mp, dp, segs, d, partial, group);
  return static_cast<int>(cudaGetLastError());
}
