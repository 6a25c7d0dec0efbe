// segment_softmax_sum_bwd: the per-edge cotangent of the segment
// reduce's cell-half softmax-weighted sum, read straight from the final
// node state hf.
//
// Replaces, for each level pair k > 0, the backward that XLA's autodiff
// takes through prtp_tpu/ops/segment.py::segment_softmax_sum_fused
// (:51-63) under reduce_mode='segment' (prtp_tpu/models/gnn.py:184-186):
// the transposed segment sums, the exp's and the division's cotangents
// gathered back to the edges. For an edge e of destination slot s and a
// channel c, with x = hf[src[e], c] and the slot's shift mx, denominator
// den and output out (segment_softmax_sum):
//   w = exp(x - mx[s, c]) / max(den[s, c], 1e-12)
//   d_msg[e, c] = (g[s, c] * w) * ((1 + x) - out[s, c])
// (the max's own cotangent, which cancels exactly, is left out). Reading
// hf is exact: every source row of a level is final once that level has
// been written. Two modes:
// - recomputing (out, mx, den null; the unsharded walk): the kernel
//   recomputes the slot's mx, den and out from the rows it reads, with
//   the forward's functions (common.cuh, "the segment reduce's
//   softmax"), so they are the forward's bits; the forward keeps none of
//   them for it.
// - stats-reading (the edge-sharded step): a rank holds only a block of
//   a slot's edges, so it cannot recompute the slot; it passes its block
//   with the slots' combined mx, den and out, which the kernel reads.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table and the offsets, the (S, D) cotangent g read (stats-reading:
// also out, mx and den) and the (E, D) cotangent written, over 3.35
// TB/s; an exp and a few float operations an element. At the headline
// design (pairs 1-9) that is 80.8 MB, 0.0241 ms a backward, recomputing,
// and 124.2 MB, 0.0371 ms, stats-reading (chip_smoke.py, phase 11 (a),
// which prints each beside the kernel's time and its one-slot floor).
//
// Design: the lane layout of segment_softmax_sum (common.cuh): a lane
// group covers one destination slot, one float4 of channels a lane (a
// whole warp at D = 128), the slot's offsets and, for deg <= kSlotRows
// (4), its indices loaded once and shared by shuffle (slot_edges). On
// that register path every row's 16-byte load is issued before any
// arithmetic and kept in registers; then each edge's float4 of cotangent
// is stored (a 512-byte row segment across the warp at D = 128). A slot
// of more than 4 edges takes the generic path, which walks its edge
// range 4 rows at a time, each 4 loads issued together (twice to
// recompute, then once to store); D % 4 != 0 or a pointer off 16-byte
// alignment takes the scalar path (N = 1).
//
// Launched as a programmatic dependent launch (common.cuh), so that the
// launch, the off -> src -> hf chain of loads and the slot's softmax
// overlap the kernels before it. Before grid_dep_wait() the kernel reads
// off and src (the graph's tables), hf (the walk's final state, written
// by the forward before the backward began) and, stats-reading, the
// saved out, mx and den (written by the forward's combine); it
// recomputes the slot's softmax there. After it, g (d_f, which the
// fc_cell_neigh gradients just before this kernel write), then every
// store.

#include "common.cuh"

// The cotangent of edge e at channel offset col, stored: (g * w) * ((1 +
// x) - f) with w = exp(x - m) / dd (dd already clamped at 1e-12).
template <int N>
__device__ __forceinline__ void store_cotangent(float* d_msg, int64_t e, int d,
                                                int col, const float (&x)[N],
                                                const float (&gs)[N],
                                                const float (&m)[N],
                                                const float (&dd)[N],
                                                const float (&f)[N]) {
  float r[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    r[i] = (gs[i] * (expf(x[i] - m[i]) / dd[i])) * ((1.f + x[i]) - f[i]);
  store_vec<N>(d_msg + e * d + col, r);
}

// STATS: the stats-reading mode; else the recomputing one.
template <int N, bool STATS>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_softmax_sum_bwd_kernel(const float* __restrict__ h,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ off,
                                   const float* __restrict__ out,
                                   const float* __restrict__ mx,
                                   const float* __restrict__ den,
                                   const float* g, float* __restrict__ d_msg,
                                   int64_t segs, int d, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < segs;
  // ---- before the wait: off, src, hf and the saved statistics ----
  int32_t begin, idx[kSlotRows];
  const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
  if (deg == 0) return;  // an empty slot, or past the last
  const int vecs = d / N;
  const int64_t o = rl.row * d;
  for (int c = rl.lane; c < vecs; c += group) {
    float x[kSlotRows][N], f[N], m[N], dd[N], gs[N];
    if (STATS) {
      load_vec<N>(out + o + c * N, f);
      load_vec<N>(mx + o + c * N, m);
      load_vec<N>(den + o + c * N, dd);
      load_head<N, false>(h, idx, deg, d, c * N, x);
    } else {
      float num[N];
      slot_softmax<N, false>(h, src, begin, deg, idx, d, c * N, x, m, dd,
                             num);
#pragma unroll
      for (int i = 0; i < N; ++i) f[i] = softmax_out(num[i], dd[i]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dd[i] = fmaxf(dd[i], 1e-12f);
    // ---- after the wait: g, then the stores ----
    grid_dep_wait();
    load_vec_cg<N>(g + o + c * N, gs);
    if (deg <= kSlotRows) {  // the rows are in x
#pragma unroll
      for (int j = 0; j < kSlotRows; ++j)
        if (j < deg)
          store_cotangent<N>(d_msg, begin + j, d, c * N, x[j], gs, m, dd, f);
      continue;
    }
#pragma unroll 1
    for (int32_t j = begin; j < begin + deg; j += kSlotRows) {
      const int n = min(kSlotRows, begin + deg - j);
      load_rows<N, false>(h, src, j, n, d, c * N, x);
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i)
        if (i < n)
          store_cotangent<N>(d_msg, j + i, d, c * N, x[i], gs, m, dd, f);
    }
  }
}

template <int N>
static cudaError_t launch(const float* h, const int32_t* src,
                          const int32_t* off, const float* out,
                          const float* mx, const float* den, const float* g,
                          float* d_msg, int64_t segs, int d, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  const unsigned grid = mailbox_grid(segs, group);
  auto kernel = out != nullptr ? &segment_softmax_sum_bwd_kernel<N, true>
                               : &segment_softmax_sum_bwd_kernel<N, false>;
  return launch_programmatic(kernel, grid, kMailboxThreads, 0, s, h, src, off,
                             out, mx, den, g, d_msg, segs, d, group);
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, g: (segs, d) float32, d_msg: (off[segs], d) float32;
// out, mx, den: (segs, d) float32 all three (stats-reading), or all
// null (recomputing).
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
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4>(hp, sp, op, fp, mp, dp, gp, rp, segs, d, s)
          : launch<1>(hp, sp, op, fp, mp, dp, gp, rp, segs, d, s);
  return static_cast<int>(err);
}
