// segment_softmax_sum: the segment reduce's cell-half softmax-weighted sum
// over a level's flat edge table, read straight from the node state h.
//
// Replaces, for each level pair k > 0 of the pair step under
// reduce_mode='segment' (prtp_tpu/models/gnn.py::_PairStep.__call__,
// :184-186), the edge gather `msg = h[xs["cell_src"]]` and
// prtp_tpu/ops/segment.py::segment_softmax_sum_fused (:51-63). The
// (E, D) message table is never built. The edges are sorted by
// destination slot; slot s owns edges [off[s], off[s + 1]). For a slot s
// and a channel c, over its edges e (common.cuh, "the segment reduce's
// softmax"):
//   mx    = max_e h[src[e], c]   (NaN if any is NaN, as XLA's max; 0 when
//                                 not finite: JAX's isfinite guard, so an
//                                 empty slot's shift is 0)
//   den   = sum_e exp(h[src[e], c] - mx)
//   numer = sum_e exp(h[src[e], c] - mx) * h[src[e], c]
//   out[s, c] = numer / max(den, 1e-12)
// An empty slot gives 0, never NaN. With `partial` (a rank of the
// edge-sharded step, prtp_tpu_torch/parallel/graph_shard.py, which holds
// only a block of the edges) the kernel writes the numerator undivided
// and also mx and den, which the combine over ranks rescales to the
// common max and adds before the division. Without it only out is
// written, as JAX's fused op returns only out: the backward
// (segment_softmax_sum_bwd) recomputes the shift and denominator from the
// rows it reads.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table and the offsets, and the (S, D) output written (with `partial`
// also mx and den: three (S, D) tables), over 3.35 TB/s; an exp and a
// few float operations an element, far below the f32 rate. At the
// headline design (pairs 1-9: 70,789 edges into 28,254 slots) that is
// 44.5 MB, 0.0133 ms a forward, and 73.5 MB, 0.0219 ms, with `partial`
// (chip_smoke.py, phase 11 (a), which prints each beside the kernel's
// time and its one-slot floor). Nine calls of at most 10,359 slots each
// pay the per-call floor (a one-slot call: about 0.0065 ms on an H100
// 80GB HBM3 at 700 W) more than their bytes.
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one destination slot, one float4 of channels a lane (a
// whole warp at D = 128; at least kSlotRows = 4 lanes). The slot's two
// offsets and, for deg <= 4, its deg source indices are loaded once, by
// two and by deg lanes, and shared by shuffle (slot_edges). Then every
// row's 16-byte load is issued before any arithmetic and kept in
// registers (4 x 16 B in flight a lane at the headline's degree of at
// most 4), each exp runs once per element, and the result is stored
// once as a float4. A slot of more than 4 edges takes the generic path,
// which walks its edge range twice (the max, then the exp sums) 4 rows
// at a time, each 4 loads issued together; D % 4 != 0 or a pointer off
// 16-byte alignment takes the scalar path (N = 1). Every path sums
// through the same functions in edge order, so all give the same bits.
// An 8-row register path keeps 8 rows in registers in every slot's
// thread; it was slower at the headline and no faster where a twentieth
// of the slots have 5-8 edges (PERF.md §6).
//
// Launched as a programmatic dependent launch (common.cuh), so that the
// launch and the off -> src chain of loads overlap the kernel before it.
// Before grid_dep_wait() the kernel reads only off and src (the graph's
// tables, copied to the card when the design was packed). After it, h
// (which the previous pair's net half writes) through L2, then every
// store.

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
  const bool row_ok = rl.row < segs;
  // ---- before the wait: off and src only ----
  int32_t begin, idx[kSlotRows];
  const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
  if (!row_ok) return;
  // ---- after the wait: h, then the stores ----
  grid_dep_wait();
  const int vecs = d / N;
  const int64_t o = rl.row * d;
  for (int c = rl.lane; c < vecs; c += group) {
    float x[kSlotRows][N], mx[N], den[N], num[N];
    slot_softmax<N, true>(h, src, begin, deg, idx, d, c * N, x, mx, den, num);
    float res[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      res[i] = partial ? num[i] : softmax_out(num[i], den[i]);
    store_vec<N>(out + o + c * N, res);
    if (partial) {
      store_vec<N>(mx_out + o + c * N, mx);
      store_vec<N>(den_out + o + c * N, den);
    }
  }
}

template <int N>
static cudaError_t launch(const float* h, const int32_t* src,
                          const int32_t* off, float* out, float* mx,
                          float* den, int64_t segs, int d, int partial,
                          cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  const unsigned grid = mailbox_grid(segs, group);
  return launch_programmatic(&segment_softmax_sum_kernel<N>, grid,
                             kMailboxThreads, 0, s, h, src, off, out, mx, den,
                             segs, d, partial, group);
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, out: (segs, d) float32; mx, den: (segs, d) float32
// with `partial`, else unused (may be null).
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
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4>(hp, sp, op, outp, mp, dp, segs, d, partial, s)
          : launch<1>(hp, sp, op, outp, mp, dp, segs, d, partial, s);
  return static_cast<int>(err);
}
