// segment_attn_sum: the --attn cell half under the segment reduce, over a
// level's flat edge table, read straight from the node state h.
//
// Replaces, for each level pair k > 0 of the pair step under
// reduce_mode='segment' with flag_attn (prtp_tpu/models/gnn.py::
// _PairStep.__call__, :178-182), the edge gather `msg = h[xs["cell_src"]]`,
// the scores `fc_attn2(msg)` and
// prtp_tpu/ops/segment.py::segment_weighted_softmax_sum (:86-127). The
// (E, D) message table and the (E, nh) scores are never built. w is
// fc_attn2's weight in torch's layout, (nh, D): JAX's kernel transposed.
// The edges are sorted by destination slot; slot s owns edges [off[s],
// off[s + 1]). For a slot s and a head g, over its edges e, with x_e =
// h[src[e]] (common.cuh, "the segment reduce's attention"):
//   s_eg  = sum_c x_e[c] w[g, c]      (the WHOLE row, as flax's Dense(nh))
//   mx    = max_e s_eg   (NaN if any is NaN, as XLA's segment_max; 0 when
//                         not finite: JAX's isfinite guard, so an empty
//                         slot's shift is 0)
//   den   = sum_e exp(s_eg - mx)
//   numer[c] = sum_e exp(s_eg - mx) x_e[c]   for head g's channels c
//   out[s, c] = numer[c] / max(den, 1e-12)   (GAT concat)
// An empty slot gives 0, never NaN. With `partial` (a rank of the
// edge-sharded step, prtp_tpu_torch/parallel/graph_shard.py, which holds
// only a block of the edges) the kernel writes the numerator undivided
// and each head's mx and den, (S, nh), which the combine over ranks
// rescales to the common max and adds before the division. Without it
// only out is written, as JAX's op returns only out: the backward
// (segment_attn_bwd) recomputes the shift and denominator from the rows
// it reads.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table, the offsets and w, and the (S, D) output written (with
// `partial` also the (S, nh) mx and den), over 3.35 TB/s. The scores add
// 2 D nh flop an edge (18 MFLOP at the headline's nh = 1 over pairs 1-9,
// 72 at nh = 4), far below the f32 rate. At the headline design (pairs
// 1-9: 70,789 edges into 28,254 slots) that is about 44.5 MB, 0.0133 ms a
// forward, as segment_softmax_sum's (chip_smoke.py, phase 12 (a), prints
// each beside the kernel's time and its one-slot floor). Nine calls of
// at most 10,359 slots each pay the per-call floor more than their bytes.
//
// Design: segment_softmax_sum's layout (common.cuh): a lane group covers
// one destination slot, one float4 of channels a lane (a whole warp at
// D = 128); the slot's two offsets and, for deg <= 4, its deg source
// indices are loaded once and shared by shuffle (slot_edges). With the
// heads together (attn_heads_together: nh a power of two, D / nh a
// multiple of 4, D / 4 from 4 to 32 float4s) each lane dots its float4
// with every head's slice of w and head_scores() (attn_sum's) reduces the
// nh scores in one pass; every row load of a slot of up to 4 edges is
// issued before any arithmetic and kept in registers with its score, so
// each row is read once; a slot of more than 4 edges takes the generic
// path, 4 rows at a time, once: its shift is a running max, and the sums
// are rescaled where a chunk raises it (slot_attn). The other
// shapes take the per-head loop: for each head, walks over the slot's
// edges, a full-group sum a score, the lane's vectors re-read from L1;
// D % 4 != 0 or a pointer off 16-byte alignment takes it with scalar
// loads (N = 1). Every loop over edges runs to the warp's largest degree
// (its slots' scores are summed by shuffles in which all 32 lanes take
// part), masked by each slot's own.
//
// Launched as a programmatic dependent launch (common.cuh), so that the
// launch, the off -> src chain of loads and w's load overlap the kernel
// before it. Before grid_dep_wait() the kernel reads only off, src (the
// graph's tables) and w (a weight no kernel of the walk writes). After
// it, h (which the previous pair's net half writes) through L2, then
// every store.

#include "common.cuh"

// Blocks an SM that the heads-together kernel must fit at 1, 2 and 4
// heads: as many as it held when slot_attn took two passes over a slot
// (55, 64 and 72 registers a thread). The running max needs more
// registers unbounded (58, 76 and 80: a block an SM fewer, about 2%
// slower at the headline); bounded, ptxas fits 56, 64 and 72 with no
// spill.
template <int NH>
constexpr int kHeadsMinBlocks = NH == 1 ? 9 : NH == 2 ? 8 : NH == 4 ? 7 : 1;

// Heads together: NH heads, one float4 a lane, group == d / 4.
template <int NH>
__global__ void __launch_bounds__(kMailboxThreads, kHeadsMinBlocks<NH>)
    segment_attn_heads_kernel(const float* h, const int32_t* __restrict__ src,
                              const int32_t* __restrict__ off,
                              const float* __restrict__ w,
                              float* __restrict__ out,
                              float* __restrict__ mx_out,
                              float* __restrict__ den_out, int64_t segs,
                              int d, int nh, int partial, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < segs;
  // ---- before the wait: off, src and w only ----
  int32_t begin, idx[kSlotRows];
  const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
  const int wdeg = __reduce_max_sync(0xffffffffu, deg);
  const int c = rl.lane;          // this lane's float4 of channels
  const int lanes = group / NH;   // a head's lanes
  const RegWeights<NH> wt(w, d, c * 4);
  // ---- after the wait: h, then the stores ----
  grid_dep_wait();
  float x[kSlotRows][4], s[kSlotRows], mx, den, num[4];
  slot_attn<NH, true>(h, src, idx, begin, deg, wdeg, d, c * 4, wt, c, group,
                      x, s, mx, den, num);
  if (!row_ok) return;
  float res[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    res[k] = partial ? num[k] : softmax_out(num[k], den);
  store_vec<4>(out + rl.row * d + c * 4, res);
  if (partial && c % lanes == 0) {
    mx_out[rl.row * NH + c / lanes] = mx;
    den_out[rl.row * NH + c / lanes] = den;
  }
}

// The per-head loop: any nh dividing d, N floats a vector.
template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_attn_loop_kernel(const float* h, const int32_t* __restrict__ src,
                             const int32_t* __restrict__ off,
                             const float* __restrict__ w,
                             float* __restrict__ out,
                             float* __restrict__ mx_out,
                             float* __restrict__ den_out, int64_t segs, int d,
                             int nh, int partial, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < segs;
  // ---- before the wait: off and src only ----
  int32_t begin, idx[kSlotRows];
  const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
  const int wdeg = __reduce_max_sync(0xffffffffu, deg);
  // ---- after the wait: h, then the stores ----
  grid_dep_wait();
  const int dh = d / nh;
  for (int g = 0; g < nh; ++g) {
    float mx, den;
    loop_stats<N, true>(h, src, w, begin, deg, wdeg, g, d, rl.lane, group,
                        mx, den);
    int v0, v1;
    head_vectors(g, dh, N, v0, v1);
    for (int c0 = v0; c0 < v1; c0 += group) {
      const int c = c0 + rl.lane;
      float num[N];
      loop_numer<N, true>(h, src, w, begin, deg, wdeg, g, mx, d, c, c < v1,
                          rl.lane, group, num);
      if (row_ok && c < v1) {
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const int ch = c * N + k;
          if (ch / dh == g)
            out[rl.row * d + ch] =
                partial ? num[k] : softmax_out(num[k], den);
        }
      }
    }
    if (partial && row_ok && rl.lane == 0) {
      mx_out[rl.row * nh + g] = mx;
      den_out[rl.row * nh + g] = den;
    }
  }
}

// every kernel has the same parameters
using SegmentAttnKernel = decltype(&segment_attn_loop_kernel<1>);

static SegmentAttnKernel heads_kernel(int nh) {
  switch (nh) {
    case 1: return &segment_attn_heads_kernel<1>;
    case 2: return &segment_attn_heads_kernel<2>;
    case 4: return &segment_attn_heads_kernel<4>;
    case 8: return &segment_attn_heads_kernel<8>;
    case 16: return &segment_attn_heads_kernel<16>;
    default: return &segment_attn_heads_kernel<32>;
  }
}

template <int N>
static cudaError_t launch(const float* h, const int32_t* src,
                          const int32_t* off, const float* w, float* out,
                          float* mx, float* den, int64_t segs, int d, int nh,
                          int partial, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  const unsigned grid = mailbox_grid(segs, group);
  const SegmentAttnKernel kernel =
      N == 4 && attn_heads_together(vecs, nh) ? heads_kernel(nh)
                                              : &segment_attn_loop_kernel<N>;
  return launch_programmatic(kernel, grid, kMailboxThreads, 0, s, h, src, off,
                             w, out, mx, den, segs, d, nh, partial, group);
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, w: (nh, d) float32 with nh dividing d, out: (segs, d)
// float32; mx, den: (segs, nh) float32 with `partial`, else unused (may
// be null).
PRTP_EXPORT int segment_attn_sum_launch(const void* h, const void* src,
                                        const void* off, const void* w,
                                        void* out, void* mx, void* den,
                                        int64_t segs, int d, int nh,
                                        int partial, void* stream) {
  if (segs == 0 || d == 0) return 0;
  if (nh < 1 || d % nh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  const float* wp = static_cast<const float*>(w);
  float* outp = static_cast<float*>(out);
  float* mp = static_cast<float*>(mx);
  float* dp = static_cast<float*>(den);
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4>(hp, sp, op, wp, outp, mp, dp, segs, d, nh, partial, s)
          : launch<1>(hp, sp, op, wp, outp, mp, dp, segs, d, nh, partial, s);
  return static_cast<int>(err);
}
