// segment_mean: the segment reduce's net half over a level's flat edge
// table, read straight from the node state h; in its update mode also
// the net half's update of h.
//
// Replaces, for each level pair of the pair step under
// reduce_mode='segment' (prtp_tpu/models/gnn.py::_PairStep.__call__,
// :199-204), the edge gather `msg_n = h[xs["net_src"]]`,
// prtp_tpu/ops/segment.py::segment_sum (:29-30), the division
// `sums / xs["net_cnt"][:, None]` and, in the update mode, the update
// `relu(fc_net_self(net_feat) + neigh_n)` with _masked_update. The
// (E, D) message table is never built. The edges are sorted by
// destination slot; slot s owns edges [off[s], off[s + 1]). For a slot s
// and a channel c:
//   mean[s, c] = (sum_e h[src[e], c]) / cnt[s]
// summed from 0.f in edge order; cnt is the graph's net_cnt (the
// in-degree, at least 1). Three modes, by launcher:
//   sums   (segment_mean_launch, cnt null): out[s] = the undivided sum.
//          A rank of the edge-sharded step
//          (prtp_tpu_torch/parallel/graph_shard.py) adds the ranks'
//          partial sums, then divides and updates in PyTorch.
//   mean   (segment_mean_launch): out[s] = mean[s]. An empty slot gives
//          0 in both.
//   update (net_update_launch, the unsharded walk): with pre the
//          fc_net_self MLP's (S, D) output and has_in the level's S
//          bools (null: every slot, as with dgl_parity off),
//            h[n0 + s, c] = has_in[s] ? relu(pre[s, c] + mean[s, c])
//                                     : relu(h[n0 + s, c])
//          (common.cuh, "the net half's update"). The float operations
//          are those of the walk's unfused PyTorch composition
//          (segment_mean, `+`, F.relu, F.relu of the old rows,
//          torch.where, the copy into h) in its order, and relu is
//          torch.relu's own (NaN kept, max(v, 0.f) else), so the rows
//          written are that composition's bits, NaN and the sign of
//          zero included. An empty slot gives relu(pre + 0.f).
//
// Writing h in place is safe: a net level's sources all lie below its
// own rows [n0, n0 + S) (graph.py's packer raises otherwise, and
// tests/test_torch_segment.py checks it), so no thread reads a row that
// another thread writes. A slot without in-edges reads its own old row
// before it writes that row, in the same thread.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table, the offsets and the counts, and the (S, D) output written; the
// update mode also reads pre (S, D) and has_in, and the old rows of the
// slots without in-edges; over 3.35 TB/s; one add an element and a few
// float operations a slot's element. chip_smoke.py (phase 11 (a))
// prints each mode's bound at the headline's shapes beside its time,
// its one-slot floor and, for the mean mode, F.embedding_bag's (mode
// "mean": the sum over the bag's size, 0 for an empty bag, the same
// function since cnt is the in-degree clamped at 1).
//
// Design: the layout of segment_softmax_sum (common.cuh): a lane group
// covers one destination slot, one float4 of channels a lane (a whole
// warp at D = 128; at least kSlotRows = 4 lanes). Lanes 0 and 1 load the
// slot's two offsets and lanes j < min(deg, 4) its source indices
// (slot_edges), lane 2 its count and lane 3 its has_in, all shared by
// shuffle. A slot of at most 4 edges (the register path; every headline
// net slot has one) issues all its row loads before any add; a wider
// one (the generic path) walks its edges 4 rows at a time, each chunk's
// loads issued together. Every path adds in edge order from 0.f and
// then divides, so all give the same bits as the kernel's earlier
// design (one row at a time) and as chip_smoke.py's edge_order_sums.
// D % 4 != 0 or a pointer off 16-byte alignment takes the scalar path
// (N = 1).
//
// Launched as a programmatic dependent launch (common.cuh), so that the
// launch and the off -> src chain of loads overlap the kernel before it.
// Before grid_dep_wait() the kernel reads only the graph's own tables,
// off, src, cnt and has_in (copied to the card when the design was
// packed). After it, h (which the pair's cell half writes) and pre
// (which the kernel before it writes) through L2, then every store.

#include "common.cuh"

// The sum from 0.f, in edge order, of the slot's rows at channel offset
// col (its first rows loaded from idx, slot_edges): the register path
// for deg <= kSlotRows, else the generic path through the same x.
template <int N>
__device__ __forceinline__ void slot_sum(const float* h,
                                         const int32_t* __restrict__ src,
                                         int32_t begin, int deg,
                                         const int32_t (&idx)[kSlotRows],
                                         int d, int col,
                                         float (&x)[kSlotRows][N],
                                         float (&acc)[N]) {
  load_head<N, true>(h, idx, deg, d, col, x);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kSlotRows; ++j)
    if (j < deg) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += x[j][i];
    }
  const int32_t end = begin + deg;
#pragma unroll 1
  for (int32_t j = begin + kSlotRows; j < end; j += kSlotRows) {
    const int n = min(kSlotRows, end - j);
    load_rows<N, true>(h, src, j, n, d, col, x);
#pragma unroll
    for (int r = 0; r < kSlotRows; ++r)
      if (r < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += x[r][i];
      }
  }
}

// h and out are not __restrict__: in the update mode out is h's block of
// the level's rows (the kernel reads other rows of h, and each slot's
// own old row, through them).
template <int N, bool UPDATE>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_mean_kernel(const float* h, const int32_t* __restrict__ src,
                        const int32_t* __restrict__ off,
                        const float* __restrict__ cnt,
                        const float* __restrict__ pre,
                        const uint8_t* __restrict__ has_in, float* out,
                        int64_t segs, int d, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < segs;
  // ---- before the wait: the graph's tables only ----
  // lanes 2 and 3 load the slot's count and has_in first, so that both
  // are in flight beside the offsets (slot_edges, lanes 0 and 1)
  float c = 1.f;
  int in = 1;
  if (row_ok && rl.lane == 2 && cnt != nullptr) c = __ldg(cnt + rl.row);
  if (UPDATE && row_ok && rl.lane == 3 && has_in != nullptr)
    in = __ldg(has_in + rl.row);
  int32_t begin, idx[kSlotRows];
  const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
  const float n = __shfl_sync(0xffffffffu, c, 2, group);
  const bool take = __shfl_sync(0xffffffffu, in, 3, group) != 0;
  if (!row_ok) return;
  // ---- after the wait: h and pre, then the stores ----
  grid_dep_wait();
  const int vecs = d / N;
  const int64_t o = rl.row * d;
  for (int col = rl.lane * N; col < vecs * N; col += group * N) {
    float acc[N];
    if (UPDATE && !take) {  // the old row, read by the thread writing it
      load_vec_cg<N>(out + o + col, acc);
      keep_row<N>(acc);
    } else {
      float p[N], x[kSlotRows][N];
      if (UPDATE) load_vec_cg<N>(pre + o + col, p);
      slot_sum<N>(h, src, begin, deg, idx, d, col, x, acc);
      if (cnt != nullptr) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] /= n;
      }
      if (UPDATE) update_row<N>(p, acc);
    }
    store_vec<N>(out + o + col, acc);
  }
}

template <int N, bool UPDATE>
static cudaError_t launch(const float* h, const int32_t* src,
                          const int32_t* off, const float* cnt,
                          const float* pre, const uint8_t* has_in,
                          float* out, int64_t segs, int d, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  return launch_programmatic(&segment_mean_kernel<N, UPDATE>,
                             mailbox_grid(segs, group), kMailboxThreads, 0, s,
                             h, src, off, cnt, pre, has_in, out, segs, d,
                             group);
}

template <bool UPDATE>
static int dispatch(const void* h, const void* src, const void* off,
                    const void* cnt, const void* pre, const void* has_in,
                    void* out, int64_t segs, int d, void* stream) {
  if (segs == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  const float* cp = static_cast<const float*>(cnt);
  const float* pp = static_cast<const float*>(pre);
  const uint8_t* ip = static_cast<const uint8_t*>(has_in);
  float* outp = static_cast<float*>(out);
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(pre);
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4, UPDATE>(hp, sp, op, cp, pp, ip, outp, segs, d, s)
          : launch<1, UPDATE>(hp, sp, op, cp, pp, ip, outp, segs, d, s);
  return static_cast<int>(err);
}

// The sums and mean modes. h: (> max(src), d) float32, src: (off[segs],)
// int32, off: (segs + 1,) int32 ascending, cnt: (segs,) float32 or null
// (the sums), out: (segs, d) float32.
PRTP_EXPORT int segment_mean_launch(const void* h, const void* src,
                                    const void* off, const void* cnt,
                                    void* out, int64_t segs, int d,
                                    void* stream) {
  return dispatch<false>(h, src, off, cnt, nullptr, nullptr, out, segs, d,
                         stream);
}

// The update mode: h (> max(n0 + segs, max(src)), d) float32, written in
// rows [n0, n0 + segs); src, off and cnt (not null) as above; pre:
// (segs, d) float32; has_in: (segs,) bool or null.
PRTP_EXPORT int net_update_launch(void* h, const void* src, const void* off,
                                  const void* cnt, const void* pre,
                                  const void* has_in, int64_t n0,
                                  int64_t segs, int d, void* stream) {
  float* rows = static_cast<float*>(h) + n0 * d;
  return dispatch<true>(h, src, off, cnt, pre, has_in, rows, segs, d,
                        stream);
}
