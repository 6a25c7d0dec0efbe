// segment_attn_bwd: the cotangents of the --attn cell half under the
// segment reduce (segment_attn_sum.cu), read straight from the final node
// state hf.
//
// Replaces, for each level pair k > 0, the backward that XLA's autodiff
// takes through the scores `fc_attn2(msg)` and
// prtp_tpu/ops/segment.py::segment_weighted_softmax_sum (:86-127) under
// reduce_mode='segment' with flag_attn (prtp_tpu/models/gnn.py:178-182):
// the transposed segment sums, the softmax's and the division's
// cotangents gathered back to the edges, and the Dense's weight
// gradient. For an edge e of destination slot s, a head g and a channel
// c, with x_e = hf[src[e]], g(c) the head of channel c, the slot's
// per-head shift mx and denominator den and its output out
// (segment_attn_sum), and the output's cotangent g_out:
//   alpha_eg = exp(s_eg - mx[s, g]) / max(den[s, g], 1e-12)
//   da_eg    = sum_{c of head g} g_out[s, c] x_e[c]
//   t_g      = sum_{c of head g} g_out[s, c] out[s, c]
//   ds_eg    = alpha_eg (da_eg - t_g)
//            (= alpha_eg <g_out[s, head g], x_e[head g] - out[s, head g]>,
//             summed as XLA's autodiff of the division sums it)
//   d_msg[e, c] = alpha_e,g(c) g_out[s, c] + sum_g ds_eg w[g, c]
//   d_w[g, c]   = sum over the edges of ds_eg x_e[c]
// (the max's own cotangent, which cancels exactly, is left out). Reading
// hf is exact: every source row of a level is final once that level has
// been written. Two modes, as segment_softmax_sum_bwd's:
// - recomputing (out, mx, den null; the unsharded walk): the kernel
//   recomputes the slot's mx, den and out from the rows it reads, with
//   the forward's functions (common.cuh, "the segment reduce's
//   attention"), so they are the forward's bits;
// - stats-reading (the edge-sharded step): a rank holds only a block of
//   a slot's edges, so it cannot recompute the slot; it passes its block
//   with the slots' combined out (S, D), mx and den (S, nh), which the
//   kernel reads.
//
// d_w sums every edge of every pair of a backward: it is summed in a
// fixed order, without float atomics, so that a backward gives the same
// bits every time. One sum a backward (ops/segment_kernels.py::
// AttnGradSum), two kernels, both programmatic dependent launches:
//   1. segment_attn_bwd_rows, once a pair: d_msg, and its blocks' sums of
//      d_w. The grid is the workspace's rows, or the call's tiles if
//      fewer; the rows are the blocks the card holds at once, the lesser
//      of the two modes' kernels (segment_attn_bwd_grid_launch), so that
//      both sum in the same order. Block b loops over the tiles b, b +
//      grid, ... of kMailboxThreads / group slots and adds its sums to
//      row b of one workspace (rows, nh, D), which the first call to
//      reach the row writes instead;
//   2. segment_dw_reduce, once a backward after the last pair: d_w[g, c]
//      = the rows added in row order (common.cuh's dw_reduce, which
//      attn_bwd.cu's reduce shares).
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table, the offsets, w and the (S, D) cotangent g_out read
// (stats-reading: also out, mx and den), the (E, D) cotangent written,
// and d_w written once a backward, over 3.35 TB/s. At the headline design
// (pairs 1-9) that is about 81 MB, 0.024 ms a backward, as
// segment_softmax_sum_bwd's; the workspace stays in L2 (at most 0.54 MB
// a head). The products are about 2 D (3 nh + 1) flop an edge (scores,
// da, the score path, d_w), far below the f32 rate (chip_smoke.py, phase
// 12 (a), prints each beside the kernel's time and its one-slot floor).
//
// Design: segment_attn_sum's two paths (common.cuh). Heads together: a
// lane group of D / 4 lanes covers a slot, one float4 a lane, w's (nh, D)
// copy in shared memory (started by cp.async at the block's start and
// waited for once the first tile's tables are loaded); a slot of up to 4
// edges keeps its rows and scores in registers from the recompute (or,
// stats-reading, from one load before the wait), a wider one walks its
// edges 4 rows at a time (the recompute walked it once already, with a
// running max). For each chunk and edge: each lane's own head's alpha, da
// (a butterfly over the head's lanes) and ds; then for each head g in
// turn each lane takes ds_eg from the head's first lane and adds ds_eg
// w[g] into the edge's score path and ds_eg x_e into its own float4 of
// d_w[g], kept in registers over its group's slots (NH x 4 floats); the
// value path alpha g_out is added and the edge's float4 stored at once.
// At the block's end the lane groups' sums go through shared memory into
// the block's row, in group order, after the row's earlier sums (fetched
// by cp.async right after the wait): one barrier. The per-head loop (the
// other shapes, and N = 1 for D % 4 != 0 or a pointer off 16-byte
// alignment): per head, walks over the slot's edges, the score path
// summed in d_msg itself (each lane its own channels) and the slot's
// share in shared memory, added a tile and a head at a time to the
// block's sums (shared memory), added to its row at the end.
//
// segment_attn_bwd_rows is a programmatic dependent launch (common.cuh):
// with the heads together, before grid_dep_wait() it reads off, src, w,
// the slots' rows of hf and, stats-reading, the saved out, mx and den
// (the graph's tables, a weight, and tensors written before the kernel
// just before it: hf by the forward, the statistics by its combine), and
// recomputes the slot's softmax there; after it g_out (d_f, which the
// fc_cell_neigh gradients just before this kernel write) and the
// workspace row (which the previous pair's call wrote), then every
// store. The per-head loop waits first. segment_dw_reduce reads nothing
// before its wait.

#include "common.cuh"

// Blocks an SM that the heads-together kernel must fit, both modes: as
// many as the recomputing one holds unbounded at 1 and 4 heads (72 and 92
// registers a thread), where ptxas then spilled 16 B of the
// stats-reading one at 4 heads; bounded, neither spills.
template <int NH>
constexpr int kHeadsMinBlocks = NH == 1 ? 7 : NH == 2 ? 6 : NH == 4 ? 5 : 1;

// Heads together: NH heads, one float4 a lane, group == d / 4. STATS:
// the stats-reading mode; else the recomputing one. work: (>= gridDim.x,
// NH, d): this block's d_w sums are added to its row, or written there
// if the row is past `filled` (the rows the sum's earlier calls wrote).
template <int NH, bool STATS>
__global__ void __launch_bounds__(kMailboxThreads, kHeadsMinBlocks<NH>)
    segment_attn_bwd_heads_kernel(
        const float* __restrict__ h, const int32_t* __restrict__ src,
        const int32_t* __restrict__ off, const float* __restrict__ w,
        const float* __restrict__ out, const float* __restrict__ mx_in,
        const float* __restrict__ den_in, const float* g_out,
        float* __restrict__ d_msg, float* work, int64_t segs, int d, int nh,
        int group, int64_t tiles, int filled) {
  // w's copy (NH, d); each lane group's d_w sums (groups, NH, d); the
  // block's row of work as the sum's earlier calls left it (NH, d)
  extern __shared__ __align__(16) float smem[];
  const int n = NH * d;
  const int groups = kMailboxThreads / group;
  const int c = threadIdx.x & (group - 1);  // this lane's float4
  const int lanes = group / NH;             // a head's lanes
  const int hg = c / lanes;                 // this lane's head
  const bool fresh = static_cast<int>(blockIdx.x) >= filled;
  float* row = work + static_cast<int64_t>(blockIdx.x) * n;
  float* prev = smem + (groups + 1) * n;
  // w into shared memory, waited for in the first tile once its slots'
  // edges are known
  copy_async(w, smem, n);
  const SharedWeights wt{smem + c * 4, d};
  // this lane's float4 of each head's d_w over its group's slots, in
  // tile order, each slot's edges in order
  float dw[NH][4];
#pragma unroll
  for (int gg = 0; gg < NH; ++gg)
#pragma unroll
    for (int k = 0; k < 4; ++k) dw[gg][k] = 0.f;
  // no lane leaves the loops early: every lane of the warp takes part in
  // the shuffles
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const RowLanes rl = row_lanes(group, tile);
    const bool row_ok = rl.row < segs;
    // ---- before the wait: the tables, hf, w and the statistics ----
    int32_t begin, idx[kSlotRows];
    const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
    const int wdeg = __reduce_max_sync(0xffffffffu, deg);
    if (tile == blockIdx.x) {
      copy_async_wait();
      __syncthreads();
    }
    float x[kSlotRows][4], s[kSlotRows], mx, den, f[4];
    if (STATS) {
      mx = row_ok ? __ldg(mx_in + rl.row * NH + hg) : 0.f;
      den = row_ok ? __ldg(den_in + rl.row * NH + hg) : 0.f;
      if (row_ok) {
        load_vec<4>(out + rl.row * d + c * 4, f);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) f[k] = 0.f;
      }
      if (wdeg <= kSlotRows)
        attn_chunk<NH, false>(h, src, idx, begin, deg, wdeg, 0, d, c * 4, wt,
                              c, group, x, s);
    } else {
      float num[4];
      slot_attn<NH, false>(h, src, idx, begin, deg, wdeg, d, c * 4, wt, c,
                           group, x, s, mx, den, num);
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = softmax_out(num[k], den);
    }
    const float dd = fmaxf(den, 1e-12f);
    // ---- after the wait: g_out and the row of work, then the stores ----
    grid_dep_wait();
    if (!fresh && tile == blockIdx.x) copy_async(row, prev, n);
    float gs[4];
    if (row_ok) {
      load_vec_cg<4>(g_out + rl.row * d + c * 4, gs);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) gs[k] = 0.f;
    }
    float tp = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) tp += gs[k] * f[k];
    const float t = group_sum(tp, lanes);
#pragma unroll 1
    for (int j0 = 0; j0 == 0 || j0 < wdeg; j0 += kSlotRows) {
      if (wdeg > kSlotRows)  // chunk 0 too from src: idx is not kept
        attn_chunk<NH, false, true>(h, src, idx, begin, deg, wdeg, j0, d,
                                    c * 4, wt, c, group, x, s);
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
        if (j0 + i >= wdeg) continue;  // the same in every lane of the warp
        const bool valid = j0 + i < deg;
        float p = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) p += gs[k] * x[i][k];
        const float da = group_sum(p, lanes);
        const float a = valid ? expf(s[i] - mx) / dd : 0.f;
        const float ds = valid ? a * (da - t) : 0.f;
        // every head's ds: the score path and d_w; then the value path
        // and the edge's store
        float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int gg = 0; gg < NH; ++gg) {
          const float dsg = __shfl_sync(0xffffffffu, ds, gg * lanes, group);
          float v[4];
          wt.get(gg, v);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            o[k] += dsg * v[k];
            dw[gg][k] += dsg * x[i][k];
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) o[k] = a * gs[k] + o[k];
        if (valid)
          store_vec<4>(d_msg + static_cast<int64_t>(begin + j0 + i) * d +
                           c * 4,
                       o);
      }
    }
  }
  // the lane groups' sums into the block's row, in group order, after
  // the row's earlier sums (the previous call's rows kernel wrote them)
  float* gsum = smem + n;
#pragma unroll
  for (int gg = 0; gg < NH; ++gg)
    store_vec<4>(gsum + (threadIdx.x / group) * n + gg * d + c * 4, dw[gg]);
  copy_async_wait();
  __syncthreads();
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float sum = fresh ? 0.f : prev[e];
    for (int r = 0; r < groups; ++r) sum += gsum[r * n + e];
    row[e] = sum;
  }
}

// The per-head loop: any nh dividing d, N floats a vector. share: (tile
// slots, d), a head's shares at a time, then the block's sums (nh, d)
// over its tiles in order, added to its row of work at the end as the
// heads kernel adds them.
template <int N, bool STATS>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_attn_bwd_loop_kernel(
        const float* __restrict__ h, const int32_t* __restrict__ src,
        const int32_t* __restrict__ off, const float* __restrict__ w,
        const float* __restrict__ out, const float* __restrict__ mx_in,
        const float* __restrict__ den_in, const float* g_out,
        float* __restrict__ d_msg, float* work, int64_t segs, int d, int nh,
        int group, int64_t tiles, int filled) {
  extern __shared__ __align__(16) float share[];
  const int tile_rows = kMailboxThreads / group;
  float* srow = share + (threadIdx.x / group) * d;  // this group's slot
  float* part = share + tile_rows * d;
  const int dh = d / nh;
  grid_dep_wait();
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const RowLanes rl = row_lanes(group, tile);
    const bool row_ok = rl.row < segs;
    int32_t begin, idx[kSlotRows];
    const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
    const int wdeg = __reduce_max_sync(0xffffffffu, deg);
    const float* grow = g_out + (row_ok ? rl.row : 0) * d;
    for (int hg = 0; hg < nh; ++hg) {
      float mx, den;
      if (STATS) {
        mx = row_ok ? __ldg(mx_in + rl.row * nh + hg) : 0.f;
        den = row_ok ? __ldg(den_in + rl.row * nh + hg) : 0.f;
      } else {
        loop_stats<N, false>(h, src, w, begin, deg, wdeg, hg, d, rl.lane,
                             group, mx, den);
      }
      const float dd = fmaxf(den, 1e-12f);
      int v0, v1;
      head_vectors(hg, dh, N, v0, v1);
      // t: <g_out, out> over head hg's channels
      float tp = 0.f;
      for (int c0 = v0; c0 < v1; c0 += group) {
        const int c = c0 + rl.lane;
        const bool mine = row_ok && c < v1;
        float f[N];
        if (STATS) {
#pragma unroll
          for (int k = 0; k < N; ++k)
            f[k] = mine ? __ldg(out + rl.row * d + c * N + k) : 0.f;
        } else {
          float num[N];
          loop_numer<N, false>(h, src, w, begin, deg, wdeg, hg, mx, d, c,
                               c < v1, rl.lane, group, num);
#pragma unroll
          for (int k = 0; k < N; ++k) f[k] = softmax_out(num[k], den);
        }
        if (mine) {
#pragma unroll
          for (int k = 0; k < N; ++k)
            if ((c * N + k) / dh == hg) tp += __ldcg(grow + c * N + k) * f[k];
        }
      }
      const float t = group_sum(tp, group);
      for (int ch = rl.lane; ch < d; ch += group) srow[ch] = 0.f;
      const float* wrow = w + static_cast<int64_t>(hg) * d;
#pragma unroll 1
      for (int j = 0; j < wdeg; ++j) {
        const bool valid = j < deg;
        const int32_t r = valid ? __ldg(src + begin + j) : 0;
        const float* xrow = h + static_cast<int64_t>(r) * d;
        const float sc = loop_score<N, false>(h, w, r, valid, hg, d, rl.lane,
                                              group);
        float dap = 0.f;
        if (valid) {
          for (int ch = v0 * N + rl.lane; ch < v1 * N; ch += group)
            if (ch / dh == hg) dap += __ldcg(grow + ch) * __ldg(xrow + ch);
        }
        const float da = group_sum(dap, group);
        if (!valid) continue;
        const float a = expf(sc - mx) / dd;
        const float ds = a * (da - t);
        // the score path, summed over the heads in d_msg itself, the
        // value path on head hg's channels, and the slot's share of
        // d_w[hg], over the edges in order
        float* orow = d_msg + static_cast<int64_t>(begin + j) * d;
        for (int ch = rl.lane; ch < d; ch += group) {
          float o = (hg == 0 ? 0.f : orow[ch]) + ds * wrow[ch];
          if (ch / dh == hg) o += a * __ldcg(grow + ch);
          orow[ch] = o;
          srow[ch] += ds * __ldg(xrow + ch);
        }
      }
      __syncthreads();
      add_share(part + hg * d, share, d, tile_rows, first);
      __syncthreads();
    }
  }
  // every block has a tile (the grid is at most the tiles)
  float* row = work + static_cast<int64_t>(blockIdx.x) * nh * d;
  const bool fresh = static_cast<int>(blockIdx.x) >= filled;
  for (int e = threadIdx.x; e < nh * d; e += blockDim.x)
    row[e] = (fresh ? 0.f : __ldcg(row + e)) + part[e];
}

// d_w from the blocks' rows of the workspace (common.cuh's dw_reduce).
__global__ void segment_dw_reduce_kernel(const float* work,
                                         float* __restrict__ d_w, int blocks,
                                         int elems) {
  dw_reduce(work, d_w, blocks, elems);
}

// every rows kernel has the same parameters
using SegmentAttnBwdKernel = decltype(&segment_attn_bwd_loop_kernel<1, false>);

template <bool STATS>
static SegmentAttnBwdKernel heads_kernel(int nh) {
  switch (nh) {
    case 1: return &segment_attn_bwd_heads_kernel<1, STATS>;
    case 2: return &segment_attn_bwd_heads_kernel<2, STATS>;
    case 4: return &segment_attn_bwd_heads_kernel<4, STATS>;
    case 8: return &segment_attn_bwd_heads_kernel<8, STATS>;
    case 16: return &segment_attn_bwd_heads_kernel<16, STATS>;
    default: return &segment_attn_bwd_heads_kernel<32, STATS>;
  }
}

// A width's rows kernels: the two modes' (recomputing, stats-reading),
// their shared memory and lane group.
struct RowsPlan {
  SegmentAttnBwdKernel modes[2];
  size_t smem;
  int group;
};

template <int N>
static cudaError_t plan_rows(int d, int nh, RowsPlan* plan) {
  const int vecs = d / N;
  plan->group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  const int tile_rows = kMailboxThreads / plan->group;
  const bool together = N == 4 && attn_heads_together(vecs, nh);
  plan->modes[0] = together ? heads_kernel<false>(nh)
                            : &segment_attn_bwd_loop_kernel<N, false>;
  plan->modes[1] = together ? heads_kernel<true>(nh)
                            : &segment_attn_bwd_loop_kernel<N, true>;
  // heads together: w's copy, the lane groups' sums and the row's
  // earlier sums; the per-head loop: the tile's shares and the block's
  // sums
  plan->smem = sizeof(float) * d *
               (together ? (tile_rows + 2) * nh : tile_rows + nh);
  if (plan->smem > kMaxShare) return cudaErrorInvalidValue;
  if (plan->smem > 48 * 1024) {
    for (const SegmentAttnBwdKernel k : plan->modes) {
      const cudaError_t err = cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(plan->smem));
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// Launches the rows kernel on min(tiles, blocks) blocks, each with at
// least one tile; *grid gets the number launched.
template <int N>
static cudaError_t launch_rows(const float* h, const int32_t* src,
                               const int32_t* off, const float* w,
                               const float* out, const float* mx,
                               const float* den, const float* g, float* d_msg,
                               float* work, int64_t segs, int d, int nh,
                               int blocks, int filled, int* grid,
                               cudaStream_t s) {
  RowsPlan plan;
  const cudaError_t err = plan_rows<N>(d, nh, &plan);
  if (err != cudaSuccess) return err;
  const int64_t tiles = mailbox_grid(segs, plan.group);
  *grid = static_cast<int>(tiles < blocks ? tiles : blocks);
  return launch_programmatic(plan.modes[out != nullptr], *grid,
                             kMailboxThreads, plan.smem, s, h, src, off, w,
                             out, mx, den, g, d_msg, work, segs, d, nh,
                             plan.group, tiles, filled);
}

// The rows of a d_w sum's workspace for width d and nh heads: the blocks
// of both modes' rows kernels (16-byte aligned pointers) that the card
// holds at once, the lesser of the two, so that each call is one wave
// and both modes sum d_w in the same order. Not a launch.
PRTP_EXPORT int segment_attn_bwd_grid_launch(int d, int nh, int* blocks) {
  *blocks = 0;
  if (d < 1 || nh < 1 || d % nh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  RowsPlan plan;
  cudaError_t err = d % 4 == 0 ? plan_rows<4>(d, nh, &plan)
                               : plan_rows<1>(d, nh, &plan);
  int device = 0, sms = 0, on_a = 0, on_b = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &on_a, plan.modes[0], kMailboxThreads, plan.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &on_b, plan.modes[1], kMailboxThreads, plan.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = (on_a < on_b ? on_a : on_b) * sms;
  return static_cast<int>(*blocks < 1 ? cudaErrorInvalidConfiguration
                                      : cudaSuccess);
}

// One call of a d_w sum. h: (> max(src), d) float32, src: (off[segs],)
// int32, off: (segs + 1,) int32 ascending, w: (nh, d) float32 with nh
// dividing d, g: (segs, d) float32, d_msg: (off[segs], d) float32; out:
// (segs, d), mx, den: (segs, nh) float32 all three (stats-reading), or
// all null (recomputing); work: blocks * nh * d floats (blocks >= 1:
// segment_attn_bwd_grid_launch's rows), whose rows below `filled` hold
// the sum's earlier calls' sums. Adds this call's to rows [0, *grid)
// (writing those at or past `filled`).
PRTP_EXPORT int segment_attn_bwd_launch(const void* h, const void* src,
                                        const void* off, const void* w,
                                        const void* out, const void* mx,
                                        const void* den, const void* g,
                                        void* d_msg, void* work, int64_t segs,
                                        int d, int nh, int blocks, int filled,
                                        int* grid, void* stream) {
  *grid = 0;
  if (segs == 0 || d == 0) return 0;
  if (nh < 1 || d % nh != 0 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  const float* wp = static_cast<const float*>(w);
  const float* fp = static_cast<const float*>(out);
  const float* mp = static_cast<const float*>(mx);
  const float* dp = static_cast<const float*>(den);
  const float* gp = static_cast<const float*>(g);
  float* rp = static_cast<float*>(d_msg);
  float* wk = static_cast<float*>(work);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(d_msg);
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch_rows<4>(hp, sp, op, wp, fp, mp, dp, gp, rp, wk, segs, d,
                           nh, blocks, filled, grid, s)
          : launch_rows<1>(hp, sp, op, wp, fp, mp, dp, gp, rp, wk, segs, d,
                           nh, blocks, filled, grid, s);
  return static_cast<int>(err);
}

// The end of a d_w sum: d_w[e] = the rows [0, blocks) of work ((blocks,
// elems) floats) added in row order; blocks >= 1.
PRTP_EXPORT int segment_dw_reduce_launch(const void* work, void* d_w,
                                         int blocks, int elems,
                                         void* stream) {
  if (elems == 0) return 0;
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_programmatic(
      segment_dw_reduce_kernel, (elems + 31) / 32, dim3(32, kReduceLanes), 0,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(work),
      static_cast<float*>(d_w), blocks, elems));
}
