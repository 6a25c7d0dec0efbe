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
// d_w sums every edge of the pair: it is summed in a fixed order, without
// float atomics, so that a call gives the same bits every time, as
// attn_bwd.cu sums it. Two kernels, both programmatic dependent launches:
//   1. segment_attn_bwd_rows: d_msg, and each block's share of d_w. A
//      block loops over tiles of kMailboxThreads / group slots (tile b,
//      b + grid, ...; the grid is at most `blocks`, 1,056 from the
//      wrapper: eight an SM of an H100), adds each tile's slots' shares
//      in slot order to its own partial sums, and leaves them in its row
//      of the workspace (blocks, nh, D);
//   2. segment_dw_reduce: d_w[g, c] = the blocks' partial sums added in
//      block order (32 interleaved partial sums, then those in order),
//      once the rows kernel has finished (attn_bwd.cu's attn_dw_reduce).
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table, the offsets, w and the (S, D) cotangent g_out read
// (stats-reading: also out, mx and den), the (E, D) cotangent and d_w
// written, over 3.35 TB/s. At the headline design (pairs 1-9) that is
// about 81 MB, 0.024 ms a backward, as segment_softmax_sum_bwd's; the
// blocks' partial sums stay in L2 (at most 0.54 MB a head). The products
// are about 2 D (3 nh + 1) flop an edge (scores, da, the score path,
// d_w), far below the f32 rate (chip_smoke.py, phase 12 (a), prints each
// beside the kernel's time and its one-slot floor).
//
// Design: segment_attn_sum's two paths (common.cuh). Heads together: a
// lane group of D / 4 lanes covers a slot, one float4 a lane; a slot of
// up to 4 edges keeps its rows and scores in registers from the
// recompute (or, stats-reading, from one load before the wait), a wider
// one walks its edges 4 rows at a time. For each chunk: each lane's own
// head's alpha, da (a butterfly over the head's lanes) and ds; then for
// each head g in turn each lane takes ds_eg from the head's first lane
// and adds ds_eg w[g] into its score-path sums and ds_eg x_e into the
// slot's share of d_w[g] in shared memory, (tile slots, nh, D); last the
// value path alpha g_out is added and each edge's float4 stored. The
// tile's shares go into the block's partial sums (shared memory, nh x D)
// in one pass: two barriers a tile. The per-head loop (the other shapes,
// and N = 1 for D % 4 != 0 or a pointer off 16-byte alignment): per head,
// walks over the slot's edges, the score path summed in d_msg itself
// (each lane its own channels) and the share in shared memory, then
// into the block's row of the workspace, a head at a time.
//
// segment_attn_bwd_rows is a programmatic dependent launch (common.cuh):
// with the heads together, before grid_dep_wait() it reads off, src, w,
// the slots' rows of hf and, stats-reading, the saved out, mx and den
// (the graph's tables, a weight, and tensors written before the kernel
// just before it: hf by the forward, the statistics by its combine), and
// recomputes the slot's softmax there; after it g_out (d_f, which the
// fc_cell_neigh gradients just before this kernel write), then every
// store. The per-head loop waits first. segment_dw_reduce reads nothing
// before its wait.

#include "common.cuh"

constexpr int kReduceLanes = 32;  // segment_dw_reduce: partial sums an element
constexpr int kMaxShare = 232448;  // bytes of shared memory a block may use

// Adds the tile's rows of `share` ((slots of the tile, n): the slots'
// shares of n elements of d_w), in slot order, to the block's partial
// sums `part` (n floats, this block's alone, in shared or global
// memory); the tile is the block's first if `first`. Every thread of the
// block calls it between two barriers.
__device__ __forceinline__ void add_share(float* part,
                                          const float* __restrict__ share,
                                          int n, int tile_rows, bool first) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float sum = first ? 0.f : part[c];
    for (int r = 0; r < tile_rows; ++r) sum += share[r * n + c];
    part[c] = sum;
  }
}

// Heads together: NH heads, one float4 a lane, group == d / 4. STATS:
// the stats-reading mode; else the recomputing one. partial: (gridDim.x,
// NH, d), this block's share of d_w summed over its tiles in order.
template <int NH, bool STATS>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_attn_bwd_heads_kernel(
        const float* __restrict__ h, const int32_t* __restrict__ src,
        const int32_t* __restrict__ off, const float* __restrict__ w,
        const float* __restrict__ out, const float* __restrict__ mx_in,
        const float* __restrict__ den_in, const float* g_out,
        float* __restrict__ d_msg, float* __restrict__ partial, int64_t segs,
        int d, int nh, int group, int64_t tiles) {
  // (tile slots, NH, d): the slots' shares; then the block's partial sums
  extern __shared__ __align__(16) float share[];
  const int tile_rows = kMailboxThreads / group;
  const int n = NH * d;
  float* srow = share + (threadIdx.x / group) * n;  // this group's slot
  float* part = share + tile_rows * n;
  const int c = threadIdx.x & (group - 1);  // this lane's float4
  const int lanes = group / NH;             // a head's lanes
  const int hg = c / lanes;                 // this lane's head
  float wv[NH][4];
#pragma unroll
  for (int gg = 0; gg < NH; ++gg)
    load_vec<4>(w + static_cast<int64_t>(gg) * d + c * 4, wv[gg]);
  // no lane leaves the loops early: every lane of the warp takes part in
  // the shuffles, every thread of the block in the barriers
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const RowLanes rl = row_lanes(group, tile);
    const bool row_ok = rl.row < segs;
    // ---- before the wait: the tables, hf, w and the statistics ----
    int32_t begin, idx[kSlotRows];
    const int deg = slot_edges(src, off, rl, row_ok, group, begin, idx);
    const int wdeg = __reduce_max_sync(0xffffffffu, deg);
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
        attn_chunk<NH, false>(h, src, idx, begin, deg, wdeg, 0, d, c * 4, wv,
                              c, group, x, s);
    } else {
      float num[4];
      slot_attn<NH, false>(h, src, idx, begin, deg, wdeg, d, c * 4, wv, c,
                           group, x, s, mx, den, num);
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = softmax_out(num[k], den);
    }
    const float dd = fmaxf(den, 1e-12f);
    // ---- after the wait: g_out, then the stores ----
    grid_dep_wait();
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
#pragma unroll
    for (int gg = 0; gg < NH; ++gg) {
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      store_vec<4>(srow + gg * d + c * 4, zero);
    }
#pragma unroll 1
    for (int j0 = 0; j0 == 0 || j0 < wdeg; j0 += kSlotRows) {
      if (wdeg > kSlotRows)
        attn_chunk<NH, false>(h, src, idx, begin, deg, wdeg, j0, d, c * 4, wv,
                              c, group, x, s);
      float a[kSlotRows], ds[kSlotRows];
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
        a[i] = ds[i] = 0.f;
        if (j0 + i < wdeg) {  // the same in every lane of the warp
          const bool valid = j0 + i < deg;
          float p = 0.f;
#pragma unroll
          for (int k = 0; k < 4; ++k) p += gs[k] * x[i][k];
          const float da = group_sum(p, lanes);
          if (valid) {
            a[i] = expf(s[i] - mx) / dd;
            ds[i] = a[i] * (da - t);
          }
        }
      }
      float sc[kSlotRows][4];
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[i][k] = 0.f;
#pragma unroll
      for (int gg = 0; gg < NH; ++gg) {
        float* sh = srow + gg * d + c * 4;
        float dw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) dw[k] = sh[k];
#pragma unroll
        for (int i = 0; i < kSlotRows; ++i) {
          if (j0 + i < wdeg) {
            const float dsg = __shfl_sync(0xffffffffu, ds[i], gg * lanes,
                                          group);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              sc[i][k] += dsg * wv[gg][k];
              dw[k] += dsg * x[i][k];
            }
          }
        }
        store_vec<4>(sh, dw);
      }
#pragma unroll
      for (int i = 0; i < kSlotRows; ++i) {
        if (j0 + i < deg) {
          float o[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) o[k] = a[i] * gs[k] + sc[i][k];
          store_vec<4>(d_msg + static_cast<int64_t>(begin + j0 + i) * d +
                           c * 4,
                       o);
        }
      }
    }
    __syncthreads();
    add_share(part, share, n, tile_rows, first);
    __syncthreads();
  }
  float* row = partial + static_cast<int64_t>(blockIdx.x) * n;
  for (int e = threadIdx.x; e < n; e += blockDim.x) row[e] = part[e];
}

// The per-head loop: any nh dividing d, N floats a vector. share: (tile
// slots, d), a head's shares at a time; partial: (gridDim.x, nh, d).
template <int N, bool STATS>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_attn_bwd_loop_kernel(
        const float* __restrict__ h, const int32_t* __restrict__ src,
        const int32_t* __restrict__ off, const float* __restrict__ w,
        const float* __restrict__ out, const float* __restrict__ mx_in,
        const float* __restrict__ den_in, const float* g_out,
        float* __restrict__ d_msg, float* __restrict__ partial, int64_t segs,
        int d, int nh, int group, int64_t tiles) {
  extern __shared__ __align__(16) float share[];
  const int tile_rows = kMailboxThreads / group;
  float* srow = share + (threadIdx.x / group) * d;  // this group's slot
  float* part = partial + static_cast<int64_t>(blockIdx.x) * nh * d;
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
      add_share(part + static_cast<int64_t>(hg) * d, share, d, tile_rows,
                first);
      __syncthreads();
    }
  }
}

// Block (32 elements) x kReduceLanes: lane y sums blocks y, y + 32, ...
// in order, then lane 0 sums the 32 partial sums in order.
__global__ void segment_dw_reduce_kernel(const float* partial,
                                         float* __restrict__ d_w, int blocks,
                                         int elems) {
  __shared__ float part[kReduceLanes][32];
  grid_dep_wait();
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < elems) {
#pragma unroll 8
    for (int b = threadIdx.y; b < blocks; b += kReduceLanes)
      acc += __ldcg(partial + static_cast<int64_t>(b) * elems + e);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < elems) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceLanes; ++y) sum += part[y][threadIdx.x];
    d_w[e] = sum;
  }
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

// Launches segment_attn_bwd_rows on at most `blocks` blocks; *grid gets
// the number launched.
template <int N>
static cudaError_t launch_rows(const float* h, const int32_t* src,
                               const int32_t* off, const float* w,
                               const float* out, const float* mx,
                               const float* den, const float* g, float* d_msg,
                               float* partial, int64_t segs, int d, int nh,
                               int blocks, unsigned* grid, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(vecs > kSlotRows ? vecs : kSlotRows);
  const int tile_rows = kMailboxThreads / group;
  const int64_t tiles = mailbox_grid(segs, group);
  const bool stats = out != nullptr;
  const bool together = N == 4 && attn_heads_together(vecs, nh);
  const SegmentAttnBwdKernel kernel =
      together ? (stats ? heads_kernel<true>(nh) : heads_kernel<false>(nh))
      : stats  ? &segment_attn_bwd_loop_kernel<N, true>
               : &segment_attn_bwd_loop_kernel<N, false>;
  // the tile's shares, and with the heads together the block's partial
  // sums after them
  const size_t smem = sizeof(float) * d *
                      (together ? (tile_rows + 1) * nh : tile_rows);
  if (smem > kMaxShare) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  *grid = static_cast<unsigned>(tiles < blocks ? tiles : blocks);
  return launch_programmatic(kernel, *grid, kMailboxThreads, smem, s, h, src,
                             off, w, out, mx, den, g, d_msg, partial, segs, d,
                             nh, group, tiles);
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, w: (nh, d) float32 with nh dividing d, g: (segs, d)
// float32, d_msg: (off[segs], d) float32, d_w: (nh, d) float32; out:
// (segs, d), mx, den: (segs, nh) float32 all three (stats-reading), or
// all null (recomputing); work: blocks * nh * d floats of workspace
// (blocks >= 1).
PRTP_EXPORT int segment_attn_bwd_launch(const void* h, const void* src,
                                        const void* off, const void* w,
                                        const void* out, const void* mx,
                                        const void* den, const void* g,
                                        void* d_msg, void* d_w, void* work,
                                        int64_t segs, int d, int nh,
                                        int blocks, void* stream) {
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
  float* partial = static_cast<float*>(work);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(out) | reinterpret_cast<uintptr_t>(g) |
      reinterpret_cast<uintptr_t>(d_msg);
  unsigned grid = 0;
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch_rows<4>(hp, sp, op, wp, fp, mp, dp, gp, rp, partial, segs,
                           d, nh, blocks, &grid, s)
          : launch_rows<1>(hp, sp, op, wp, fp, mp, dp, gp, rp, partial, segs,
                           d, nh, blocks, &grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elems = nh * d;
  return static_cast<int>(launch_programmatic(
      segment_dw_reduce_kernel, (elems + 31) / 32, dim3(32, kReduceLanes), 0,
      s, static_cast<const float*>(partial), static_cast<float*>(d_w),
      static_cast<int>(grid), elems));
}
