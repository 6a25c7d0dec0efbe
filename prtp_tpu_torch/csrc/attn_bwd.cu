// attn_bwd: the cotangents of the --attn cell reduce (attn_sum.cu), read
// straight from the final node state hf.
//
// Replaces, for each level pair k > 0 of the walk's backward in
// prtp_tpu/ops/fused_gnn.py::_bwd, the re-gathered mailbox
// `m = hf[cell_mail]` (:288) and `_attn_bwd(m, validc, w_attn, nh, d_f,
// alpha_c)` (:111-129, called at :297-299). w is fc_attn2's weight in
// torch's layout (nh, D), alpha (P, K, nh) attn_sum's weights (0 at an
// invalid slot), d_f (P, D) the output's cotangent. For a row r, a valid
// slot j, a head g and a channel c, with g(c) = c / (D / nh):
//   da_jg = sum_{c of head g} m[r, j, c] * d_f[r, c]
//   t_g   = sum_j alpha[r, j, g] * da_jg
//   ds_jg = alpha[r, j, g] * (da_jg - t_g)      (0 at an invalid slot)
//   out[r*k + j, c] = alpha[r, j, g(c)] * d_f[r, c] + sum_g ds_jg w[g, c]
//   d_w[g, c] = sum over the rows and valid slots of m[r, j, c] * ds_jg
// An invalid slot's row of out is not written: it is undefined. The only
// reader, the merged mailbox_scatter, reads the cell positions of real
// edges (cell_rev_pos), all valid slots. Reading hf is exact: every
// mailbox row is final once its level has been written (the argument of
// fused_gnn.py:17-20).
//
// d_w sums every valid slot of the pair (70,789 at the headline over
// nine calls): it is summed in a fixed order, without float atomics, so
// that a call gives the same bits every time. Two kernels, both
// programmatic dependent launches:
//   1. attn_bwd_rows: out, and each block's share of d_w. A block loops
//      over tiles of kMailboxThreads / group rows (tile b, b + grid, ...;
//      the grid is at most `blocks`, 1,056 from the wrapper: eight an SM
//      of an H100), adds each tile's rows' shares in row order to its
//      own partial sums, and leaves them in its row of the workspace
//      (blocks, nh, D);
//   2. attn_dw_reduce: d_w[g, c] = the blocks' partial sums added in
//      block order (32 interleaved partial sums, then those in order),
//      once the rows kernel has finished.
// One kernel a call, whose last blocks took integer tickets and added
// the partial sums themselves, was slower on the H100: its tail of
// fences, atomics and adds on one SM cost more than the launch it saved
// (PERF.md §6).
//
// Bound on Hopper: bytes. At the headline design the nine calls read
// 29.7 MB of distinct rows, 0.45 MB of indices, 14.5 MB of d_f and 0.45
// MB a head of alpha, and write the valid slots' cotangent (36.2 MB):
// about 81 MB a backward, 24 us at 3.35 TB/s. The blocks' partial sums
// stay in L2 (at most 0.54 MB a head). The products are about
// 2 D (2 nh + 1) flop a valid slot, far below the f32 rate. Each call is
// small (10,359 rows at most), so it costs its launches and its chain of
// dependent loads more than its bytes.
//
// Design: the lane layout of softmax_sum_bwd (common.cuh): a lane group
// covers one row, one float4 of channels a lane (a whole warp at
// D = 128). For k <= 8 and at most 32 float4s a row the slots' rows,
// their alpha and the lane's d_f are loaded once into registers.
//
// Heads together (NH > 0; where attn_sum.cu's heads are together too:
// nh a power of two, D / nh a multiple of 4, the group exactly D / 4
// lanes, so head g owns the group / nh lanes from g * group / nh): each
// lane sums its float4's products with d_f, and a butterfly over its
// head's lanes gives da_jg for every head at once (log2(group / nh)
// shuffles a slot); the head's lanes compute t_g and ds_jg. Then for
// each head g in turn each lane takes ds_jg from the head's first lane
// (nh shuffles a slot) and adds ds_jg * w[g] into its score-path sums
// and ds_jg * m_j into the row's share of d_w[g]. The tile's shares of
// all heads go through shared memory in one pass, (tile rows, nh, D):
// two barriers a tile, 8 KB at nh = 4 and D = 128; the block's partial
// sums stay in shared memory (2 KB) until its last tile. Last the value
// path alpha * d_f is added and each valid slot's float4 stored.
// The other shapes keep the per-head loop (NH == 0): a float4 that spans
// heads takes each channel's own head, every lane takes part in each
// head's full-group sum, and each head's shares pass through shared
// memory on their own. k > 8 or more than 32 float4s a row takes a
// generic path: per head two passes over the slots (t, then ds), the
// score path summed in out itself and the share in shared memory, the
// rows re-read from L1. D % 4 != 0 or a pointer off 16-byte alignment
// takes the scalar path (N = 1).
//
// attn_bwd_rows is a programmatic dependent launch (common.cuh): before
// grid_dep_wait() the register paths read idx, alpha and the slots' rows
// of hf (the graph's table, and tensors written before the kernel just
// before it: alpha by the backward's recompute, hf by the forward);
// after it d_f (which the kernel just before it writes), w, then every
// store. The generic path waits first. attn_dw_reduce reads nothing
// before its wait.

#include <math.h>

#include "common.cuh"

// This lane's part of da_jg: its products of head g's channels of the
// slot's row with d_f's row, summed over its vectors, then over the group.
template <int N>
__device__ __forceinline__ float head_dot(const float* __restrict__ h,
                                         const float* dfrow, int32_t src,
                                         bool valid, int g, int d, int dh,
                                         const RowLanes& rl, int group) {
  float part = 0.f;
  if (valid) {
    for (int c = rl.lane * N; c < d; c += group * N) {
      float x[N], f[N];
      load_vec<N>(h + static_cast<int64_t>(src) * d + c, x);
      load_vec_cg<N>(dfrow + c, f);
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((c + i) / dh == g) part += x[i] * f[i];
    }
  }
  return group_sum(part, group);
}

// KMAX > 0: the register path for k <= KMAX and d / N <= group; NH > 0
// (N == 4, group == d / 4, nh == NH): its heads together; NH == 0: any
// nh. KMAX == 0: any k and d. partial: (gridDim.x, nh, d), this block's
// share of d_w summed over its tiles in order.
template <int N, int KMAX, int NH>
__global__ void __launch_bounds__(kMailboxThreads)
    attn_bwd_rows_kernel(const float* __restrict__ h,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ w,
                         const float* __restrict__ alpha, const float* df,
                         float* __restrict__ out, float* __restrict__ partial,
                         int64_t rows, int k, int d, int nh, int num_rows,
                         int group, int64_t tiles) {
  // (tile rows, NH or 1, d): the shares, stored as float4s
  extern __shared__ __align__(16) float share[];
  [[maybe_unused]] const int dh = d / nh;
  const int tile_rows = kMailboxThreads / group;
  const int n = NH > 0 ? NH * d : d;  // elements of a row's share
  float* srow = share + (threadIdx.x / group) * n;  // this group's row
  // this block's partial sums: after the shares in shared memory where
  // the heads are together, else its row of partial
  float* part = NH > 0 ? share + tile_rows * n
                       : partial + static_cast<int64_t>(blockIdx.x) * nh * d;
  // no lane leaves the loops early: every lane of the warp takes part in
  // the group sums, every thread of the block in the barriers
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const RowLanes rl = row_lanes(group, tile);
    const bool row_ok = rl.row < rows;
    const float* arow = alpha + (row_ok ? rl.row : 0) * k * nh;
    const float* dfrow = df + (row_ok ? rl.row : 0) * d;
    if constexpr (KMAX > 0 && NH > 0) {
      int32_t src[KMAX];
      row_indices<KMAX>(idx, rl, row_ok, k, group, src);
      bool ok[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        ok[j] = row_ok && j < k && src[j] != num_rows;
      const int c = rl.lane;         // this lane's float4 of channels
      const int lanes = group / NH;  // a head's lanes
      const int g = c / lanes;       // this lane's head
      float x[KMAX][N], a[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (ok[j]) {
          load_vec<N>(h + static_cast<int64_t>(src[j]) * d + c * N, x[j]);
          a[j] = __ldg(arow + j * NH + g);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) x[j][i] = 0.f;
          a[j] = 0.f;
        }
      }
      grid_dep_wait();
      float f[N];
      if (row_ok) {
        load_vec_cg<N>(dfrow + c * N, f);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = 0.f;
      }
      float ds[KMAX];
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        float prod = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) prod += x[j][i] * f[i];
        ds[j] = group_sum(prod, lanes);  // da_jg, this lane's head
        t += a[j] * ds[j];
      }
#pragma unroll
      for (int j = 0; j < KMAX; ++j) ds[j] = ok[j] ? a[j] * (ds[j] - t) : 0.f;
      float sc[KMAX][N];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
#pragma unroll
        for (int i = 0; i < N; ++i) sc[j][i] = 0.f;
#pragma unroll
      for (int gg = 0; gg < NH; ++gg) {
        float wv[N], dw[N];
        load_vec<N>(w + static_cast<int64_t>(gg) * d + c * N, wv);
#pragma unroll
        for (int i = 0; i < N; ++i) dw[i] = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float dsj = __shfl_sync(0xffffffffu, ds[j], gg * lanes, group);
#pragma unroll
          for (int i = 0; i < N; ++i) {
            sc[j][i] += dsj * wv[i];
            dw[i] += dsj * x[j][i];
          }
        }
        store_vec<N>(srow + gg * d + c * N, dw);
      }
      __syncthreads();
      add_share(part, share, n, tile_rows, first);
      __syncthreads();
      if (row_ok) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (ok[j]) {
            float o[N];
#pragma unroll
            for (int i = 0; i < N; ++i) o[i] = a[j] * f[i] + sc[j][i];
            store_vec<N>(out + (rl.row * k + j) * d + c * N, o);
          }
        }
      }
    } else if constexpr (KMAX > 0) {
      int32_t src[KMAX];
      row_indices<KMAX>(idx, rl, row_ok, k, group, src);
      bool ok[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        ok[j] = row_ok && j < k && src[j] != num_rows;
      const int c = rl.lane;  // this lane's vector of channels
      const bool mine = c < d / N;
      float x[KMAX][N], f[N], sc[KMAX][N];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (ok[j] && mine) {
          load_vec<N>(h + static_cast<int64_t>(src[j]) * d + c * N, x[j]);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) x[j][i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) sc[j][i] = 0.f;
      }
      grid_dep_wait();
      if (row_ok && mine) {
        load_vec_cg<N>(dfrow + c * N, f);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = 0.f;
      }
      for (int g = 0; g < nh; ++g) {
        float a[KMAX], da[KMAX];
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          float prod = 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i)
            if ((c * N + i) / dh == g) prod += x[j][i] * f[i];
          da[j] = group_sum(prod, group);
          a[j] = ok[j] ? arow[j * nh + g] : 0.f;
          t += a[j] * da[j];
        }
        float wv[N], dw[N];
        if (mine) {
          load_vec<N>(w + static_cast<int64_t>(g) * d + c * N, wv);
        } else {
#pragma unroll
          for (int i = 0; i < N; ++i) wv[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) dw[i] = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float dsj = ok[j] ? a[j] * (da[j] - t) : 0.f;
#pragma unroll
          for (int i = 0; i < N; ++i) {
            sc[j][i] += dsj * wv[i];
            dw[i] += dsj * x[j][i];
          }
        }
        if (mine) {
#pragma unroll
          for (int i = 0; i < N; ++i) srow[c * N + i] = dw[i];
        }
        __syncthreads();
        add_share(part + g * d, share, d, tile_rows, first);
        __syncthreads();
      }
      if (mine) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (ok[j]) {
            float o[N];
#pragma unroll
            for (int i = 0; i < N; ++i)
              o[i] = arow[j * nh + (c * N + i) / dh] * f[i] + sc[j][i];
            store_vec<N>(out + (rl.row * k + j) * d + c * N, o);
          }
        }
      }
    } else {
      grid_dep_wait();
      const int32_t* irow = idx + (row_ok ? rl.row : 0) * k;
      for (int g = 0; g < nh; ++g) {
        float t = 0.f;
        for (int j = 0; j < k; ++j) {
          const bool valid = row_ok && irow[j] != num_rows;
          const float da = head_dot<N>(h, dfrow, irow[j], valid, g, d, dh,
                                       rl, group);
          if (valid) t += arow[j * nh + g] * da;
        }
        for (int c = rl.lane * N; c < d; c += group * N)
          for (int i = 0; i < N; ++i) srow[c + i] = 0.f;
        const float* wrow = w + static_cast<int64_t>(g) * d;
        for (int j = 0; j < k; ++j) {
          const bool valid = row_ok && irow[j] != num_rows;
          const float da = head_dot<N>(h, dfrow, irow[j], valid, g, d, dh,
                                       rl, group);
          if (!valid) continue;
          const float dsj = arow[j * nh + g] * (da - t);
          // the score path, summed over the heads in out itself, and the
          // row's share of d_w[g], over the slots in order
          const float* xrow = h + static_cast<int64_t>(irow[j]) * d;
          float* orow = out + (rl.row * k + j) * d;
          for (int c = rl.lane * N; c < d; c += group * N) {
            for (int i = 0; i < N; ++i) {
              orow[c + i] = (g == 0 ? 0.f : orow[c + i]) + dsj * wrow[c + i];
              srow[c + i] += dsj * xrow[c + i];
            }
          }
        }
        __syncthreads();
        add_share(part + g * d, share, d, tile_rows, first);
        __syncthreads();
      }
      for (int j = 0; j < k; ++j) {
        if (!(row_ok && irow[j] != num_rows)) continue;
        float* orow = out + (rl.row * k + j) * d;
        for (int c = rl.lane * N; c < d; c += group * N)
          for (int i = 0; i < N; ++i)
            orow[c + i] =
                arow[j * nh + (c + i) / dh] * __ldcg(dfrow + c + i) +
                orow[c + i];
      }
    }
  }
  if constexpr (NH > 0) {
    float* row = partial + static_cast<int64_t>(blockIdx.x) * n;
    for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = part[c];
  }
}

// d_w from the blocks' partial sums (common.cuh's dw_reduce).
__global__ void attn_dw_reduce_kernel(const float* partial,
                                      float* __restrict__ d_w, int blocks,
                                      int elems) {
  dw_reduce(partial, d_w, blocks, elems);
}

// every instantiation has the same parameters
using AttnBwdKernel = decltype(&attn_bwd_rows_kernel<1, 0, 0>);

// The register path's kernel for nh heads: heads together where they
// may be, else the per-head loop.
template <int N, int KMAX>
static AttnBwdKernel register_kernel(int nh, bool together) {
  if constexpr (N == 4) {
    if (together) {
      switch (nh) {
        case 1: return &attn_bwd_rows_kernel<4, KMAX, 1>;
        case 2: return &attn_bwd_rows_kernel<4, KMAX, 2>;
        case 4: return &attn_bwd_rows_kernel<4, KMAX, 4>;
        case 8: return &attn_bwd_rows_kernel<4, KMAX, 8>;
        case 16: return &attn_bwd_rows_kernel<4, KMAX, 16>;
        case 32: return &attn_bwd_rows_kernel<4, KMAX, 32>;
        default: break;
      }
    }
  }
  return &attn_bwd_rows_kernel<N, KMAX, 0>;
}

// Launches attn_bwd_rows on at most `blocks` blocks; *grid gets the
// number launched.
template <int N>
static cudaError_t launch_rows(const float* h, const int32_t* idx,
                               const float* w, const float* alpha,
                               const float* df, float* out, float* partial,
                               int64_t rows, int k, int d, int nh,
                               int num_rows, int blocks, unsigned* grid,
                               cudaStream_t s) {
  const int vecs = d / N;
  const bool regs = k <= 8 && vecs <= 32;
  const int group = lane_group(regs && k > vecs ? k : vecs);
  const int64_t tiles = mailbox_grid(rows, group);
  const bool together = regs && group == vecs && nh <= vecs &&
                        vecs % nh == 0 && (nh & (nh - 1)) == 0;
  const AttnBwdKernel kernel =
      !regs     ? &attn_bwd_rows_kernel<N, 0, 0>
      : k <= 4  ? register_kernel<N, 4>(nh, together)
                : register_kernel<N, 8>(nh, together);
  // the tile's shares, and with the heads together the block's partial
  // sums after them
  const size_t smem = sizeof(float) * d *
                      (N == 4 && together ? (kMailboxThreads / group + 1) * nh
                                          : kMailboxThreads / group);
  if (smem > kMaxShare) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  *grid = static_cast<unsigned>(tiles < blocks ? tiles : blocks);
  return launch_programmatic(kernel, *grid, kMailboxThreads, smem, s, h, idx,
                             w, alpha, df, out, partial, rows, k, d, nh,
                             num_rows, group, tiles);
}

// h: (> num_rows, d) float32, idx: (rows, k) int32 with values in
// [0, num_rows], w: (nh, d) float32 with nh dividing d, alpha: (rows, k,
// nh), df: (rows, d), out: (rows * k, d) float32, written at valid slots
// only, d_w: (nh, d) float32; work: blocks * nh * d floats of workspace
// (blocks >= 1 when rows > 0).
PRTP_EXPORT int attn_bwd_launch(const void* h, const void* idx, const void* w,
                                const void* alpha, const void* df, void* out,
                                void* d_w, void* work, int64_t rows, int k,
                                int d, int nh, int num_rows, int blocks,
                                void* stream) {
  if (d == 0) return 0;
  if (nh < 1 || d % nh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elems = nh * d;
  if (rows == 0 || k == 0)
    return static_cast<int>(cudaMemsetAsync(d_w, 0, sizeof(float) * elems, s));
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* hp = static_cast<const float*>(h);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* wp = static_cast<const float*>(w);
  const float* ap = static_cast<const float*>(alpha);
  const float* fp = static_cast<const float*>(df);
  float* op = static_cast<float*>(out);
  float* partial = static_cast<float*>(work);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(w) |
      reinterpret_cast<uintptr_t>(df) | reinterpret_cast<uintptr_t>(out);
  unsigned grid = 0;
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch_rows<4>(hp, ip, wp, ap, fp, op, partial, rows, k, d, nh,
                           num_rows, blocks, &grid, s)
          : launch_rows<1>(hp, ip, wp, ap, fp, op, partial, rows, k, d, nh,
                           num_rows, blocks, &grid, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_programmatic(
      attn_dw_reduce_kernel, (elems + 31) / 32, dim3(32, kReduceLanes), 0, s,
      static_cast<const float*>(partial), static_cast<float*>(d_w),
      static_cast<int>(grid), elems));
}
