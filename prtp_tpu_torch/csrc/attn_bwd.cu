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
// nine calls): it is summed in a fixed order, without atomics, so that
// a call is deterministic. Two kernels, launched plainly one after the
// other on the stream:
//   1. attn_bwd_rows: out, and each block's share of d_w. A block loops
//      over tiles of kMailboxThreads / group rows (tile b, b + grid, ...;
//      the grid is at most `blocks`, 1,056 from the wrapper); for each
//      head, every row of the tile puts its share, summed over its slots
//      in order, into shared memory, and the block adds the tile's rows
//      in order to its partial sums in the workspace (blocks, nh, D);
//   2. attn_dw_reduce: d_w[g, c] = the blocks' partial sums added in
//      block order (32 interleaved partial sums, then those in order).
//
// Bound on Hopper: bytes. At the headline design the nine calls read
// 29.7 MB of distinct rows, 0.45 MB of indices, 14.5 MB of d_f and 0.45
// MB a head of alpha, and write the valid slots' cotangent (36.2 MB):
// about 81 MB a backward, 24 us at 3.35 TB/s. The blocks' partial sums
// stay in L2 (at most 0.54 MB a head). The products are about
// 2 D (2 nh + 1) flop a valid slot, far below the f32 rate. Each call is
// small (10,359 rows at most) and launches two kernels, so it costs two
// launches and their chains of dependent loads more than its bytes.
//
// Design: attn_bwd_rows takes the lane layout of softmax_sum_bwd
// (common.cuh): a lane group covers one row, one float4 of channels a
// lane (a whole warp at D = 128). For k <= 8 and at most 32 float4s a
// row the slots' rows and the lane's d_f are loaded once into registers;
// for each head every lane sums its products of that head's channels
// (a float4 that spans heads takes each channel's own head) and the group
// sums them (group_sum), then each lane has the slots' ds, adds
// ds_jg * w[g] into its score-path sums and ds_jg * m_j into the row's
// share of d_w[g]; last, the value path alpha * d_f is added and each
// valid slot's float4 stored. Other shapes take a generic path: per head
// two passes over the slots (t, then ds), the score path summed in out
// itself and the share in shared memory, the rows re-read from L1.
// D % 4 != 0 or a pointer off 16-byte alignment takes the scalar path
// (N = 1). The shared memory is kMailboxThreads / group rows of D
// floats: at most max(512, 4 D), so D is at most 3,072.

#include <math.h>

#include "common.cuh"

constexpr int kReduceLanes = 32;  // attn_dw_reduce: partial sums an element
constexpr int kMaxShare = 48 * 1024;  // attn_bwd_rows: bytes of shared memory

// This lane's part of da_jg: its products of head g's channels of the
// slot's row with d_f's row, summed over its vectors, then over the group.
template <int N>
__device__ __forceinline__ float head_dot(const float* __restrict__ h,
                                         const float* __restrict__ dfrow,
                                         int32_t src, bool valid, int g,
                                         int d, int dh, const RowLanes& rl,
                                         int group) {
  float part = 0.f;
  if (valid) {
    for (int c = rl.lane * N; c < d; c += group * N) {
      float x[N], f[N];
      load_vec<N>(h + static_cast<int64_t>(src) * d + c, x);
      load_vec<N>(dfrow + c, f);
#pragma unroll
      for (int i = 0; i < N; ++i)
        if ((c + i) / dh == g) part += x[i] * f[i];
    }
  }
  return group_sum(part, group);
}

// Adds the tile's rows of `share` ((rows of the tile, d): one head's
// share of d_w a row), in row order, to the block's partial sums `part`
// (d floats, this block's alone); the tile is the block's first if
// `first`. Every thread of the block calls it between two barriers.
__device__ __forceinline__ void add_share(float* __restrict__ part,
                                          const float* __restrict__ share,
                                          int d, int tile_rows, bool first) {
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float sum = first ? 0.f : part[c];
    for (int r = 0; r < tile_rows; ++r) sum += share[r * d + c];
    part[c] = sum;
  }
}

// KMAX > 0: the register path for k <= KMAX and d / N <= group;
// KMAX == 0: any k and d. partial: (gridDim.x, nh, d), this block's
// share of d_w summed over its tiles in order.
template <int N, int KMAX>
__global__ void __launch_bounds__(kMailboxThreads)
    attn_bwd_rows_kernel(const float* __restrict__ h,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ w,
                         const float* __restrict__ alpha,
                         const float* __restrict__ df, float* __restrict__ out,
                         float* __restrict__ partial, int64_t rows, int k,
                         int d, int nh, int num_rows, int group,
                         int64_t tiles) {
  extern __shared__ float share[];  // (tile rows, d): one head's shares
  const int dh = d / nh;
  const int tile_rows = kMailboxThreads / group;
  float* srow = share + (threadIdx.x / group) * d;  // this group's row
  float* part = partial + static_cast<int64_t>(blockIdx.x) * nh * d;
  // no lane leaves the loops early: every lane of the warp takes part in
  // the group sums, every thread of the block in the barriers
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == blockIdx.x;
    const RowLanes rl = row_lanes(group, tile);
    const bool row_ok = rl.row < rows;
    const float* arow = alpha + (row_ok ? rl.row : 0) * k * nh;
    const float* dfrow = df + (row_ok ? rl.row : 0) * d;
    if constexpr (KMAX > 0) {
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
      if (row_ok && mine) {
        load_vec<N>(dfrow + c * N, f);
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
                arow[j * nh + (c + i) / dh] * dfrow[c + i] + orow[c + i];
      }
    }
  }
}

// Block (32 elements) x kReduceLanes: lane y sums blocks y, y + 32, ...
// in order, then lane 0 sums the 32 partial sums in order.
__global__ void attn_dw_reduce_kernel(const float* __restrict__ partial,
                                      float* __restrict__ d_w, int blocks,
                                      int elems) {
  __shared__ float part[kReduceLanes][32];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < elems)
    for (int b = threadIdx.y; b < blocks; b += kReduceLanes)
      acc += partial[static_cast<int64_t>(b) * elems + e];
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < elems) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceLanes; ++y) sum += part[y][threadIdx.x];
    d_w[e] = sum;
  }
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
  const size_t smem = sizeof(float) * (kMailboxThreads / group) * d;
  if (smem > kMaxShare) return cudaErrorInvalidValue;
  *grid = static_cast<unsigned>(tiles < blocks ? tiles : blocks);
  if (regs && k <= 4)
    attn_bwd_rows_kernel<N, 4><<<*grid, kMailboxThreads, smem, s>>>(
        h, idx, w, alpha, df, out, partial, rows, k, d, nh, num_rows, group,
        tiles);
  else if (regs)
    attn_bwd_rows_kernel<N, 8><<<*grid, kMailboxThreads, smem, s>>>(
        h, idx, w, alpha, df, out, partial, rows, k, d, nh, num_rows, group,
        tiles);
  else
    attn_bwd_rows_kernel<N, 0><<<*grid, kMailboxThreads, smem, s>>>(
        h, idx, w, alpha, df, out, partial, rows, k, d, nh, num_rows, group,
        tiles);
  return cudaGetLastError();
}

// h: (> num_rows, d) float32, idx: (rows, k) int32 with values in
// [0, num_rows], w: (nh, d) float32 with nh dividing d and d <= 3072,
// alpha: (rows, k, nh), df: (rows, d), out: (rows * k, d) float32,
// written at valid slots only, d_w: (nh, d) float32; work: blocks * nh *
// d floats of workspace (blocks >= 1 when rows > 0).
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
  attn_dw_reduce_kernel<<<(elems + 31) / 32, dim3(32, kReduceLanes), 0, s>>>(
      partial, static_cast<float*>(d_w), static_cast<int>(grid), elems);
  return static_cast<int>(cudaGetLastError());
}
