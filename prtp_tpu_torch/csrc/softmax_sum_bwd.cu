// softmax_sum_bwd: the cotangent of the cell half's mailbox softmax-weighted
// sum, read straight from the final node state hf.
//
// Replaces, for each level pair k > 0 of the walk's backward in
// prtp_tpu/ops/fused_gnn.py::_bwd, the re-gathered mailbox
// `m = hf[cell_mail]` (:288), the recomputed weights of
// `_softmax_sum(m, validc)` (:293) and
// `d_mail_c = d_f[:, None, :] * w * (1.0 + m - f[:, None, :])` (:302-303).
// For a row r, a slot j and a channel c, over the valid slots:
//   mx  = max_j m[r, j, c] (NaN if any is NaN; 0 when not finite)
//   w_j = exp(m[r, j, c] - mx) / max(sum_j exp(m[r, j, c] - mx), 1e-12)
//   out[r*k + j, c] = (d_f[r, c] * w_j) * ((1 + m[r, j, c]) - f[r, c])
// An invalid slot (idx[r, j] == num_rows) is not written: its row of out
// is undefined. The only reader, the merged mailbox_scatter, reads the
// cell positions of real edges (cell_rev_pos), all valid slots.
// Reading hf is exact: every mailbox row is final once its level has
// been written (the argument of fused_gnn.py:17-20).
//
// Bound on Hopper: bytes. A few float operations per element (one exp),
// far below the f32 rate. At the headline design (79,991 nodes, pairs
// 1-9) the cell mailboxes hold 113,016 slots, 70,789 valid, 57,968
// distinct rows over the nine calls: 29.7 MB of rows, 0.45 MB of
// indices, f and d_f 28.9 MB, and 36.2 MB of output (valid slots only),
// 95 MB a backward, 28 us at 3.35 TB/s. But each call is small (10,359
// rows at most, about one wave of warps), so it costs its launch and a
// chain of dependent loads more than its bytes. JAX also gathers the
// mailbox first (57.9 MB written and read again) and writes zeros at the
// invalid slots; the kernel reads hf by index and never builds it.
//
// Design: the lane layout of softmax_sum (common.cuh): a lane group
// covers one row, one float4 of channels a lane (a whole warp at
// D = 128), the row's k indices loaded once by k lanes and shared by
// shuffle. For k <= 8 every valid slot's 16-byte load is issued before
// any arithmetic and kept in registers with its exp; then each slot's
// float4 of cotangent is stored (one store a valid slot, each a 512-byte
// row segment across the warp at D = 128). k > 8 takes a generic path that
// re-reads the slots (from L1) in three passes; D % 4 != 0 or a pointer
// off 16-byte alignment takes the scalar path (N = 1).
//
// Launched as a programmatic dependent launch (common.cuh), so that the
// launch and the idx -> hf chain overlap the kernel before it. Before
// grid_dep_wait() the kernel reads idx (the graph's cell_mail, copied to
// the card when the design was packed) and h (the walk's final state hf,
// written by the forward, before the backward began), and computes each
// slot's max, exp and denominator. After it, f and d_f (which the
// kernels just before this one write), then every store.

#include <math.h>

#include "common.cuh"

// KMAX > 0: the register path for k <= KMAX; KMAX == 0: any k.
template <int N, int KMAX>
__global__ void __launch_bounds__(kMailboxThreads)
    softmax_sum_bwd_kernel(const float* __restrict__ h,
                           const int32_t* __restrict__ idx,
                           const float* f, const float* df,
                           float* __restrict__ out, int64_t rows, int k, int d,
                           int num_rows, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < rows;
  const int vecs = d / N;
  if constexpr (KMAX > 0) {
    int32_t src[KMAX];
    row_indices<KMAX>(idx, rl, row_ok, k, group, src);
    if (!row_ok) return;
    bool ok[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) ok[j] = j < k && src[j] != num_rows;
    for (int c = rl.lane; c < vecs; c += group) {
      // ---- before the wait: idx and h only ----
      float x[KMAX][N];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (ok[j]) load_vec<N>(h + static_cast<int64_t>(src[j]) * d + c * N, x[j]);
      float e[KMAX][N];
      float den[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (ok[j]) mx = nan_max(mx, x[j][i]);
        if (!isfinite(mx)) mx = 0.f;
        den[i] = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          e[j][i] = ok[j] ? expf(x[j][i] - mx) : 0.f;
          den[i] += e[j][i];
        }
        den[i] = fmaxf(den[i], 1e-12f);
      }
      // ---- after the wait: f, d_f and the stores ----
      grid_dep_wait();
      float fv[N], dv[N];
      load_vec_cg<N>(f + rl.row * d + c * N, fv);
      load_vec_cg<N>(df + rl.row * d + c * N, dv);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (ok[j]) {
          float o[N];
#pragma unroll
          for (int i = 0; i < N; ++i)
            o[i] = (dv[i] * (e[j][i] / den[i])) * ((1.f + x[j][i]) - fv[i]);
          store_vec<N>(out + (rl.row * k + j) * d + c * N, o);
        }
      }
    }
  } else {
    if (!row_ok) return;
    const int32_t* irow = idx + rl.row * k;
    for (int c = rl.lane; c < vecs; c += group) {
      // ---- before the wait: idx and h only ----
      float mx[N], den[N], x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        mx[i] = -INFINITY;
        den[i] = 0.f;
      }
      for (int j = 0; j < k; ++j) {
        if (irow[j] == num_rows) continue;
        load_vec<N>(h + static_cast<int64_t>(irow[j]) * d + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) mx[i] = nan_max(mx[i], x[i]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (!isfinite(mx[i])) mx[i] = 0.f;
      for (int j = 0; j < k; ++j) {
        if (irow[j] == num_rows) continue;
        load_vec<N>(h + static_cast<int64_t>(irow[j]) * d + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) den[i] += expf(x[i] - mx[i]);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) den[i] = fmaxf(den[i], 1e-12f);
      // ---- after the wait: f, d_f and the stores ----
      grid_dep_wait();
      float fv[N], dv[N];
      load_vec_cg<N>(f + rl.row * d + c * N, fv);
      load_vec_cg<N>(df + rl.row * d + c * N, dv);
      for (int j = 0; j < k; ++j) {
        if (irow[j] == num_rows) continue;
        load_vec<N>(h + static_cast<int64_t>(irow[j]) * d + c * N, x);
        float o[N];
#pragma unroll
        for (int i = 0; i < N; ++i)
          o[i] = (dv[i] * (expf(x[i] - mx[i]) / den[i])) * ((1.f + x[i]) - fv[i]);
        store_vec<N>(out + (rl.row * k + j) * d + c * N, o);
      }
    }
  }
}

template <int N>
static cudaError_t launch(const float* h, const int32_t* idx, const float* f,
                          const float* df, float* out, int64_t rows, int k,
                          int d, int num_rows, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(k <= 8 && k > vecs ? k : vecs);
  const unsigned grid = mailbox_grid(rows, group);
  auto kernel = k <= 4   ? &softmax_sum_bwd_kernel<N, 4>
                : k <= 8 ? &softmax_sum_bwd_kernel<N, 8>
                         : &softmax_sum_bwd_kernel<N, 0>;
  return launch_programmatic(kernel, grid, kMailboxThreads, 0, s, h, idx, f,
                             df, out, rows, k, d, num_rows, group);
}

// h: (> num_rows, d) float32, idx: (rows, k) int32 with values in
// [0, num_rows], f, df: (rows, d) float32, out: (rows * k, d) float32,
// written at valid slots only.
PRTP_EXPORT int softmax_sum_bwd_launch(const void* h, const void* idx,
                                       const void* f, const void* df,
                                       void* out, int64_t rows, int k, int d,
                                       int num_rows, void* stream) {
  if (rows == 0 || k == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* fp = static_cast<const float*>(f);
  const float* dp = static_cast<const float*>(df);
  float* op = static_cast<float*>(out);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(f) |
      reinterpret_cast<uintptr_t>(df) | reinterpret_cast<uintptr_t>(out);
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4>(hp, ip, fp, dp, op, rows, k, d, num_rows, s)
          : launch<1>(hp, ip, fp, dp, op, rows, k, d, num_rows, s);
  return static_cast<int>(err);
}
