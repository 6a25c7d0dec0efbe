// softmax_sum: the cell half's mailbox softmax-weighted sum, read straight
// from the node state h.
//
// Replaces, for each level pair k > 0 of the walk in
// prtp_tpu/ops/fused_gnn.py::_forward_impl, the cell mailbox's part of
// the merged gather `gat = h[b["gather_rows"]]` (:171, :178) and
// `_softmax_sum(m_c, valid)` (:72-81, called at :183). The mailbox
// `m[r, j] = h[idx[r, j]]` is never built. A slot is valid when
// idx[r, j] != num_rows (the dummy row; :175) and an invalid slot is
// never read. For a row r and a channel c, over the valid slots j:
//   mx  = max_j m[r, j, c]            (NaN if any is NaN, as jnp.max;
//                                      then 0 when it is not finite:
//                                      the isfinite guard)
//   e_j = exp(m[r, j, c] - mx)
//   out[r, c] = sum_j (e_j / max(sum_j e_j, 1e-12)) * m[r, j, c]
// An all-invalid row gives 0, never NaN. (JAX also multiplies each
// invalid slot's weight 0 by the dummy row, which changes nothing while
// that row is finite, as the walk's is.)
//
// Bound on Hopper: bytes. A few float operations per element (one exp),
// far below the f32 rate. At the headline design (79,991 nodes, pairs
// 1-9) the cell mailboxes hold 113,016 slots, 70,789 valid, 57,968
// distinct rows: 29.7 MB of distinct rows, 0.45 MB of indices and 14.5
// MB of output, 44.6 MB per forward, 13.3 us at 3.35 TB/s. Gathering
// the mailbox first, as the TPU had to (single HBM rows were not
// DMA-able there), wrote and read back 57.9 MB more; Hopper fetches a
// 512-byte row on its own in 32-byte sectors, so the reduce reads h.
//
// Design: a lane group covers one row, one float4 of channels a lane (a
// whole warp at D = 128; a warp takes several rows where D < 128). The
// row's k indices are loaded once, by k lanes, and shared by shuffle.
// For k <= 8 every valid slot's 16-byte load is issued before any
// arithmetic and kept in registers (4 x 16 B in flight a lane at the
// headline's k = 4), exp runs once per element and its value is kept,
// and the result is stored as a float4. k > 8 takes a generic path that
// re-reads the slots (from L1) in each pass; D % 4 != 0 or a pointer off
// 16-byte alignment takes the scalar path (N = 1).

#include <math.h>

#include "common.cuh"

// KMAX > 0: the register path for k <= KMAX; KMAX == 0: any k.
template <int N, int KMAX>
__global__ void __launch_bounds__(kMailboxThreads)
    softmax_sum_kernel(const float* __restrict__ h,
                       const int32_t* __restrict__ idx,
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
      float x[KMAX][N];
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (ok[j]) load_vec<N>(h + static_cast<int64_t>(src[j]) * d + c * N, x[j]);
      float res[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (ok[j]) mx = nan_max(mx, x[j][i]);
        if (!isfinite(mx)) mx = 0.f;
        float e[KMAX];
        float den = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          e[j] = ok[j] ? expf(x[j][i] - mx) : 0.f;
          den += e[j];
        }
        den = fmaxf(den, 1e-12f);
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (ok[j]) acc += (e[j] / den) * x[j][i];
        res[i] = acc;
      }
      store_vec<N>(out + rl.row * d + c * N, res);
    }
  } else {
    if (!row_ok) return;
    const int32_t* irow = idx + rl.row * k;
    for (int c = rl.lane; c < vecs; c += group) {
      float mx[N], den[N], acc[N], x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        mx[i] = -INFINITY;
        den[i] = acc[i] = 0.f;
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
      for (int j = 0; j < k; ++j) {
        if (irow[j] == num_rows) continue;
        load_vec<N>(h + static_cast<int64_t>(irow[j]) * d + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += (expf(x[i] - mx[i]) / den[i]) * x[i];
      }
      store_vec<N>(out + rl.row * d + c * N, acc);
    }
  }
}

template <int N>
static void launch(const float* h, const int32_t* idx, float* out,
                   int64_t rows, int k, int d, int num_rows,
                   cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(k <= 8 && k > vecs ? k : vecs);
  const unsigned grid = mailbox_grid(rows, group);
  if (k <= 4)
    softmax_sum_kernel<N, 4><<<grid, kMailboxThreads, 0, s>>>(
        h, idx, out, rows, k, d, num_rows, group);
  else if (k <= 8)
    softmax_sum_kernel<N, 8><<<grid, kMailboxThreads, 0, s>>>(
        h, idx, out, rows, k, d, num_rows, group);
  else
    softmax_sum_kernel<N, 0><<<grid, kMailboxThreads, 0, s>>>(
        h, idx, out, rows, k, d, num_rows, group);
}

// h: (> num_rows, d) float32, idx: (rows, k) int32 with values in
// [0, num_rows], out: (rows, d) float32.
PRTP_EXPORT int softmax_sum_launch(const void* h, const void* idx, void* out,
                                   int64_t rows, int k, int d, int num_rows,
                                   void* stream) {
  if (rows == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && align % 16 == 0)
    launch<4>(hp, ip, op, rows, k, d, num_rows, s);
  else
    launch<1>(hp, ip, op, rows, k, d, num_rows, s);
  return static_cast<int>(cudaGetLastError());
}
