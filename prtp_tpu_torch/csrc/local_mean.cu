// local_mean: the net half's mailbox mean, read from its two sources.
//
// Replaces the net half of the walk in
// prtp_tpu/ops/fused_gnn.py::_forward_impl (:194-200): the local buffer
// buf = concatenate([new, prior, zeros(1, D)]), the local gather
// `m_n = buf[net_local_idx]` and `_mean_sum(m_n, validn)` (:84-87). The
// buffer is never built: a slot i < n_new reads new[i] (the cell rows
// this pair just wrote), a slot n_new <= i < n_valid = n_new + n_prior
// reads prior[i - n_new] (the gathered rows of earlier levels), and
// i == n_valid is invalid and never read (the packer points every empty
// slot there, so this is exactly `net_mail != num_rows`). For a row r
// and a channel c:
//   out[r, c] = sum_{valid j} src(idx[r, j])[c] / max(#valid, 1)
// An all-invalid row gives 0.
//
// Bound on Hopper: bytes: the distinct source rows, the indices and the
// output, over 3.35 TB/s; one add an element. At the headline design
// (79,991 nodes, 10 pairs) every net mailbox has one slot, all valid:
// 24,485 distinct rows (12.5 MB), 35,551 indices (0.14 MB) and 35,551
// output rows (18.2 MB), 30.9 MB per forward, 9.2 us. The JAX form
// first copies both sources into buf: at the headline 44,440 rows, 22.8
// MB read and 22.8 MB written, more than the reduce itself moves. The
// kernel reads the rows where they lie, so that copy is never made.
//
// Design: the lane layout of softmax_sum (common.cuh): a lane group
// covers one row, one float4 a lane, the row's k indices loaded once and
// shared by shuffle. k = 1, the shape of every net mailbox at the
// headline and in real netlists (one driver a net), is a predicated
// float4 row copy with no slot loop. For k <= 8 every valid slot's load
// is issued before the sum; k > 8 loops over the slots; D % 4 != 0 or a
// pointer off 16-byte alignment takes the scalar path (N = 1).

#include "common.cuh"

// KMAX == 1: k = 1; KMAX == 8: k <= 8; KMAX == 0: any k.
template <int N, int KMAX>
__global__ void __launch_bounds__(kMailboxThreads)
    local_mean_kernel(const float* __restrict__ fresh,
                      const float* __restrict__ prior,
                      const int32_t* __restrict__ idx,
                      float* __restrict__ out, int64_t rows, int k, int d,
                      int n_new, int n_valid, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < rows;
  const int vecs = d / N;
  auto source = [&](int32_t i) {
    return i < n_new ? fresh + static_cast<int64_t>(i) * d
                     : prior + static_cast<int64_t>(i - n_new) * d;
  };
  if constexpr (KMAX > 0) {
    int32_t src[KMAX];
    row_indices<KMAX>(idx, rl, row_ok, k, group, src);
    if (!row_ok) return;
    bool ok[KMAX];
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      ok[j] = j < k && src[j] < n_valid;
      cnt += ok[j];
    }
    const float div = static_cast<float>(cnt > 0 ? cnt : 1);
    for (int c = rl.lane; c < vecs; c += group) {
      float x[KMAX][N];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
#pragma unroll
        for (int i = 0; i < N; ++i) x[j][i] = 0.f;
        if (ok[j]) load_vec<N>(source(src[j]) + c * N, x[j]);
      }
      float res[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if constexpr (KMAX == 1) {
          res[i] = x[0][i];  // s / 1
        } else {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (ok[j]) s += x[j][i];
          res[i] = s / div;
        }
      }
      store_vec<N>(out + rl.row * d + c * N, res);
    }
  } else {
    if (!row_ok) return;
    const int32_t* irow = idx + rl.row * k;
    int cnt = 0;
    for (int j = 0; j < k; ++j) cnt += irow[j] < n_valid;
    const float div = static_cast<float>(cnt > 0 ? cnt : 1);
    for (int c = rl.lane; c < vecs; c += group) {
      float s[N], x[N];
#pragma unroll
      for (int i = 0; i < N; ++i) s[i] = 0.f;
      for (int j = 0; j < k; ++j) {
        if (irow[j] >= n_valid) continue;
        load_vec<N>(source(irow[j]) + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) s[i] += x[i];
      }
#pragma unroll
      for (int i = 0; i < N; ++i) x[i] = s[i] / div;
      store_vec<N>(out + rl.row * d + c * N, x);
    }
  }
}

template <int N>
static void launch(const float* fresh, const float* prior,
                   const int32_t* idx, float* out, int64_t rows, int k, int d,
                   int n_new, int n_valid, cudaStream_t s) {
  const int vecs = d / N;
  const int group = lane_group(k <= 8 && k > vecs ? k : vecs);
  const unsigned grid = mailbox_grid(rows, group);
  if (k == 1)
    local_mean_kernel<N, 1><<<grid, kMailboxThreads, 0, s>>>(
        fresh, prior, idx, out, rows, k, d, n_new, n_valid, group);
  else if (k <= 8)
    local_mean_kernel<N, 8><<<grid, kMailboxThreads, 0, s>>>(
        fresh, prior, idx, out, rows, k, d, n_new, n_valid, group);
  else
    local_mean_kernel<N, 0><<<grid, kMailboxThreads, 0, s>>>(
        fresh, prior, idx, out, rows, k, d, n_new, n_valid, group);
}

// fresh: (n_new, d) float32, prior: (n_prior, d) float32 (unread when
// n_prior is 0), idx: (rows, k) int32 with values in [0, n_new + n_prior],
// out: (rows, d) float32.
PRTP_EXPORT int local_mean_launch(const void* fresh, const void* prior,
                                  const void* idx, void* out, int64_t rows,
                                  int k, int d, int n_new, int n_prior,
                                  void* stream) {
  if (rows == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fp = static_cast<const float*>(fresh);
  const float* pp = static_cast<const float*>(prior);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  float* op = static_cast<float*>(out);
  const uintptr_t align = reinterpret_cast<uintptr_t>(fresh) |
                          (n_prior ? reinterpret_cast<uintptr_t>(prior) : 0) |
                          reinterpret_cast<uintptr_t>(out);
  if (d % 4 == 0 && align % 16 == 0)
    launch<4>(fp, pp, ip, op, rows, k, d, n_new, n_new + n_prior, s);
  else
    launch<1>(fp, pp, ip, op, rows, k, d, n_new, n_new + n_prior, s);
  return static_cast<int>(cudaGetLastError());
}
