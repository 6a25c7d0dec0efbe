// local_mean: the net half's local mailbox gather fused with its masked
// mean.
//
// Replaces the net half of the level walk in prtp_tpu/ops/fused_gnn.py
// (`_forward_impl`): `m_n = buf[net_local_idx]` followed by `_mean_sum`,
// where buf = [new cell rows | gathered prior rows | zero row]. A slot is
// valid when its index is below num_valid (= rows of buf before the zero
// dummy; the packer points every empty slot at the dummy, so this is
// exactly `net_mail != num_rows`). For a row r and a channel c:
//   out[r, c] = sum_{valid j} buf[idx[r, j], c] / max(#valid, 1)
// An all-invalid row gives 0.
//
// Bound on Hopper: bytes: the buf rows the mailboxes reference, the
// index table and the output, over 3.35 TB/s; one add a element. The
// XLA form materialises the (rows, md, d) mailbox in device memory and
// reads it back; this kernel gathers and reduces in one pass, so the
// mailbox never exists. A thread owns one channel of one row and walks
// the row's md slots (the index is a broadcast load shared by the
// warp); a warp reads 32 neighbouring channels of a buf row, so loads
// coalesce. Invalid slots are skipped, never read.

#include "common.cuh"

__global__ void local_mean_kernel(const float* __restrict__ buf,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, int64_t rows,
                                  int md, int d, int64_t num_valid) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const int32_t* irow = idx + r * md;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
    int cnt = 0;
    for (int j = 0; j < md; ++j) {
      const int64_t src = irow[j];
      if (src < num_valid) {
        s += buf[src * d + c];
        ++cnt;
      }
    }
    out[r * d + c] = s / static_cast<float>(cnt > 0 ? cnt : 1);
  }
}

// buf: (num_valid + 1, d) float32, idx: (rows, md) int32,
// out: (rows, d) float32.
PRTP_EXPORT int local_mean_launch(const void* buf, const void* idx, void* out,
                                  int64_t rows, int md, int d,
                                  int64_t num_valid, void* stream) {
  if (rows == 0 || d == 0) return 0;
  const dim3 block = row_block(d, 256);
  const int64_t grid = (rows + block.y - 1) / block.y;
  local_mean_kernel<<<static_cast<unsigned>(grid), block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(buf), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, md, d, num_valid);
  return static_cast<int>(cudaGetLastError());
}
