// softmax_sum: the cell half's masked mailbox softmax-weighted sum.
//
// Replaces `_softmax_sum` of prtp_tpu/ops/fused_gnn.py (an XLA-level op
// of the level walk, run once per level pair k > 0). For a row r and a
// channel c, over the mailbox slots j with valid[r, j]:
//   mx  = max_j m[r, j, c]            (0 when no slot is valid or the
//                                      max is not finite: the isfinite
//                                      guard)
//   e_j = valid ? exp(m[r, j, c] - mx) : 0
//   w_j = e_j / max(sum_j e_j, 1e-12)
//   out[r, c] = sum_j w_j * m[r, j, c]
// An all-invalid row gives 0, never NaN.
//
// Bound on Hopper: bytes. Each mailbox element is read once and costs a
// few float operations (one exp), far below the f32 rate, so the least
// time is (m + valid + out) bytes over 3.35 TB/s. The design keeps the
// mailbox in registers: a thread owns one channel of one row, loads its
// md slots once (md <= 8 is unrolled into registers; the walk's cell
// mailboxes hold at most 4 slots at the headline), and makes the max,
// sum and weighted-sum passes on the registers. A warp reads 32
// neighbouring channels of a slot, so every load coalesces. The valid
// flags of a row are the same for all its channels (a broadcast load).
// Longer mailboxes take the generic path, which re-reads the slots
// (from L1) in each pass.

#include <math.h>

#include "common.cuh"

constexpr int kRegSlots = 8;

__device__ __forceinline__ float nan_max(float acc, float x) {
  // jnp.max propagates NaN; fmaxf would drop it
  return (x > acc || x != x) ? x : acc;
}

template <int KMAX>
__global__ void softmax_sum_kernel(const float* __restrict__ m,
                                   const uint8_t* __restrict__ valid,
                                   float* __restrict__ out, int64_t rows,
                                   int md, int d) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= rows) return;
  const float* base = m + r * md * d;
  const uint8_t* vrow = valid + r * md;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    const float* col = base + c;
    float mx = -INFINITY;
    float den = 0.f, acc = 0.f;
    if constexpr (KMAX > 0) {
      float v[KMAX];
      bool ok[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < md) {
          v[j] = col[static_cast<int64_t>(j) * d];
          ok[j] = vrow[j] != 0;
          if (ok[j]) mx = nan_max(mx, v[j]);
        }
      }
      if (!isfinite(mx)) mx = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (j < md) den += ok[j] ? expf(v[j] - mx) : 0.f;
      den = fmaxf(den, 1e-12f);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < md) {
          const float e = ok[j] ? expf(v[j] - mx) : 0.f;
          acc += (e / den) * v[j];
        }
      }
    } else {
      for (int j = 0; j < md; ++j)
        if (vrow[j]) mx = nan_max(mx, col[static_cast<int64_t>(j) * d]);
      if (!isfinite(mx)) mx = 0.f;
      for (int j = 0; j < md; ++j)
        den += vrow[j] ? expf(col[static_cast<int64_t>(j) * d] - mx) : 0.f;
      den = fmaxf(den, 1e-12f);
      for (int j = 0; j < md; ++j) {
        const float x = col[static_cast<int64_t>(j) * d];
        const float e = vrow[j] ? expf(x - mx) : 0.f;
        acc += (e / den) * x;
      }
    }
    out[r * d + c] = acc;
  }
}

// m: (rows, md, d) float32, valid: (rows, md) bool (one byte each),
// out: (rows, d) float32.
PRTP_EXPORT int softmax_sum_launch(const void* m, const void* valid, void* out,
                                   int64_t rows, int md, int d, void* stream) {
  if (rows == 0 || d == 0) return 0;
  const dim3 block = row_block(d, 256);
  const int64_t grid = (rows + block.y - 1) / block.y;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mp = static_cast<const float*>(m);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  float* op = static_cast<float*>(out);
  if (md <= kRegSlots)
    softmax_sum_kernel<kRegSlots><<<static_cast<unsigned>(grid), block, 0, s>>>(
        mp, vp, op, rows, md, d);
  else
    softmax_sum_kernel<0><<<static_cast<unsigned>(grid), block, 0, s>>>(
        mp, vp, op, rows, md, d);
  return static_cast<int>(cudaGetLastError());
}
