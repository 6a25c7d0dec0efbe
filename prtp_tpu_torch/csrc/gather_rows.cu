// gather_rows: out[j, :] = h[idx[j], :]
//
// Replaces the Pallas row gather `gk` of scripts/gather_roofline.py
// (`pallas_gather`), which is the level walk's one global gather per
// level pair, `gat = h[b["gather_rows"]]` (prtp_tpu/ops/fused_gnn.py).
//
// Bound on Hopper: bytes. It does no arithmetic; it reads each gathered
// row once and writes it once, so the least time is (unique rows read +
// rows written) x row bytes over 3.35 TB/s. The TPU kernel copied each
// row's whole 8-row (8, 128) tile into VMEM by DMA and picked the row
// with a masked reduce, because single HBM rows are not DMA-able there.
// Device memory on Hopper has no such tiling: a row is fetched on its
// own, in 32-byte sectors. So the design is the plain one: a block
// holds a tile of destination rows (threadIdx.y), a warp copies one
// row's contiguous bytes in the widest vector the row and the pointers
// allow (16 bytes a thread where aligned), and the index is read once
// per row. Rows are independent; no shared memory, no synchronisation.
// Type-agnostic: it moves bytes, so f32 and bf16 rows share the kernel.

#include "common.cuh"

template <typename V>
__global__ void gather_rows_kernel(const V* __restrict__ h,
                                   const int32_t* __restrict__ idx,
                                   V* __restrict__ out, int64_t m,
                                   int64_t vec_per_row) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (r >= m) return;
  const V* src = h + static_cast<int64_t>(idx[r]) * vec_per_row;
  V* dst = out + r * vec_per_row;
  for (int64_t c = threadIdx.x; c < vec_per_row; c += blockDim.x) dst[c] = src[c];
}

template <typename V>
static int launch(const void* h, const void* idx, void* out, int64_t m,
                  int64_t row_bytes, cudaStream_t stream) {
  const int64_t vpr = row_bytes / static_cast<int64_t>(sizeof(V));
  const dim3 block = row_block(vpr);
  const int64_t grid = (m + block.y - 1) / block.y;
  gather_rows_kernel<V><<<static_cast<unsigned>(grid), block, 0, stream>>>(
      static_cast<const V*>(h), static_cast<const int32_t*>(idx),
      static_cast<V*>(out), m, vpr);
  return static_cast<int>(cudaGetLastError());
}

// h: (n, row_bytes) rows, idx: (m,) int32 in [0, n), out: (m, row_bytes).
PRTP_EXPORT int gather_rows_launch(const void* h, const void* idx, void* out,
                                   int64_t m, int64_t row_bytes, void* stream) {
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(row_bytes);
  if (align % 16 == 0) return launch<uint4>(h, idx, out, m, row_bytes, s);
  if (align % 8 == 0) return launch<uint2>(h, idx, out, m, row_bytes, s);
  if (align % 4 == 0) return launch<uint32_t>(h, idx, out, m, row_bytes, s);
  if (align % 2 == 0) return launch<uint16_t>(h, idx, out, m, row_bytes, s);
  return launch<uint8_t>(h, idx, out, m, row_bytes, s);
}
