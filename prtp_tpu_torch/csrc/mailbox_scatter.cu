// mailbox_scatter: a sorted unique-row segment sum added into a cotangent.
//
// Replaces two scatters of the walk's backward in
// prtp_tpu/ops/fused_gnn.py::_bwd, one kernel with two call sites:
// - intra (:264-272): `intra_add = segment_sum(d_mail_n.flat[intra_pos],
//   intra_slot)`, `g_c = dh[cell block] + intra_add`;
// - merged (:308-321): `uniq = segment_sum(cat([d_mail_c, d_mail_n])
//   [merged_pos], merged_seg)`, `dh = dh.at[merged_rows].add(uniq)`.
// For each segment s (a CSR table: rows[s], entries
// [seg_off[s], seg_off[s+1]) of pos), in entry order:
//   dest[rows[s], c] += sum_e contrib(pos[e], c)
// where a position q < n_cell reads d_mail_c[q] (0 where d_mail_c is
// null: pair 0 has no cell cotangent) and q >= n_cell reads the net
// mailbox cotangent, which is never built: r = (q - n_cell) / md_n,
// contrib = d_pre_n[r, c] / cnt_n[r] (JAX's `d_pre_n / cnt` at a valid
// slot). The packer's rows are unique and sorted, so each destination row
// belongs to one segment: no atomics, and the sum's order is fixed.
//
// Bound on Hopper: bytes: each entry's source row and index, each
// segment's destination row read and written, over 3.35 TB/s; one add an
// element. At the headline design a training step makes 19 calls: the
// intra sums, 35,551 entries into 24,485 rows (ten pairs), and the merged
// sums, 70,789 entries into 57,968 rows (nine pairs): 43.8 MB and 96.4 MB,
// 42 us in all. JAX materializes the gathered contributions (`cat[pos]`,
// 54.4 MB written and read again) and the segment sums before the add.
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one segment, one float4 of channels a lane (a whole warp
// at D = 128); every lane walks the segment's entries (a broadcast load
// of each position) and accumulates its channels in registers, then adds
// them into the destination row with one float4 load and store. D % 4 !=
// 0 or a pointer off 16-byte alignment takes the scalar path (N = 1).

#include "common.cuh"

template <int N>
__device__ __forceinline__ void add_into(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    float4 t = *reinterpret_cast<float4*>(p);
    t.x += x[0];
    t.y += x[1];
    t.z += x[2];
    t.w += x[3];
    *reinterpret_cast<float4*>(p) = t;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] += x[i];
  }
}

template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    mailbox_scatter_kernel(float* __restrict__ dest,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ seg_off,
                           const int32_t* __restrict__ pos,
                           const float* __restrict__ d_mail_c,
                           const float* __restrict__ d_pre_n,
                           const float* __restrict__ cnt_n, int64_t segs,
                           int d, int64_t n_cell, int md_n, int group) {
  const RowLanes rl = row_lanes(group);
  if (rl.row >= segs) return;
  const int vecs = d / N;
  const int32_t begin = __ldg(seg_off + rl.row);
  const int32_t end = __ldg(seg_off + rl.row + 1);
  float* drow = dest + static_cast<int64_t>(__ldg(rows + rl.row)) * d;
  for (int c = rl.lane; c < vecs; c += group) {
    float acc[N] = {};
    for (int32_t e = begin; e < end; ++e) {
      const int64_t q = __ldg(pos + e);
      float x[N] = {};
      if (q < n_cell) {
        if (d_mail_c != nullptr) load_vec<N>(d_mail_c + q * d + c * N, x);
      } else {
        const int64_t r = (q - n_cell) / md_n;
        const float cnt = __ldg(cnt_n + r);
        load_vec<N>(d_pre_n + r * d + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] /= cnt;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += x[i];
    }
    add_into<N>(drow + c * N, acc);
  }
}

// dest: (> max(rows), d) float32, rows: (segs,) unique int32,
// seg_off: (segs + 1,) int32, pos: (seg_off[segs],) int32, d_mail_c:
// (n_cell, d) float32 or null, d_pre_n: (pn_n, d) float32, cnt_n: (pn_n,)
// float32, with (pos - n_cell) / md_n < pn_n for every net position.
PRTP_EXPORT int mailbox_scatter_launch(void* dest, const void* rows,
                                       const void* seg_off, const void* pos,
                                       const void* d_mail_c,
                                       const void* d_pre_n, const void* cnt_n,
                                       int64_t segs, int d, int64_t n_cell,
                                       int md_n, void* stream) {
  if (segs == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dp = static_cast<float*>(dest);
  const int32_t* rp = static_cast<const int32_t*>(rows);
  const int32_t* op = static_cast<const int32_t*>(seg_off);
  const int32_t* pp = static_cast<const int32_t*>(pos);
  const float* cp = static_cast<const float*>(d_mail_c);
  const float* np_ = static_cast<const float*>(d_pre_n);
  const float* kp = static_cast<const float*>(cnt_n);
  const uintptr_t align = reinterpret_cast<uintptr_t>(dest) |
                          reinterpret_cast<uintptr_t>(d_mail_c) |
                          reinterpret_cast<uintptr_t>(d_pre_n);
  if (d % 4 == 0 && align % 16 == 0) {
    const int group = lane_group(d / 4);
    mailbox_scatter_kernel<4><<<mailbox_grid(segs, group), kMailboxThreads, 0,
                                s>>>(dp, rp, op, pp, cp, np_, kp, segs, d,
                                     n_cell, md_n, group);
  } else {
    const int group = lane_group(d);
    mailbox_scatter_kernel<1><<<mailbox_grid(segs, group), kMailboxThreads, 0,
                                s>>>(dp, rp, op, pp, cp, np_, kp, segs, d,
                                     n_cell, md_n, group);
  }
  return static_cast<int>(cudaGetLastError());
}
