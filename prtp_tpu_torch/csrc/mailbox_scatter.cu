// mailbox_scatter: a sorted unique-row segment sum added into a cotangent.
//
// Replaces two scatters of the walk's backward in
// prtp_tpu/ops/fused_gnn.py::_bwd, one kernel with two call sites:
// - intra (:264-272): `intra_add = segment_sum(d_mail_n.flat[intra_pos],
//   intra_slot)`, `g_c = dh[cell block] + intra_add`;
// - merged (:308-321): `uniq = segment_sum(cat([d_mail_c, d_mail_n])
//   [merged_pos], merged_seg)`, `dh = dh.at[merged_rows].add(uniq)`;
// and, under reduce_mode='segment', the transpose of the edge gathers
// `h[xs["cell_src"]]` and `h[xs["net_src"]]` (prtp_tpu/models/gnn.py:184,
// :200) that XLA's autodiff takes, on the packer's source-sorted edge
// tables with md_n = 1 (ops/segment_walk.py::_scatter_add): a net
// level's positions are destination slots (n_cell 0, d_pre_n the slots'
// cotangent, cnt_n net_cnt), a cell level's are edge ids into the
// per-edge cotangent passed as d_mail_c (n_cell = E); the edge-sharded
// step adds its summed compact buffer the same way, one entry a row.
// For each segment s (a CSR table: rows[s], entries
// [seg_off[s], seg_off[s+1]) of pos), in entry order:
//   dest[rows[s], c] += sum_e contrib(pos[e], c)
// where a position q < n_cell reads d_mail_c[q] (0 where d_mail_c is
// null: pair 0 has no cell cotangent) and q >= n_cell reads the net
// mailbox cotangent, which is never built: r = (q - n_cell) / md_n,
// contrib = d_pre_n[r, c] / cnt_n[r] (JAX's `d_pre_n / cnt` at a valid
// slot; cnt_n is the graph's net_cnt). The packer's rows are unique and
// sorted, so each destination row belongs to one segment: no atomics,
// and the sum's order is fixed.
//
// Bound on Hopper: bytes: each entry's source row and index, each
// segment's destination row read and written, over 3.35 TB/s; one add an
// element. At the headline design a training step makes 19 calls: the
// intra sums, 35,551 entries into 24,485 rows (ten pairs), and the merged
// sums, 70,789 entries into 57,968 rows (nine pairs): 43.8 MB and 96.4 MB,
// 42 us in all. But each call is small (17,324 segments at most, about
// two waves of warps), so it costs its launch and one chain of dependent
// loads, not its bytes. JAX materializes the gathered contributions
// (`cat[pos]`, 54.4 MB written and read again) and the segment sums
// before the add.
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one segment, one float4 of channels a lane (a whole warp
// at D = 128); every lane walks the segment's entries (a broadcast load
// of each position) and accumulates its channels in registers, then adds
// them into the destination row with one float4 load and store. D % 4 !=
// 0 or a pointer off 16-byte alignment takes the scalar path (N = 1).
// Issuing a segment's loads at once instead, its entries held in
// registers 4 at a time, made the kernel about 1% faster alone but not
// the walk backward (72 registers a thread against 40; PERF.md), so the
// entries load one after another.
//
// Launched as a programmatic dependent launch (common.cuh). Before
// grid_dep_wait() the kernel reads seg_off and rows: the graph's tables
// (or the edge shard's static iota), copied to the card when the design
// was packed or sharded and written by no kernel since. After it, pos and cnt_n (also graph tables), dest (a slice of
// the backward's dh carry), d_pre_n and d_mail_c, which the kernels just
// before this one write, and every store.

#include "common.cuh"

template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    mailbox_scatter_kernel(float* __restrict__ dest,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ seg_off,
                           const int32_t* __restrict__ pos,
                           const float* d_mail_c, const float* d_pre_n,
                           const float* __restrict__ cnt_n, int64_t segs,
                           int d, int64_t n_cell, int md_n, int group) {
  const RowLanes rl = row_lanes(group);
  if (rl.row >= segs) return;
  const int vecs = d / N;
  // ---- before the wait: the graph's tables only ----
  const int32_t begin = __ldg(seg_off + rl.row);
  const int32_t end = __ldg(seg_off + rl.row + 1);
  float* drow = dest + static_cast<int64_t>(__ldg(rows + rl.row)) * d;
  // ---- after the wait: the cotangents and every store ----
  grid_dep_wait();
  for (int c = rl.lane; c < vecs; c += group) {
    float acc[N] = {};
    for (int32_t e = begin; e < end; ++e) {
      const int64_t q = __ldg(pos + e);
      float x[N] = {};
      if (q < n_cell) {
        if (d_mail_c != nullptr) load_vec_cg<N>(d_mail_c + q * d + c * N, x);
      } else {
        const int64_t r = (q - n_cell) / md_n;
        const float cnt = __ldg(cnt_n + r);
        load_vec_cg<N>(d_pre_n + r * d + c * N, x);
#pragma unroll
        for (int i = 0; i < N; ++i) x[i] /= cnt;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += x[i];
    }
    float t[N];
    load_vec_cg<N>(drow + c * N, t);
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] += acc[i];
    store_vec<N>(drow + c * N, t);
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
  const bool vec4 = d % 4 == 0 && align % 16 == 0;
  const int vecs = vec4 ? d / 4 : d;
  const int group = lane_group(vecs);
  const unsigned grid = mailbox_grid(segs, group);
  const cudaError_t err =
      vec4 ? launch_programmatic(mailbox_scatter_kernel<4>, grid,
                                 kMailboxThreads, 0, s, dp, rp, op, pp, cp,
                                 np_, kp, segs, d, n_cell, md_n, group)
           : launch_programmatic(mailbox_scatter_kernel<1>, grid,
                                 kMailboxThreads, 0, s, dp, rp, op, pp, cp,
                                 np_, kp, segs, d, n_cell, md_n, group);
  return static_cast<int>(err);
}
