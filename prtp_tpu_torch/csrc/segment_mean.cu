// segment_mean: the segment reduce's net-half mean over a level's flat
// edge table, read straight from the node state h.
//
// Replaces, for each level pair of the pair step under
// reduce_mode='segment' (prtp_tpu/models/gnn.py::_PairStep.__call__,
// :199-202), the edge gather `msg_n = h[xs["net_src"]]`,
// prtp_tpu/ops/segment.py::segment_sum (:29-30) and the division
// `sums / xs["net_cnt"][:, None]`. The (E, D) message table is never
// built. The edges are sorted by destination slot; slot s owns edges
// [off[s], off[s + 1]). For a slot s and a channel c:
//   out[s, c] = (sum_e h[src[e], c]) / cnt[s]
// summed in edge order; cnt is the graph's net_cnt (the in-degree, at
// least 1). With cnt null the kernel writes the sums: a rank of the
// edge-sharded step (prtp_tpu_torch/parallel/graph_shard.py) adds the
// ranks' partial sums before the division. An empty slot gives 0.
//
// Bound on Hopper: bytes: each distinct source row read once, the edge
// table, the offsets and the counts, and the (S, D) output written, over
// 3.35 TB/s; one add an element. chip_smoke.py (phase 11) prints the
// bound at the headline's shapes beside the kernel's time and
// F.embedding_bag's (mode "mean": the sum over the bag's size, 0 for an
// empty bag, the same function since cnt is the in-degree clamped at
// 1).
//
// Design: the lane layout of the mailbox reductions (common.cuh): a lane
// group covers one destination slot, one float4 of channels a lane (a
// whole warp at D = 128), walking the slot's edge range once (a net has
// one driver, so mostly one edge). D % 4 != 0 or a pointer off 16-byte
// alignment takes the scalar path (N = 1). Launched plainly.

#include "common.cuh"

template <int N>
__global__ void __launch_bounds__(kMailboxThreads)
    segment_mean_kernel(const float* __restrict__ h,
                        const int32_t* __restrict__ src,
                        const int32_t* __restrict__ off,
                        const float* __restrict__ cnt,
                        float* __restrict__ out, int64_t segs, int d,
                        int group) {
  const RowLanes rl = row_lanes(group);
  if (rl.row >= segs) return;
  const int vecs = d / N;
  const int32_t begin = __ldg(off + rl.row);
  const int32_t end = __ldg(off + rl.row + 1);
  const float n = cnt != nullptr ? __ldg(cnt + rl.row) : 1.f;
  for (int c = rl.lane; c < vecs; c += group) {
    float acc[N] = {}, x[N];
    for (int32_t e = begin; e < end; ++e) {
      load_vec<N>(h + static_cast<int64_t>(__ldg(src + e)) * d + c * N, x);
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += x[i];
    }
    if (cnt != nullptr) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] /= n;
    }
    store_vec<N>(out + rl.row * d + c * N, acc);
  }
}

// h: (> max(src), d) float32, src: (off[segs],) int32, off: (segs + 1,)
// int32 ascending, cnt: (segs,) float32 or null, out: (segs, d) float32.
PRTP_EXPORT int segment_mean_launch(const void* h, const void* src,
                                    const void* off, const void* cnt,
                                    void* out, int64_t segs, int d,
                                    void* stream) {
  if (segs == 0 || d == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* sp = static_cast<const int32_t*>(src);
  const int32_t* op = static_cast<const int32_t*>(off);
  const float* cp = static_cast<const float*>(cnt);
  float* outp = static_cast<float*>(out);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(out);
  const bool vec4 = d % 4 == 0 && align % 16 == 0;
  const int group = lane_group(vec4 ? d / 4 : d);
  const unsigned grid = mailbox_grid(segs, group);
  if (vec4)
    segment_mean_kernel<4><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, cp, outp, segs, d, group);
  else
    segment_mean_kernel<1><<<grid, kMailboxThreads, 0, s>>>(
        hp, sp, op, cp, outp, segs, d, group);
  return static_cast<int>(cudaGetLastError());
}
