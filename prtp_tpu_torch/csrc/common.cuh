// Shared by the port's kernels. Each source builds into its own shared
// library with a plain C interface (loaded with ctypes): a launcher
// returns the cudaError_t of its launch, and error_string() turns that
// code into text for the Python wrapper's exception.
#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#define PRTP_EXPORT extern "C" __attribute__((visibility("default")))

PRTP_EXPORT const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Threads over a row's channels (x) and rows per block (y): a warp
// spans one row's contiguous channels, so loads and stores coalesce.
inline dim3 row_block(int64_t per_row, int threads = 256) {
  int tx = 32;
  while (tx < per_row && tx < threads) tx *= 2;
  if (per_row < 32) {
    tx = 1;
    while (tx < per_row) tx *= 2;
  }
  return dim3(tx, threads / tx);
}

__device__ __forceinline__ float nan_max(float acc, float x) {
  // jnp.max propagates NaN; fmaxf would drop it
  return (x > acc || x != x) ? x : acc;
}

// ---- the mailbox kernels' lane layout (softmax_sum, local_mean,
// softmax_sum_bwd, mailbox_scatter) ----
//
// A group of `group` lanes (a power of two, at most 32) covers one
// destination row (a segment, for mailbox_scatter), one vector of N
// floats per lane (N = 4: 16-byte loads; N = 1: the scalar path),
// looping while the row is wider than the group; a warp covers
// 32 / group neighbouring rows. A block is kMailboxThreads threads.

constexpr int kMailboxThreads = 128;

struct RowLanes {
  int64_t row;  // the destination row of this lane's group
  int lane;     // this lane's place in its group
};

// The lanes of block `block`'s rows (a kernel that loops over several
// blocks' rows passes each in turn), or of this block's.
__device__ __forceinline__ RowLanes row_lanes(int group, int64_t block) {
  const int64_t warp = (block * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  return {warp * (32 / group) + lane / group, lane & (group - 1)};
}

__device__ __forceinline__ RowLanes row_lanes(int group) {
  return row_lanes(group, blockIdx.x);
}

// Lanes of one group: the smallest power of two that covers `need`,
// at most 32.
inline int lane_group(int64_t need) {
  int g = 1;
  while (g < need && g < 32) g *= 2;
  return g;
}

inline unsigned mailbox_grid(int64_t rows, int group) {
  const int64_t rows_per_block = (kMailboxThreads / 32) * (32 / group);
  return static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]);

template <>
__device__ __forceinline__ void load_vec<4>(const float* p, float (&x)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

template <>
__device__ __forceinline__ void load_vec<1>(const float* p, float (&x)[1]) {
  x[0] = __ldg(p);
}

// load_vec for data another kernel may still be writing when this one
// starts (a programmatic dependent launch, below), read after
// grid_dep_wait(): through L2 (ld.global.cg), never from L1 or the
// read-only cache, which may hold lines from before the writer finished.
template <int N>
__device__ __forceinline__ void load_vec_cg(const float* p, float (&x)[N]);

template <>
__device__ __forceinline__ void load_vec_cg<4>(const float* p, float (&x)[4]) {
  const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

template <>
__device__ __forceinline__ void load_vec_cg<1>(const float* p, float (&x)[1]) {
  x[0] = __ldcg(p);
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]);

template <>
__device__ __forceinline__ void store_vec<4>(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

template <>
__device__ __forceinline__ void store_vec<1>(float* p, const float (&x)[1]) {
  p[0] = x[0];
}

// The first k <= KMAX slot indices of a row, in every lane of its group:
// lane j < k loads slot j once (the k loads of a row are contiguous) and
// the group shares them by shuffle. Needs k <= group, and every lane of
// the warp, those past the last row too, must call it.
template <int KMAX>
__device__ __forceinline__ void row_indices(const int32_t* __restrict__ idx,
                                            const RowLanes& rl, bool row_ok,
                                            int k, int group,
                                            int32_t (&src)[KMAX]) {
  const int32_t mine = (row_ok && rl.lane < k) ? idx[rl.row * k + rl.lane] : 0;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) src[j] = __shfl_sync(0xffffffffu, mine, j, group);
}

// The sum of v over the `group` lanes of this lane's group (a power of
// two, at most 32), in every lane of it: a butterfly of xor shuffles.
// Every step adds two values in either order, which rounds alike, so
// every lane gets the same bits. Every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float v, int group) {
  for (int off = group >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, group);
  return v;
}

// ---- programmatic dependent launch (sm_90) ----
//
// Its users: attn_sum, attn_bwd's two kernels (attn_bwd_rows,
// attn_dw_reduce), softmax_sum_bwd and mailbox_scatter. softmax_sum,
// local_mean, gather_rows and flat_adam launch plainly.
//
// Launched with cudaLaunchAttributeProgrammaticStreamSerialization, a
// kernel may start while the kernel before it on the stream drains: its
// blocks run up to grid_dep_wait(), which returns once every earlier
// kernel has finished and its writes are visible. Before the wait a
// kernel reads only what no kernel in flight writes (the graph's tables,
// the final node state hf, the weights, attn_sum's alpha in the
// backward); every other read and every store comes after. So a caller
// must not let the kernel just before it on the stream write what is
// read before the wait. Launched plainly, the wait returns at once.

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel<<<grid, block, smem, s>>>(args...) through
// cudaLaunchKernelEx, as a programmatic dependent launch. Returns the
// launch's error, else the last.
template <typename... Params, typename... Args>
cudaError_t launch_programmatic(void (*kernel)(Params...), dim3 grid,
                                dim3 block, size_t smem, cudaStream_t s,
                                Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return err != cudaSuccess ? err : last;
}
