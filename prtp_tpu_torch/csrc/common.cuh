// Shared by the port's kernels. Each source builds into its own shared
// library with a plain C interface (loaded with ctypes): a launcher
// returns the cudaError_t of its launch, and error_string() turns that
// code into text for the Python wrapper's exception.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
// softmax_sum_bwd, mailbox_scatter; the segment kernels too) ----
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

// ---- the --attn kernels' scores (attn_sum, segment_attn_sum and its
// backward): one function, so that all of them sum a score alike ----

// The scores of NH heads (a power of two) from each lane's NH partial
// scores p, reduced over the `group` lanes in one pass: on return this
// lane holds the full score of its own head, lane / (group / NH). At
// each xor step a lane keeps the half of the heads on its side of the
// step's bit and adds the partner's partials of them (NH - 1 shuffles in
// all); a butterfly over the head's group / NH lanes ends it, so every
// lane of a head gets the same bits. Every lane of the warp must call it.
template <int NH>
__device__ __forceinline__ float head_scores(float (&p)[NH], int lane,
                                             int group) {
  int off = group >> 1;
#pragma unroll
  for (int cnt = NH; cnt > 1; cnt >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int i = 0; i < cnt / 2; ++i) {
      const float keep = upper ? p[i + cnt / 2] : p[i];
      const float send = upper ? p[i] : p[i + cnt / 2];
      p[i] = keep + __shfl_xor_sync(0xffffffffu, send, off, group);
    }
    off >>= 1;
  }
  return group_sum(p[0], group / NH);
}

// ---- the segment reduce's softmax (segment_softmax_sum and its
// backward) ----
//
// A slot s owns the edges [off[s], off[s + 1]) of a destination-sorted
// edge table; its rows are h[src[e]] in edge order. Per channel, over
// them: the shift mx (the max; NaN if any is NaN; 0 when not finite, so
// an empty slot's is 0), den = sum exp(x - mx) and num = sum exp(x - mx)
// * x, each summed in edge order; the output num / max(den, 1e-12). The
// forward and the backward both compute these through the functions
// below, so the backward's recomputed shift, denominator and output are
// the forward's bits.

// The register path's width: a slot of at most kSlotRows edges has its
// indices shared by shuffle, every row load issued before any
// arithmetic and its rows kept in registers; a wider slot takes the
// generic path, kSlotRows rows at a time. An 8-row register path needs
// more registers a thread (fewer warps an SM) for every slot of a level:
// it was slower at the headline and no faster where a twentieth of a
// level's slots have 5-8 edges (PERF.md §6).
constexpr int kSlotRows = 4;

template <int N>
__device__ __forceinline__ void softmax_begin(float (&mx)[N], float (&den)[N],
                                              float (&num)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mx[i] = -INFINITY;
    den[i] = num[i] = 0.f;
  }
}

template <int N>
__device__ __forceinline__ void softmax_max(float (&mx)[N],
                                            const float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mx[i] = nan_max(mx[i], x[i]);
}

// The isfinite guard: after the last softmax_max.
template <int N>
__device__ __forceinline__ void softmax_shift(float (&mx)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    if (!isfinite(mx[i])) mx[i] = 0.f;
}

// Adds one row x to den and num.
template <int N>
__device__ __forceinline__ void softmax_add(const float (&mx)[N],
                                            const float (&x)[N],
                                            float (&den)[N], float (&num)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float e = expf(x[i] - mx[i]);
    den[i] += e;
    num[i] += e * x[i];
  }
}

__device__ __forceinline__ float softmax_out(float num, float den) {
  return num / fmaxf(den, 1e-12f);
}

// Loads the row at p into x: through L2 (load_vec_cg) for data read
// after a programmatic launch's wait (CG), else load_vec.
template <int N, bool CG>
__device__ __forceinline__ void load_row(const float* p, float (&x)[N]) {
  if (CG)
    load_vec_cg<N>(p, x);
  else
    load_vec<N>(p, x);
}

// The slot's first min(deg, kSlotRows) rows h[idx[j]] (slot_edges) at
// channel offset col into x, every load issued before any use.
template <int N, bool CG>
__device__ __forceinline__ void load_head(const float* h,
                                          const int32_t (&idx)[kSlotRows],
                                          int deg, int d, int col,
                                          float (&x)[kSlotRows][N]) {
#pragma unroll
  for (int j = 0; j < kSlotRows; ++j)
    if (j < deg) load_row<N, CG>(h + static_cast<int64_t>(idx[j]) * d + col, x[j]);
}

// The rows h[src[j + i]], i < n <= kSlotRows, at channel offset col into
// x[i]: each lane loads the n indices itself (one address across its
// group), then every row load is issued before any use.
template <int N, bool CG>
__device__ __forceinline__ void load_rows(const float* h,
                                          const int32_t* __restrict__ src,
                                          int32_t j, int n, int d, int col,
                                          float (&x)[kSlotRows][N]) {
  int32_t idx[kSlotRows];
#pragma unroll
  for (int i = 0; i < kSlotRows; ++i) idx[i] = i < n ? __ldg(src + j + i) : 0;
#pragma unroll
  for (int i = 0; i < kSlotRows; ++i)
    if (i < n) load_row<N, CG>(h + static_cast<int64_t>(idx[i]) * d + col, x[i]);
}

// The softmax of slot [begin, begin + deg) at channel offset col, its
// first rows loaded from idx (slot_edges). A slot of at most kSlotRows
// edges (the register path) loads each row once and leaves its rows in
// x. A wider one (the generic path) walks its edge range twice (the max,
// then the sums), kSlotRows rows at a time (load_rows), through the same
// x. One x for both paths, and loops that stay loops (unroll 1), keep
// the generic path from needing more registers than the register path.
template <int N, bool CG>
__device__ __forceinline__ void slot_softmax(const float* h,
                                             const int32_t* __restrict__ src,
                                             int32_t begin, int deg,
                                             const int32_t (&idx)[kSlotRows],
                                             int d, int col,
                                             float (&x)[kSlotRows][N],
                                             float (&mx)[N], float (&den)[N],
                                             float (&num)[N]) {
  const int32_t end = begin + deg;
  load_head<N, CG>(h, idx, deg, d, col, x);
  softmax_begin<N>(mx, den, num);
#pragma unroll
  for (int j = 0; j < kSlotRows; ++j)
    if (j < deg) softmax_max<N>(mx, x[j]);
#pragma unroll 1
  for (int32_t j = begin + kSlotRows; j < end; j += kSlotRows) {
    const int n = min(kSlotRows, end - j);
    load_rows<N, CG>(h, src, j, n, d, col, x);
#pragma unroll
    for (int i = 0; i < kSlotRows; ++i)
      if (i < n) softmax_max<N>(mx, x[i]);
  }
  softmax_shift<N>(mx);
  if (deg <= kSlotRows) {
#pragma unroll
    for (int j = 0; j < kSlotRows; ++j)
      if (j < deg) softmax_add<N>(mx, x[j], den, num);
    return;
  }
#pragma unroll 1
  for (int32_t j = begin; j < end; j += kSlotRows) {
    const int n = min(kSlotRows, end - j);
    load_rows<N, CG>(h, src, j, n, d, col, x);
#pragma unroll
    for (int i = 0; i < kSlotRows; ++i)
      if (i < n) softmax_add<N>(mx, x[i], den, num);
  }
}

// A slot's edge range [begin, begin + deg) of the CSR offsets off and,
// when deg <= kSlotRows, its source indices src[begin + j] in every lane
// of its group: lanes 0 and 1 load off[s] and off[s + 1], lane j < deg
// loads index j (the slot's indices are contiguous), and the group
// shares them by shuffle. Needs kSlotRows <= group; every lane of the
// warp, those past the last slot too, must call it. A lane past the last
// slot gets deg 0.
__device__ __forceinline__ int slot_edges(const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ off,
                                          const RowLanes& rl, bool row_ok,
                                          int group, int32_t& begin,
                                          int32_t (&idx)[kSlotRows]) {
  const int32_t o = (row_ok && rl.lane < 2) ? __ldg(off + rl.row + rl.lane) : 0;
  begin = __shfl_sync(0xffffffffu, o, 0, group);
  const int deg = __shfl_sync(0xffffffffu, o, 1, group) - begin;
  const int32_t mine = (rl.lane < deg && rl.lane < kSlotRows)
                           ? __ldg(src + begin + rl.lane)
                           : 0;
#pragma unroll
  for (int j = 0; j < kSlotRows; ++j)
    idx[j] = __shfl_sync(0xffffffffu, mine, j, group);
  return deg;
}

// ---- the segment reduce's attention (segment_attn_sum and its
// backward, --attn) ----
//
// A slot s owns the edges [off[s], off[s + 1]) of a destination-sorted
// edge table; its rows are x_e = h[src[e]] in edge order. Head g of nh
// owns the channels [g D / nh, (g + 1) D / nh). Per head, over the slot's
// edges: the score s_eg = <x_e, w[g]> over the WHOLE row; the shift mx_g
// (the max; NaN if any is NaN; 0 when not finite, so an empty slot's is
// 0); den_g = sum exp(s_eg - mx_g) and, on head g's channels, num =
// sum exp(s_eg - mx_g) x_e, each summed in edge order; the output num /
// max(den_g, 1e-12). The forward and the backward compute these through
// the functions below, so the backward's recomputed statistics are the
// forward's bits.
//
// Two paths. Heads together (attn_heads_together: D % 4 == 0, D / 4 a
// power of two from kSlotRows to 32 float4s, nh a power of two dividing
// it): a lane group of exactly D / 4 lanes covers a slot, one float4 a
// lane, head g's lanes the group / nh from g group / nh; head_scores()
// reduces every head's score in one pass, and a slot of up to kSlotRows
// edges keeps its rows and scores in registers; a wider slot is walked
// once, its shift a running max (slot_attn). Otherwise the per-head
// loop: per head, walks over the slot's edges, each score a full-group
// sum, a lane's channels re-read from L1.
//
// A warp holds 32 / group slots whose degrees differ, and a score sums
// over its group by shuffles in which every lane of the warp takes part,
// so every loop over a slot's edges runs to the warp's largest degree
// (wdeg, one __reduce_max_sync), masked by the slot's own.

// Whether the heads-together path serves nh heads at vecs float4s a row.
inline bool attn_heads_together(int vecs, int nh) {
  const auto pow2 = [](int v) { return v > 0 && (v & (v - 1)) == 0; };
  return pow2(vecs) && vecs >= kSlotRows && vecs <= 32 && pow2(nh) &&
         vecs % nh == 0;
}

// Heads together: fc_attn2's weights w (nh, d) as a lane reads them,
// its float4 at column col of each head's row. The forward keeps them in
// registers (RegWeights, NH x 4 a lane: fewer instructions a score,
// measured faster); the backward, which holds d_w's NH x 4 a lane too,
// reads the block's copy in shared memory (SharedWeights). Both give the
// same values to the same arithmetic, so the same bits.
template <int NH>
struct RegWeights {
  float v[NH][4];
  __device__ __forceinline__ RegWeights(const float* __restrict__ w, int d,
                                        int col) {
#pragma unroll
    for (int g = 0; g < NH; ++g)
      load_vec<4>(w + static_cast<int64_t>(g) * d + col, v[g]);
  }
  __device__ __forceinline__ void get(int g, float (&o)[4]) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = v[g][k];
  }
};

struct SharedWeights {
  const float* p;  // the block's copy of w, at this lane's column
  int d;
  __device__ __forceinline__ void get(int g, float (&o)[4]) const {
    const float4 t = *reinterpret_cast<const float4*>(p + g * d);
    o[0] = t.x;
    o[1] = t.y;
    o[2] = t.z;
    o[3] = t.w;
  }
};

// Heads together: the NH scores of the float4 x of this lane's row,
// summed over the group (head_scores: this lane gets its own head's).
template <int NH, class W>
__device__ __forceinline__ float attn_score(const float (&x)[4], const W& w,
                                            int lane, int group) {
  float p[NH];
#pragma unroll
  for (int gg = 0; gg < NH; ++gg) {
    float v[4];
    w.get(gg, v);
    p[gg] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) p[gg] += x[i] * v[i];
  }
  return head_scores<NH>(p, lane, group);
}

// Heads together: the rows j0 + i, i < kSlotRows, of slot [begin, begin +
// deg) at channel offset col into x (0 past the slot's last edge; chunk 0
// from idx, slot_edges, unless FROM_SRC), every load issued before any
// use, and their scores into s (those past the warp's wdeg 0). Every
// lane of the warp calls it with the same j0.
template <int NH, bool CG, bool FROM_SRC = false, class W>
__device__ __forceinline__ void attn_chunk(const float* h,
                                           const int32_t* __restrict__ src,
                                           const int32_t (&idx)[kSlotRows],
                                           int32_t begin, int deg, int wdeg,
                                           int j0, int d, int col, const W& w,
                                           int lane, int group,
                                           float (&x)[kSlotRows][4],
                                           float (&s)[kSlotRows]) {
  const int n = min(kSlotRows, deg - j0);
  if (j0 == 0 && !FROM_SRC)
    load_head<4, CG>(h, idx, deg, d, col, x);
  else
    load_rows<4, CG>(h, src, begin + j0, n, d, col, x);
#pragma unroll
  for (int i = 0; i < kSlotRows; ++i) {
    if (i >= n) {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[i][k] = 0.f;
    }
    s[i] = j0 + i < wdeg ? attn_score<NH>(x[i], w, lane, group) : 0.f;
  }
}

// Heads together: the slot's shift mx, denominator den (this lane's
// head's) and this lane's float4 of the numerator, in one walk over its
// edges, kSlotRows rows at a time (each row loaded and scored once).
// The shift is the running max with JAX's guard (NaN once any score is
// NaN, so the guard makes it 0, as for an empty slot); where a chunk
// moves it, the sums so far are rescaled by exp(old shift - new shift)
// before the chunk's exps are added. A slot of at most kSlotRows edges
// (the register path) is one chunk: the two-pass max-then-sums. On
// return x and s hold chunk 0 if wdeg <= kSlotRows, else the last chunk.
template <int NH, bool CG, class W>
__device__ __forceinline__ void slot_attn(const float* h,
                                          const int32_t* __restrict__ src,
                                          const int32_t (&idx)[kSlotRows],
                                          int32_t begin, int deg, int wdeg,
                                          int d, int col, const W& w,
                                          int lane, int group,
                                          float (&x)[kSlotRows][4],
                                          float (&s)[kSlotRows], float& mx,
                                          float& den, float (&num)[4]) {
  float top = -INFINITY;  // the running max
  mx = 0.f;               // its guarded value, the exps' shift
  den = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) num[k] = 0.f;
#pragma unroll 1
  for (int j0 = 0; j0 == 0 || j0 < wdeg; j0 += kSlotRows) {
    attn_chunk<NH, CG>(h, src, idx, begin, deg, wdeg, j0, d, col, w, lane,
                       group, x, s);
    float next = top;
#pragma unroll
    for (int i = 0; i < kSlotRows; ++i)
      if (j0 + i < deg) next = nan_max(next, s[i]);
    const float shift = isfinite(next) ? next : 0.f;
    if (j0 > 0) {  // rescale the sums to the new shift (1: exact)
      const float r = top == -INFINITY ? 0.f : expf(mx - shift);
      den *= r;
#pragma unroll
      for (int k = 0; k < 4; ++k) num[k] *= r;
    }
    top = next;
    mx = shift;
#pragma unroll
    for (int i = 0; i < kSlotRows; ++i) {
      if (j0 + i < deg) {
        const float e = expf(s[i] - mx);
        den += e;
#pragma unroll
        for (int k = 0; k < 4; ++k) num[k] += e * x[i][k];
      }
    }
  }
}

// The per-head loop: head g's score of the row src_row (valid), this
// lane's products over its vectors, summed over the group. Every lane of
// the warp must call it.
template <int N, bool CG>
__device__ __forceinline__ float loop_score(const float* h,
                                            const float* __restrict__ w,
                                            int32_t src_row, bool valid,
                                            int g, int d, int lane,
                                            int group) {
  float part = 0.f;
  if (valid) {
    for (int c = lane; c < d / N; c += group) {
      float x[N], wv[N];
      load_row<N, CG>(h + static_cast<int64_t>(src_row) * d + c * N, x);
      load_vec<N>(w + static_cast<int64_t>(g) * d + c * N, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) part += x[i] * wv[i];
    }
  }
  return group_sum(part, group);
}

// The per-head loop: head g's shift mx and denominator den over the
// slot's edges (two walks, the edges to the warp's wdeg). Every lane of
// the warp must call it.
template <int N, bool CG>
__device__ __forceinline__ void loop_stats(const float* h,
                                           const int32_t* __restrict__ src,
                                           const float* __restrict__ w,
                                           int32_t begin, int deg, int wdeg,
                                           int g, int d, int lane, int group,
                                           float& mx, float& den) {
  mx = -INFINITY;
#pragma unroll 1
  for (int j = 0; j < wdeg; ++j) {
    const bool valid = j < deg;
    const int32_t r = valid ? __ldg(src + begin + j) : 0;
    const float sc = loop_score<N, CG>(h, w, r, valid, g, d, lane, group);
    if (valid) mx = nan_max(mx, sc);
  }
  if (!isfinite(mx)) mx = 0.f;
  den = 0.f;
#pragma unroll 1
  for (int j = 0; j < wdeg; ++j) {
    const bool valid = j < deg;
    const int32_t r = valid ? __ldg(src + begin + j) : 0;
    const float sc = loop_score<N, CG>(h, w, r, valid, g, d, lane, group);
    if (valid) den += expf(sc - mx);
  }
}

// The per-head loop: head g's numerator at vector c of the row (for
// every channel of it: the caller keeps head g's), over the slot's
// edges; 0 unless `mine`. Every lane of the warp must call it.
template <int N, bool CG>
__device__ __forceinline__ void loop_numer(const float* h,
                                           const int32_t* __restrict__ src,
                                           const float* __restrict__ w,
                                           int32_t begin, int deg, int wdeg,
                                           int g, float mx, int d, int c,
                                           bool mine, int lane, int group,
                                           float (&num)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) num[k] = 0.f;
#pragma unroll 1
  for (int j = 0; j < wdeg; ++j) {
    const bool valid = j < deg;
    const int32_t r = valid ? __ldg(src + begin + j) : 0;
    const float sc = loop_score<N, CG>(h, w, r, valid, g, d, lane, group);
    if (valid && mine) {
      float x[N];
      load_row<N, CG>(h + static_cast<int64_t>(r) * d + c * N, x);
      const float e = expf(sc - mx);
#pragma unroll
      for (int k = 0; k < N; ++k) num[k] += e * x[k];
    }
  }
}

// The per-head loop: the float vectors of a row that hold channels of
// head g: [v0, v1).
__device__ __forceinline__ void head_vectors(int g, int dh, int n, int& v0,
                                             int& v1) {
  v0 = g * dh / n;
  v1 = ((g + 1) * dh + n - 1) / n;
}

// ---- the net half's update (segment_mean's update mode) ----
//
// The walk's net half writes each net slot s's row of h as
//   h[n0 + s] = has_in[s] ? relu(pre[s] + mean[s]) : relu(h[n0 + s])
// (prtp_tpu/models/gnn.py:200-204 with _masked_update), where PyTorch
// runs `+`, F.relu twice, torch.where and the copy into h as five
// kernels. These functions do the same float operations in the same
// order, so the result has the unfused composition's bits on the card.
// The mailbox walk's local_mean (ops/fused_gnn.py) is followed by the
// same five ops and could end in them too.

// torch.relu of a float as PyTorch's CUDA clamp_min computes it: a NaN
// is returned as it is (its payload kept), anything else is
// max(v, 0.f) (the same max instruction, so the same sign of zero).
__device__ __forceinline__ float torch_relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

// A row with in-edges: x = relu(pre + x), x holding the slot's mean.
template <int N>
__device__ __forceinline__ void update_row(const float (&pre)[N],
                                           float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = torch_relu(pre[i] + x[i]);
}

// A row without in-edges (has_in false): x = relu(x), x its old value.
template <int N>
__device__ __forceinline__ void keep_row(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = torch_relu(x[i]);
}

// ---- programmatic dependent launch (sm_90) ----
//
// Its users: attn_sum, attn_bwd's two kernels (attn_bwd_rows,
// attn_dw_reduce), softmax_sum_bwd, mailbox_scatter,
// segment_softmax_sum, segment_softmax_sum_bwd, segment_mean (its
// three modes), segment_attn_sum and segment_attn_bwd's two kernels (its
// rows kernel a pair, its d_w reduce once a backward).
// softmax_sum, local_mean, gather_rows and flat_adam launch plainly.
//
// Launched with cudaLaunchAttributeProgrammaticStreamSerialization, a
// kernel may start while the kernel before it on the stream drains: its
// blocks run up to grid_dep_wait(), which returns once every earlier
// kernel has finished and its writes are visible. Before the wait a
// kernel reads only what no kernel in flight writes (the graph's tables,
// the final node state hf, the weights, attn_sum's alpha in the
// backward, the segment backwards' saved slot statistics); every other
// read and every store comes after. So a caller
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

// ---- fc_attn2's gradient without float atomics (attn_bwd and
// segment_attn_bwd) ----
//
// Each block of the rows kernel sums its edges' (or slots') shares of
// d_w in a fixed order into its own row of a workspace (blocks, nh, D);
// then one small kernel adds the rows in row order (dw_reduce). Every
// sum has a fixed order, so a call gives the same bits every time.

// Starts copying n floats (a multiple of 4, both ends 16-byte aligned)
// from src in device memory to dst in shared memory, by the block's
// threads, through L2 (cp.async.cg: never a line in L1 from before the
// writer finished), without holding registers; copy_async_wait() waits
// for this thread's copies (a barrier then makes all of them visible).
__device__ __forceinline__ void copy_async(const float* src, float* dst,
                                           int n) {
  for (int i = threadIdx.x * 4; i < n; i += blockDim.x * 4) {
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to),
                 "l"(src + i)
                 : "memory");
  }
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

constexpr int kReduceLanes = 32;  // dw_reduce: partial sums an element
constexpr int kMaxShare = 232448;  // bytes of shared memory a block may use

// Adds the tile's rows of `share` ((rows of the tile, n): the rows'
// shares of n elements of d_w), in row order, to the block's partial
// sums `part` (n floats, this block's alone, in shared or global
// memory); `part` is overwritten if `first`. Every thread of the block
// calls it between two barriers.
__device__ __forceinline__ void add_share(float* part,
                                          const float* __restrict__ share,
                                          int n, int tile_rows, bool first) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float sum = first ? 0.f : part[c];
    for (int r = 0; r < tile_rows; ++r) sum += share[r * n + c];
    part[c] = sum;
  }
}

// The body of a reduce kernel launched as (elems / 32 rounded up) blocks
// of 32 x kReduceLanes threads: d_w[e] = the partial sums partial[b, e]
// of rows b < blocks, added in row order (lane y sums rows y, y + 32,
// ... in order, then lane 0 sums the 32 partial sums in order), once
// the kernel before it has finished.
__device__ __forceinline__ void dw_reduce(const float* partial,
                                          float* __restrict__ d_w,
                                          int blocks, int elems) {
  __shared__ float part[kReduceLanes][32];
  grid_dep_wait();
  const int e = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (e < elems) {
#pragma unroll 8
    for (int b = threadIdx.y; b < blocks; b += kReduceLanes)
      acc += __ldcg(partial + static_cast<int64_t>(b) * elems + e);
  }
  part[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < elems) {
    float sum = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceLanes; ++y) sum += part[y][threadIdx.x];
    d_w[e] = sum;
  }
}
