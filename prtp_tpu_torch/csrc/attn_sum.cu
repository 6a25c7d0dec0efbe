// attn_sum: the --attn cell half's multi-head attention mailbox reduce, read
// straight from the node state h.
//
// Replaces, for each level pair k > 0 of the walk in
// prtp_tpu/ops/fused_gnn.py::_forward_impl, the cell mailbox's part of
// the merged gather `gat = h[b["gather_rows"]]` (:171, :178) and
// `_attn_sum(m_c, valid, params["fc_attn2"]["kernel"], nh)` (:90-108,
// called at :179-181). The mailbox `m[r, j] = h[idx[r, j]]` is never
// built. A slot is valid when idx[r, j] != num_rows (the dummy row) and an
// invalid slot is never read. w is fc_attn2's weight in torch's layout,
// (nh, D): JAX's kernel transposed. For a row r and a head g, over the
// valid slots j (the score takes the WHOLE row, as JAX's
// einsum("pmd,dh->pmh")):
//   s_j  = sum_c m[r, j, c] * w[g, c]
//   mx   = max_j s_j (NaN if any is NaN, as jnp.max; then 0 when it is
//          not finite: the isfinite guard)
//   a_jg = exp(s_j - mx) / max(sum_j exp(s_j - mx), 1e-12)
//          (0 at an invalid slot; NaN everywhere if the sum is NaN, as
//          jnp.maximum keeps a NaN)
//   out[r, c] = sum_j a_jg * m[r, j, c]   for the channels c of head g,
//               g = c / (D / nh) (GAT concat)
// and, if alpha is given, alpha[r, j, g] = a_jg (0 at an invalid slot),
// which the backward reads. An all-invalid row gives 0, never NaN. (JAX
// also multiplies each invalid slot's weight 0 by the dummy row, which
// changes nothing while that row is finite, as the walk's is.)
//
// Bound on Hopper: bytes. At the headline design (79,991 nodes, pairs
// 1-9) the cell mailboxes hold 113,016 slots, 70,789 valid, 57,968
// distinct rows: 29.7 MB of distinct rows, 0.45 MB of indices and 14.5
// MB of output, 44.6 MB a forward, 13.3 us at 3.35 TB/s; alpha adds 0.45
// MB a head. The scores add 2 D nh flop a valid slot (18 MFLOP at nh =
// 1), far below the f32 rate. Each call is small (10,359 rows at most),
// so its launch and its chain of dependent loads cost more than its
// bytes.
//
// Design: the lane layout of softmax_sum (common.cuh): a lane group
// covers one row, one float4 of channels a lane (a whole warp at
// D = 128), the row's k indices loaded once by k lanes and shared by
// shuffle. For k <= 8 and at most 32 float4s a row, every valid slot's
// 16-byte load is issued at once and kept in registers.
//
// Heads together (NH > 0): where nh is a power of two, D / nh a multiple
// of 4 and the group is exactly D / 4 lanes, head g's channels are the
// group / nh contiguous lanes from g * group / nh, and one reduction pass
// serves every head. For each slot each lane dots its float4 with all nh
// heads' slices of w; head_scores() halves the nh partial scores at each
// xor step (send the other half of the heads to the partner lane, keep
// and add this half: nh - 1 shuffles), then a butterfly over the head's
// own lanes (group_sum) leaves each lane the full score of its own head,
// the same bits in all of that head's lanes: 6 shuffles a slot at nh = 4
// and D = 128, against 20 for four full-warp sums. Each lane then runs
// its own head's softmax only (k exps) and the head's lanes store its
// alpha, slot by slot. At nh = 1 this is one full-group sum a slot.
// The other shapes keep the per-head loop (NH == 0): nh group sums a
// slot, each lane runs every head's softmax and keeps its channels'
// (a float4 that spans heads, D / nh < 4, takes each channel's own head).
// k > 8 or more than 32 float4s a row takes a generic path: per head
// three passes over the slots (max, denominator, weighted sum into out).
// D % 4 != 0 or a pointer off 16-byte alignment takes the scalar path
// (N = 1).
//
// Launched as a programmatic dependent launch (common.cuh): before
// grid_dep_wait() the kernel reads idx and w (the graph's table and a
// weight that no kernel of the walk writes); the rows of h, which the
// forward walk's kernels just before it write, after. (The backward's
// recompute reads the final state hf, which could be read before the
// wait too; on the H100 that moved the walk backward by less than its
// noise, PERF.md §6, so both read h after it.)

#include <math.h>

#include "common.cuh"

// max(den, 1e-12) as jnp.maximum takes it: a NaN stays NaN (fmaxf would
// return 1e-12), so that alpha is NaN wherever JAX's is.
__device__ __forceinline__ float floor_den(float den) {
  return den < 1e-12f ? 1e-12f : den;
}

// This lane's part of the score of slot src for head g: its channels'
// products with w's, summed over its vectors, then over the group.
template <int N>
__device__ __forceinline__ float slot_score(const float* h,
                                            const float* __restrict__ w,
                                            int32_t src, bool valid, int g,
                                            int d, const RowLanes& rl,
                                            int group) {
  float part = 0.f;
  if (valid) {
    for (int c = rl.lane; c < d / N; c += group) {
      float x[N], wv[N];
      load_vec_cg<N>(h + static_cast<int64_t>(src) * d + c * N, x);
      load_vec<N>(w + static_cast<int64_t>(g) * d + c * N, wv);
#pragma unroll
      for (int i = 0; i < N; ++i) part += x[i] * wv[i];
    }
  }
  return group_sum(part, group);
}

// The rows of the slots of one row, loaded at once (0 where not ok).
template <int N, int KMAX>
__device__ __forceinline__ void load_slots(const float* h,
                                           const int32_t (&src)[KMAX],
                                           const bool (&ok)[KMAX], bool mine,
                                           int c, int d, float (&x)[KMAX][N]) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (ok[j] && mine) {
      load_vec_cg<N>(h + static_cast<int64_t>(src[j]) * d + c * N, x[j]);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) x[j][i] = 0.f;
    }
  }
}

// KMAX > 0: the register path for k <= KMAX and d / N <= group; NH > 0
// (N == 4, group == d / 4, nh == NH): its heads together; NH == 0: any
// nh. KMAX == 0: any k and d.
template <int N, int KMAX, int NH>
__global__ void __launch_bounds__(kMailboxThreads)
    attn_sum_kernel(const float* h, const int32_t* __restrict__ idx,
                    const float* __restrict__ w, float* __restrict__ out,
                    float* __restrict__ alpha, int64_t rows, int k, int d,
                    int nh, int num_rows, int group) {
  const RowLanes rl = row_lanes(group);
  const bool row_ok = rl.row < rows;
  [[maybe_unused]] const int dh = d / nh;
  // no lane returns before the last shuffle: every lane of the warp
  // takes part in the group sums
  if constexpr (KMAX > 0 && NH > 0) {
    int32_t src[KMAX];
    row_indices<KMAX>(idx, rl, row_ok, k, group, src);
    bool ok[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) ok[j] = row_ok && j < k && src[j] != num_rows;
    const int c = rl.lane;  // this lane's float4 of channels
    const int lanes = group / NH;  // a head's lanes
    const int g = c / lanes;       // this lane's head
    float wv[NH][N];
#pragma unroll
    for (int gg = 0; gg < NH; ++gg)
      load_vec<N>(w + static_cast<int64_t>(gg) * d + c * N, wv[gg]);
    grid_dep_wait();
    float x[KMAX][N];
    load_slots<N, KMAX>(h, src, ok, true, c, d, x);
    float s[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      float p[NH];
#pragma unroll
      for (int gg = 0; gg < NH; ++gg) {
        p[gg] = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) p[gg] += x[j][i] * wv[gg][i];
      }
      s[j] = head_scores<NH>(p, c, group);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (ok[j]) mx = nan_max(mx, s[j]);
    if (!isfinite(mx)) mx = 0.f;
    float a[KMAX];
    float den = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      a[j] = ok[j] ? expf(s[j] - mx) : 0.f;
      den += a[j];
    }
    den = floor_den(den);
#pragma unroll
    for (int j = 0; j < KMAX; ++j) a[j] = a[j] / den;
    if (!row_ok) return;
    if (alpha != nullptr) {
      // the head's lanes store its weights, one slot each in turn
      for (int jj = c - g * lanes; jj < k; jj += lanes) {
        float mine_a = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == jj) mine_a = a[j];
        alpha[(rl.row * k + jj) * NH + g] = mine_a;
      }
    }
    float res[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (ok[j]) acc += a[j] * x[j][i];
      res[i] = acc;
    }
    store_vec<N>(out + rl.row * d + c * N, res);
  } else if constexpr (KMAX > 0) {
    int32_t src[KMAX];
    row_indices<KMAX>(idx, rl, row_ok, k, group, src);
    bool ok[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) ok[j] = row_ok && j < k && src[j] != num_rows;
    const int c = rl.lane;  // this lane's vector of channels
    const bool mine = c < d / N;
    grid_dep_wait();
    float x[KMAX][N];
    load_slots<N, KMAX>(h, src, ok, mine, c, d, x);
    float res[N];
#pragma unroll
    for (int i = 0; i < N; ++i) res[i] = 0.f;
    for (int g = 0; g < nh; ++g) {
      float wv[N];
      if (mine) {
        load_vec<N>(w + static_cast<int64_t>(g) * d + c * N, wv);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) wv[i] = 0.f;
      }
      float s[KMAX];
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) part += x[j][i] * wv[i];
        s[j] = group_sum(part, group);
      }
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KMAX; ++j)
        if (ok[j]) mx = nan_max(mx, s[j]);
      if (!isfinite(mx)) mx = 0.f;
      float a[KMAX];
      float den = 0.f;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        a[j] = ok[j] ? expf(s[j] - mx) : 0.f;
        den += a[j];
      }
      den = floor_den(den);
#pragma unroll
      for (int j = 0; j < KMAX; ++j) a[j] = a[j] / den;
      if (alpha != nullptr && row_ok && rl.lane < k) {
        float mine_a = 0.f;
#pragma unroll
        for (int j = 0; j < KMAX; ++j)
          if (j == rl.lane) mine_a = a[j];
        alpha[(rl.row * k + rl.lane) * nh + g] = mine_a;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        if ((c * N + i) / dh == g) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < KMAX; ++j)
            if (ok[j]) acc += a[j] * x[j][i];
          res[i] = acc;
        }
      }
    }
    if (row_ok && mine) store_vec<N>(out + rl.row * d + c * N, res);
  } else {
    grid_dep_wait();
    const int32_t* irow = idx + (row_ok ? rl.row : 0) * k;
    for (int g = 0; g < nh; ++g) {
      float mx = -INFINITY;
      for (int j = 0; j < k; ++j) {
        const bool valid = row_ok && irow[j] != num_rows;
        const float s = slot_score<N>(h, w, irow[j], valid, g, d, rl, group);
        if (valid) mx = nan_max(mx, s);
      }
      if (!isfinite(mx)) mx = 0.f;
      float den = 0.f;
      for (int j = 0; j < k; ++j) {
        const bool valid = row_ok && irow[j] != num_rows;
        const float s = slot_score<N>(h, w, irow[j], valid, g, d, rl, group);
        if (valid) den += expf(s - mx);
      }
      den = floor_den(den);
      // this head's channels: out[r, c] = sum_j a_jg m[r, j, c]
      float* orow = out + rl.row * d;
      if (row_ok)
        for (int c = rl.lane * N; c < d; c += group * N)
          for (int i = 0; i < N; ++i)
            if ((c + i) / dh == g) orow[c + i] = 0.f;
      for (int j = 0; j < k; ++j) {
        const bool valid = row_ok && irow[j] != num_rows;
        const float s = slot_score<N>(h, w, irow[j], valid, g, d, rl, group);
        const float a = (valid ? expf(s - mx) : 0.f) / den;
        if (alpha != nullptr && row_ok && rl.lane == 0)
          alpha[(rl.row * k + j) * nh + g] = a;
        if (!valid) continue;
        const float* hrow = h + static_cast<int64_t>(irow[j]) * d;
        for (int c = rl.lane * N; c < d; c += group * N) {
          float x[N];
          load_vec_cg<N>(hrow + c, x);
          for (int i = 0; i < N; ++i)
            if ((c + i) / dh == g) orow[c + i] += a * x[i];
        }
      }
    }
  }
}

// every instantiation has the same parameters
using AttnSumKernel = decltype(&attn_sum_kernel<1, 0, 0>);

// The register path's kernel for nh heads: heads together where they
// may be, else the per-head loop.
template <int N, int KMAX>
static AttnSumKernel register_kernel(int nh, bool together) {
  if constexpr (N == 4) {
    if (together) {
      switch (nh) {
        case 1: return &attn_sum_kernel<4, KMAX, 1>;
        case 2: return &attn_sum_kernel<4, KMAX, 2>;
        case 4: return &attn_sum_kernel<4, KMAX, 4>;
        case 8: return &attn_sum_kernel<4, KMAX, 8>;
        case 16: return &attn_sum_kernel<4, KMAX, 16>;
        case 32: return &attn_sum_kernel<4, KMAX, 32>;
        default: break;
      }
    }
  }
  return &attn_sum_kernel<N, KMAX, 0>;
}

template <int N>
static cudaError_t launch(const float* h, const int32_t* idx, const float* w,
                          float* out, float* alpha, int64_t rows, int k,
                          int d, int nh, int num_rows, cudaStream_t s) {
  const int vecs = d / N;
  const bool regs = k <= 8 && vecs <= 32;
  const int group = lane_group(regs && k > vecs ? k : vecs);
  const unsigned grid = mailbox_grid(rows, group);
  // heads together: each head's channels are whole float4s of lanes of
  // their own, nh a power of two
  const bool together = group == vecs && nh <= vecs && vecs % nh == 0 &&
                        (nh & (nh - 1)) == 0;
  const AttnSumKernel kernel =
      !regs     ? &attn_sum_kernel<N, 0, 0>
      : k <= 4  ? register_kernel<N, 4>(nh, together)
                : register_kernel<N, 8>(nh, together);
  return launch_programmatic(kernel, grid, kMailboxThreads, 0, s, h, idx, w,
                             out, alpha, rows, k, d, nh, num_rows, group);
}

// h: (> num_rows, d) float32, idx: (rows, k) int32 with values in
// [0, num_rows], w: (nh, d) float32 with nh dividing d, out: (rows, d)
// float32, alpha: (rows, k, nh) float32 or null.
PRTP_EXPORT int attn_sum_launch(const void* h, const void* idx, const void* w,
                                void* out, void* alpha, int64_t rows, int k,
                                int d, int nh, int num_rows, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (nh < 1 || d % nh != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* hp = static_cast<const float*>(h);
  const int32_t* ip = static_cast<const int32_t*>(idx);
  const float* wp = static_cast<const float*>(w);
  float* op = static_cast<float*>(out);
  float* ap = static_cast<float*>(alpha);
  const uintptr_t align = reinterpret_cast<uintptr_t>(h) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  const cudaError_t err =
      d % 4 == 0 && align % 16 == 0
          ? launch<4>(hp, ip, wp, op, ap, rows, k, d, nh, num_rows, s)
          : launch<1>(hp, ip, wp, op, ap, rows, k, d, nh, num_rows, s);
  return static_cast<int>(err);
}
