// Shared pieces of the coordinate-wise screening kernels (screen.cu,
// dequant_screen.cu, gather_screen.cu, and the wide path of screen_wide.cuh):
// the NaN guard, the row sources a thread reads its column from, the
// register sorting networks and the two reductions over a sorted column.
//
// The networks are Batcher's odd-even merge sort over each bucket of row
// counts (8, 16, ..., 64, 80, ..., 128), generated by
// src/repro_torch/kernels/networks.py into screen_networks.cuh, which the
// build writes into its include directory: batcher_sort<N>(v) sorts
// v[0..N) ascending in registers, and for_bucket<NMAX>(rows, body) runs
// body(Bucket<N>{}) for the smallest bucket N that holds `rows`.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "screen_networks.cuh"

namespace screen {

constexpr int kThreads = 128;     // coordinates per block
constexpr int kScaleBlock = 128;  // coordinates per (scale, zero) pair of an int8 codeword
// A block of the dense register screens covers exactly one scale block, so
// every row has one pair per block, at index blockIdx.x.  The wrappers pass
// nblk = ceil(d / SCALE_BLOCK) from the Python side, and the entry points
// refuse any other, so a change to either constant fails loudly.
static_assert(kThreads == kScaleBlock, "a screening block must be one codeword scale block");
constexpr int kMaxStaged = 128;   // rows whose pairs a register block stages (M <= 128)

// NaN -> +inf, every other value unchanged: fminf returns its non-NaN
// operand, and min(x, +inf) == x for any other x (one instruction, where
// isnan(x) ? inf : x takes two).
__device__ __forceinline__ float sanitize(float x) { return fminf(x, CUDART_INF_F); }

// Row sources: how a thread fetches the value of row `row` (the `slot`-th
// row of its node's list) at coordinate c.  The kernels are templates on
// them, so the float and the codeword screens share one sort and one
// reduction, and a codeword screen equals decode-then-screen by
// construction.  `stage` copies what a block needs of its n listed rows
// for the codec scale block `blk` into shared memory (kStaged: whether
// there is anything to copy) and ends in a barrier.
//
// `at(j)` binds a source to node j: the views' base for mailbox views,
// the source itself for rows every node shares.  `experiment(e)` binds it
// to experiment e of a launch over an experiment axis: its rows start s_exp
// elements (s_exp_pairs floats of scale pairs) after the previous
// experiment's; 0, the default, for a launch over one experiment.
//
// Float rows: w[row * d + c], NaN -> +inf.
struct FloatRows {
  const float* w;
  long long s_exp = 0;
  static constexpr bool kStaged = false;
  static constexpr int kPairs = 1;  // nothing staged
  __device__ __forceinline__ FloatRows at(int) const { return *this; }
  __device__ __forceinline__ FloatRows experiment(int e) const {
    return FloatRows{w + e * s_exp, s_exp};
  }
  __device__ __forceinline__ void stage(const int*, int, float2*, int) const {}
  __device__ __forceinline__ float load(const float2*, int row, int, int d, int c) const {
    return sanitize(w[static_cast<size_t>(row) * d + c]);
  }
};

// int8 codeword rows: q[row * d + c] decoded as fma(q, scale, zero), one
// rounding as in dequant.cu, then NaN -> +inf.  `stage` copies the
// (scale, zero) pair of each listed row for the block's scale block into
// shared memory once (kPairs of them in the register kernels' static array,
// as many as the list holds in the wide path's dynamic one); threads then
// read codes only.
struct CodewordRows {
  const int8_t* q;
  const float* scale;  // [rows, nblk, 2]
  int nblk;
  long long s_exp = 0, s_exp_pairs = 0;
  static constexpr bool kStaged = true;
  static constexpr int kPairs = kMaxStaged;
  __device__ __forceinline__ CodewordRows at(int) const { return *this; }
  __device__ __forceinline__ CodewordRows experiment(int e) const {
    return CodewordRows{q + e * s_exp, scale + e * s_exp_pairs, nblk, s_exp, s_exp_pairs};
  }
  __device__ __forceinline__ void stage(const int* rows, int n, float2* s_pair, int blk) const {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* p = scale + (static_cast<size_t>(rows[t]) * nblk + blk) * 2;
      s_pair[t] = make_float2(p[0], p[1]);
    }
    __syncthreads();
  }
  __device__ __forceinline__ float load(const float2* s_pair, int row, int slot, int d,
                                        int c) const {
    const float2 sz = s_pair[slot];
    const float qf = static_cast<float>(q[static_cast<size_t>(row) * d + c]);
    return sanitize(__fmaf_rn(qf, sz.x, sz.y));
  }
};

// Mailbox views [M, W, d] of the network runtime: node j's slot k at
// coordinate c is v[j s_recv + k s_slot + c], strides in elements, computed
// with no index loaded.  s_recv may be 0 (a broadcast expanded over the
// receivers), every node then reading the same views in place.  ViewRows is
// the source a kernel takes, NodeViews one node's, which the row of a list
// (the slot) indexes.
struct NodeViews {
  const float* v;  // the node's views
  long long s_slot;
  static constexpr bool kStaged = false;
  __device__ __forceinline__ void stage(const int*, int, float2*, int) const {}
  __device__ __forceinline__ float load(const float2*, int row, int, int, int c) const {
    return sanitize(v[row * s_slot + c]);
  }
};

struct ViewRows {
  const float* v;
  long long s_recv, s_slot;
  long long s_exp = 0;
  static constexpr bool kStaged = false;
  static constexpr int kPairs = 1;  // nothing staged
  __device__ __forceinline__ NodeViews at(int j) const {
    return NodeViews{v + j * s_recv, s_slot};
  }
  __device__ __forceinline__ ViewRows experiment(int e) const {
    return ViewRows{v + e * s_exp, s_recv, s_slot, s_exp};
  }
  __device__ __forceinline__ void stage(const int*, int, float2*, int) const {}
};

// The experiment axis of a launch: `count` experiments, experiment e on its
// own rows (the row source's experiment(e)), its own self values and
// outputs ([E, M, d] contiguous: e M d elements in), its own Byzantine
// bound b[e] (a null b gives every experiment the launch's scalar b) and
// its own adjacency or table mask, s_mask bytes after the previous one's
// (0: one mask every experiment shares, as a grid shares its topology;
// [E, M, M] or [E, M, K] for Bulyan's per-experiment selections).  The
// default is one experiment, the screens' unbatched form.
struct Experiments {
  int count = 1;
  long long s_mask = 0;
  const int* b = nullptr;
  __device__ __forceinline__ int b_of(int e, int b0) const { return b != nullptr ? b[e] : b0; }
};
constexpr int kMaxExperiments = 65535;  // a grid dimension


// Trimmed mean of a sorted column: ranks [b_eff, count - b_eff) summed left
// to right, the node's own value added, and the total divided (IEEE) by
// c = count - 2 b_eff + 1, with b_eff = min(b, (count - 1) / 2) — or, with
// `recip`, multiplied by the correctly rounded reciprocal of c, the form
// XLA folds a constant divisor into (ByRDiE's block screen).
__device__ __forceinline__ int trim_width(int count, int b) {
  const int widest = count > 0 ? (count - 1) / 2 : 0;
  return min(max(b, 0), widest);
}

// (kept total + own) / (count - 2 b_eff + 1), IEEE, or times its reciprocal.
__device__ __forceinline__ float trimmed_mean_finish(float total, float own, int count, int b_eff,
                                                     bool recip) {
  total = __fadd_rn(total, own);
  const float den = static_cast<float>(count - 2 * b_eff + 1);
  return recip ? __fmul_rn(total, __frcp_rn(den)) : __fdiv_rn(total, den);
}

template <int N>
__device__ __forceinline__ float trimmed_mean_sorted(const float (&v)[N], int count, int b,
                                                     float own, bool recip = false) {
  const int b_eff = trim_width(count, b);
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= b_eff && i < count - b_eff) total = __fadd_rn(total, v[i]);
  }
  return trimmed_mean_finish(total, own, count, b_eff, recip);
}

// trimmed_mean_sorted over exactly N rows: rank i is kept when b_eff <=
// min(i, N - 1 - i), one compare a rank.
template <int N>
__device__ __forceinline__ float trimmed_mean_exact(const float (&v)[N], int b, float own,
                                                    bool recip = false) {
  const int b_eff = trim_width(N, b);
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (b_eff <= (i < N - 1 - i ? i : N - 1 - i)) total = __fadd_rn(total, v[i]);
  }
  return trimmed_mean_finish(total, own, N, b_eff, recip);
}

// Median of a sorted column of `rows` values: 0.5 * (o[(rows-1)/2] + o[rows/2]).
template <int N>
__device__ __forceinline__ float median_sorted(const float (&v)[N], int rows) {
  const int lo = (rows - 1) / 2;
  const int hi = rows / 2;
  float a = 0.0f, c = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == lo) a = v[i];
    if (i == hi) c = v[i];
  }
  return __fmul_rn(0.5f, __fadd_rn(a, c));
}

// The decisions a decide launch records beside its output (the decide form
// of the dense and the tile kernels): per (experiment e, node j, slot s)
// the number of columns c with c % stride == 0 on which the row in slot s
// fell outside its column's kept window [lo, hi] (ties kept), summed into
// counts[(e M + j) width + s], int32, zeroed by the caller.  Integer sums
// make the counts independent of the order the blocks add them in.  A slot
// is a sender on the dense layout (width M), a table slot or a view's slot
// on the sparse ones (width K or W).
struct Decide {
  int* counts = nullptr;
  int width = 0;
  int stride = 1;
};

// v[r] of a register column (r uniform or not; one select a rank).
template <int N>
__device__ __forceinline__ float rank_of(const float (&v)[N], int r) {
  float x = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i == r) x = v[i];
  }
  return x;
}

// The kept window of a sorted column (or one median_select left): the
// trimmed mean's ranks b_eff and max(count - b_eff - 1, b_eff) over its
// `count` rows; the median's two middle ranks over its `rows` (count + 1,
// the node's own value included).
template <int N>
__device__ __forceinline__ float2 trim_window(const float (&v)[N], int count, int b) {
  const int b_eff = trim_width(count, b);
  return make_float2(rank_of<N>(v, b_eff), rank_of<N>(v, max(count - b_eff - 1, b_eff)));
}

template <int N>
__device__ __forceinline__ float2 median_window(const float (&v)[N], int rows) {
  return make_float2(rank_of<N>(v, (rows - 1) / 2), rank_of<N>(v, rows / 2));
}

// Whether a listed row's value x is outside the window w = (lo, hi).
__device__ __forceinline__ bool outside(float x, float2 w) { return !(x >= w.x && x <= w.y); }

// Columns a decide form keeps unsorted in registers beside its sort (a
// bucket of at most this many rows), deciding without re-reading the rows;
// above, it re-reads each listed row (L2-resident).
constexpr int kDecideRegs = 32;

// A warp's trimmed-column counts of up to ROWS listed rows, held by its
// lanes: lane l owns rows l, l + 32, ..; `add` gives row `row` the count
// `n` (a popc of the row's ballot, uniform over the warp), `flush` adds
// each lane's counts into the block's shared sums with one atomic a lane
// and a nonzero count (in place of one atomic a row by a single lane).
template <int ROWS>
struct LaneCounts {
  static constexpr int kWords = (ROWS + 31) / 32;
  int a[kWords] = {};
  __device__ __forceinline__ void add(int row, int n, int lane) {
    if (lane == (row & 31)) {
#pragma unroll
      for (int r = 0; r < kWords; ++r) {
        if ((row >> 5) == r) a[r] += n;
      }
    }
  }
  __device__ __forceinline__ void flush(int* s_trim, int lane) const {
#pragma unroll
    for (int r = 0; r < kWords; ++r) {
      if (a[r] != 0) atomicAdd(s_trim + 32 * r + lane, a[r]);
    }
  }
};

// One column's decisions into a warp's LaneCounts: for each of the `count`
// listed rows, the ballot of the lanes whose column is `counted` and whose
// value lies outside the window.  `kept` holds the unsorted column (rows
// < count) where N <= kDecideRegs; above, `reread(i)` loads row i again.
template <int N, int ROWS, class Reread>
__device__ __forceinline__ void decide_column(LaneCounts<ROWS>& lanes, const float (&kept)[N],
                                              int count, float2 window, bool counted, int lane,
                                              Reread reread) {
  if constexpr (N <= kDecideRegs) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i < count) {
        lanes.add(i, __popc(__ballot_sync(0xffffffffu, counted && outside(kept[i], window))),
                  lane);
      }
    }
  } else {
    for (int i = 0; i < count; ++i) {
      lanes.add(i, __popc(__ballot_sync(0xffffffffu, counted && outside(reread(i), window))),
                lane);
    }
  }
}

}  // namespace screen
