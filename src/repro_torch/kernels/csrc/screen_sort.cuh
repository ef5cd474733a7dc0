// Shared pieces of the coordinate-wise screening kernels (screen.cu,
// dequant_screen.cu, gather_screen.cu): the NaN guard, the row sources a
// thread reads its column from, the register sorting network and the two
// reductions over a sorted column.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace screen {

constexpr int kThreads = 128;     // coordinates per block
constexpr int kScaleBlock = 128;  // coordinates per (scale, zero) pair of an int8 codeword
// A block of the codeword screens covers exactly one scale block, so every
// row has one pair per block, at index blockIdx.x.  The wrappers pass
// nblk = ceil(d / SCALE_BLOCK) from the Python side, and the entry points
// refuse any other, so a change to either constant fails loudly.
static_assert(kThreads == kScaleBlock, "a screening block must be one codeword scale block");
constexpr int kMaxStaged = 128;   // rows whose pairs a block stages (M <= 128, K <= 63)

__device__ __forceinline__ float sanitize(float x) {
  return isnan(x) ? CUDART_INF_F : x;
}

// Row sources: how a thread fetches the value of row `row` (the `slot`-th
// row of its node's list) at coordinate c.  The kernels are templates on
// them, so the float and the codeword screens share one sort and one
// reduction, and a codeword screen equals decode-then-screen by
// construction.
//
// Float rows: w[row * d + c], NaN -> +inf.
struct FloatRows {
  const float* w;
  static constexpr int kPairs = 1;  // nothing staged
  __device__ __forceinline__ void stage(const int*, int, float2*) const {}
  __device__ __forceinline__ float load(const float2*, int row, int, int d, int c) const {
    return sanitize(w[static_cast<size_t>(row) * d + c]);
  }
};

// int8 codeword rows: q[row * d + c] decoded as fma(q, scale, zero), one
// rounding as in dequant.cu, then NaN -> +inf.  `stage` copies the
// (scale, zero) pair of each listed row for this block's 128 coordinates
// into shared memory once; threads then read codes only.
struct CodewordRows {
  const int8_t* q;
  const float* scale;  // [rows, nblk, 2]
  int nblk;
  static constexpr int kPairs = kMaxStaged;
  __device__ __forceinline__ void stage(const int* rows, int n, float2* s_pair) const {
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const float* p = scale + (static_cast<size_t>(rows[t]) * nblk + blockIdx.x) * 2;
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

// Ascending bitonic sort of v[0..N) (N a power of two), fully unrolled, so
// every index is a compile-time constant and v stays in registers.
template <int N>
__device__ __forceinline__ void bitonic_sort(float (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const float lo = fminf(v[i], v[l]);
          const float hi = fmaxf(v[i], v[l]);
          if ((i & k) == 0) {
            v[i] = lo;
            v[l] = hi;
          } else {
            v[i] = hi;
            v[l] = lo;
          }
        }
      }
    }
  }
}

// Trimmed mean of a sorted column: ranks [b_eff, count - b_eff) summed left
// to right, the node's own value added, and the total divided (IEEE) by
// c = count - 2 b_eff + 1, with b_eff = min(b, (count - 1) / 2) — or, with
// `recip`, multiplied by the correctly rounded reciprocal of c, the form
// XLA folds a constant divisor into (ByRDiE's block screen).
template <int N>
__device__ __forceinline__ float trimmed_mean_sorted(const float (&v)[N], int count, int b,
                                                     float own, bool recip = false) {
  const int widest = count > 0 ? (count - 1) / 2 : 0;
  const int b_eff = min(max(b, 0), widest);
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= b_eff && i < count - b_eff) total = __fadd_rn(total, v[i]);
  }
  total = __fadd_rn(total, own);
  const float den = static_cast<float>(count - 2 * b_eff + 1);
  return recip ? __fmul_rn(total, __frcp_rn(den)) : __fdiv_rn(total, den);
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

}  // namespace screen
