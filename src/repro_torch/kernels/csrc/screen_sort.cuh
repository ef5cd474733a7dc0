// Shared pieces of the coordinate-wise screening kernels (screen.cu,
// gather_screen.cu): the NaN guard and the register sorting network.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace screen {

constexpr int kThreads = 128;  // coordinates per block

__device__ __forceinline__ float sanitize(float x) {
  return isnan(x) ? CUDART_INF_F : x;
}

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
// to right, the node's own value added, the total divided (IEEE) by
// count - 2 b_eff + 1, with b_eff = min(b, (count - 1) / 2).
template <int N>
__device__ __forceinline__ float trimmed_mean_sorted(const float (&v)[N], int count, int b,
                                                     float own) {
  const int widest = count > 0 ? (count - 1) / 2 : 0;
  const int b_eff = min(max(b, 0), widest);
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (i >= b_eff && i < count - b_eff) total = __fadd_rn(total, v[i]);
  }
  total = __fadd_rn(total, own);
  return __fdiv_rn(total, static_cast<float>(count - 2 * b_eff + 1));
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
