// The dense-layout screening kernels, templated on a row source
// (screen_sort.cuh): screen.cu instantiates them over float rows,
// dequant_screen.cu over int8 codeword rows.
//
// Grid (coordinate block, node): one block per (node j, 128 coordinates),
// one thread per coordinate.  Thread 0 compacts adj[j, :] into a neighbor
// list in shared memory; the row source stages what it needs of the listed
// rows (a codeword's scale pairs); each thread then gathers its column
// through the row source into a register array of N entries (the next power
// of two above the rows to sort), sorts it and reduces it.
#pragma once

#include <stdint.h>

#include "screen_sort.cuh"

namespace screen {

constexpr int kMaxRows = 128;  // largest N instantiated

// Thread 0 compacts node j's in-neighbor row into s_nbr and stores the
// count; every thread returns after the barrier.
__device__ __forceinline__ void load_neighbors(const uint8_t* __restrict__ adj, int m, int j,
                                               int* s_nbr, int* s_count) {
  if (threadIdx.x == 0) {
    int c = 0;
    const uint8_t* row = adj + static_cast<size_t>(j) * m;
    for (int i = 0; i < m; ++i) {
      if (row[i]) s_nbr[c++] = i;
    }
    *s_count = c;
  }
  __syncthreads();
}

template <int N, class Rows>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                          const float* __restrict__ self_vals, float* __restrict__ out, int m,
                          int d, int b, bool recip) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_count;
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y;
  load_neighbors(adj, m, j, s_nbr, &s_count);
  const int count = s_count;
  rows.stage(s_nbr, count, s_pair);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = CUDART_INF_F;
    if (i < count) v[i] = rows.load(s_pair, s_nbr[i], i, d, k);
  }
  bitonic_sort<N>(v);
  const size_t at = static_cast<size_t>(j) * d + k;
  out[at] = trimmed_mean_sorted<N>(v, count, b, self_vals[at], recip);
}

template <int N, class Rows>
__global__ void __launch_bounds__(kThreads)
median_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                    const float* __restrict__ self_vals, float* __restrict__ out, int m, int d) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_count;
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y;
  load_neighbors(adj, m, j, s_nbr, &s_count);
  const int count = s_count;
  rows.stage(s_nbr, count, s_pair);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const size_t at = static_cast<size_t>(j) * d + k;
  // the node's own (uncompressed) value joins as one more row
  const float own = sanitize(self_vals[at]);

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = i == count ? own : CUDART_INF_F;
    if (i < count) v[i] = rows.load(s_pair, s_nbr[i], i, d, k);
  }
  bitonic_sort<N>(v);
  out[at] = median_sorted<N>(v, count + 1);
}

// Launch over rows to sort: m for the trimmed mean, m + 1 for the median;
// cudaErrorInvalidValue above kMaxRows.
template <class Rows>
cudaError_t launch_trimmed_mean_dense(const Rows& rows, const uint8_t* adj,
                                      const float* self_vals, float* out, int m, int d, int b,
                                      bool recip, cudaStream_t s) {
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  if (m <= 16) {
    trimmed_mean_dense_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip);
  } else if (m <= 32) {
    trimmed_mean_dense_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip);
  } else if (m <= 64) {
    trimmed_mean_dense_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip);
  } else if (m <= 128) {
    trimmed_mean_dense_kernel<128, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                    d, b, recip);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Rows>
cudaError_t launch_median_dense(const Rows& rows, const uint8_t* adj, const float* self_vals,
                                float* out, int m, int d, cudaStream_t s) {
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  const int n = m + 1;
  if (n <= 16) {
    median_dense_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d);
  } else if (n <= 32) {
    median_dense_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d);
  } else if (n <= 64) {
    median_dense_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d);
  } else if (n <= 128) {
    median_dense_kernel<128, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace screen
