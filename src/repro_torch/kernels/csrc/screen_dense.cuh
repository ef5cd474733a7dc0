// The dense-layout screening kernels, templated on a row source
// (screen_sort.cuh): screen.cu instantiates them over float rows,
// dequant_screen.cu over int8 codeword rows.
//
// Grid (coordinate block, node): one block per (node j, 128 coordinates),
// one thread per coordinate.  The block compacts adj[j, :] into a neighbor
// list in shared memory in parallel (one adjacency entry a thread, a
// __ballot_sync per warp and __popc prefix counts, so the list keeps
// ascending sender order); the row source stages what it needs of the
// listed rows (a codeword's scale pairs).  The row count to sort (count for
// the trimmed mean, count + 1 for the median) is then known to the whole
// block, which picks the smallest network bucket that holds it
// (for_bucket, a block-uniform branch: no divergence); each thread gathers
// its column into a register array of that bucket's size, sorts it with
// Batcher's network for the bucket (screen_networks.cuh) and reduces it.
// NMAX, the largest bucket a kernel compiles, comes from M on the host.
#pragma once

#include <stdint.h>

#include "screen_sort.cuh"

namespace screen {

constexpr int kMaxRows = kMaxNetworkRows;  // rows a dense screen sorts, at most
constexpr int kWarps = kThreads / 32;
static_assert(kMaxRows <= kThreads, "one adjacency entry a thread");

// Compacts node j's in-neighbor row into s_nbr (ascending sender order) and
// returns the count to every thread of the block.
__device__ __forceinline__ int load_neighbors(const uint8_t* __restrict__ adj, int m, int j,
                                              int* s_nbr, int* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool on = t < m && adj[static_cast<size_t>(j) * m + t] != 0;
  const unsigned votes = __ballot_sync(0xffffffffu, on);
  if (lane == 0) s_warp[warp] = __popc(votes);
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    count += c;
  }
  if (on) s_nbr[before + __popc(votes & ((1u << lane) - 1u))] = t;
  __syncthreads();
  return count;
}

// v[i] = the listed row i's value at coordinate k for i < count, +inf after.
template <int N, class Rows>
__device__ __forceinline__ void load_column(float (&v)[N], const Rows& rows, const float2* s_pair,
                                            const int* s_nbr, int count, int d, int k) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = CUDART_INF_F;
    if (i < count) v[i] = rows.load(s_pair, s_nbr[i], i, d, k);
  }
}

// Experiment blockIdx.z of the launch (screen_sort.cuh, Experiments):
// its rows, self values, outputs, b and adjacency.
template <int NMAX, class Rows>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                          const float* __restrict__ self_vals, float* __restrict__ out, int m,
                          int d, int b, bool recip, Experiments ex) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_warp[kWarps];
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y, e = blockIdx.z;
  const Rows src = rows.experiment(e);
  const int count = load_neighbors(adj + e * ex.s_mask, m, j, s_nbr, s_warp);
  src.stage(s_nbr, count, s_pair, blockIdx.x);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const size_t at = (static_cast<size_t>(e) * m + j) * d + k;
  const int be = ex.b_of(e, b);
  for_bucket<NMAX>(count, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    load_column<N>(v, src, s_pair, s_nbr, count, d, k);
    batcher_sort<N>(v);
    out[at] = trimmed_mean_sorted<N>(v, count, be, self_vals[at], recip);
  });
}

template <int NMAX, class Rows>
__global__ void __launch_bounds__(kThreads)
median_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                    const float* __restrict__ self_vals, float* __restrict__ out, int m, int d,
                    Experiments ex) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_warp[kWarps];
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y, e = blockIdx.z;
  const Rows src = rows.experiment(e);
  const int count = load_neighbors(adj + e * ex.s_mask, m, j, s_nbr, s_warp);
  src.stage(s_nbr, count, s_pair, blockIdx.x);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const size_t at = (static_cast<size_t>(e) * m + j) * d + k;
  // the node's own (uncompressed) value joins as one more row
  const float own = sanitize(self_vals[at]);
  for_bucket<NMAX>(count + 1, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    load_column<N>(v, src, s_pair, s_nbr, count, d, k);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == count) v[i] = own;
    }
    batcher_sort<N>(v);
    out[at] = median_sorted<N>(v, count + 1);
  });
}

// Launch over rows to sort: m for the trimmed mean, m + 1 for the median,
// with the kernel compiled for the next power of two (NMAX), which holds
// every bucket a block of this launch can pick, and ex.count experiments
// along gridDim.z; cudaErrorInvalidValue above kMaxRows or
// kMaxExperiments.
template <class Rows>
cudaError_t launch_trimmed_mean_dense(const Rows& rows, const uint8_t* adj,
                                      const float* self_vals, float* out, int m, int d, int b,
                                      bool recip, cudaStream_t s,
                                      const Experiments& ex = Experiments{}) {
  if (ex.count < 1 || ex.count > kMaxExperiments) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m, ex.count);
  if (m <= 16) {
    trimmed_mean_dense_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip, ex);
  } else if (m <= 32) {
    trimmed_mean_dense_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip, ex);
  } else if (m <= 64) {
    trimmed_mean_dense_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                   d, b, recip, ex);
  } else if (m <= kMaxRows) {
    trimmed_mean_dense_kernel<128, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m,
                                                                    d, b, recip, ex);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Rows>
cudaError_t launch_median_dense(const Rows& rows, const uint8_t* adj, const float* self_vals,
                                float* out, int m, int d, cudaStream_t s,
                                const Experiments& ex = Experiments{}) {
  if (ex.count < 1 || ex.count > kMaxExperiments) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m, ex.count);
  const int n = m + 1;
  if (n <= 16) {
    median_dense_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d, ex);
  } else if (n <= 32) {
    median_dense_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d, ex);
  } else if (n <= 64) {
    median_dense_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d, ex);
  } else if (n <= kMaxRows) {
    median_dense_kernel<128, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out, m, d, ex);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace screen
