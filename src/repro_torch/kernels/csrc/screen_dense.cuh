// The dense-layout screening kernels, templated on a row source
// (screen_sort.cuh): screen.cu instantiates them over float rows,
// dequant_screen.cu over int8 codeword rows.
//
// Each kernel has a decide form (kDecide, the trust layer's and the
// trace's forensics): the same output, bit for bit, and the per-edge
// decisions of screen_sort.cuh's Decide.
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

// The decide form's record (kDecide), after the block's columns decided
// into their warps' LaneCounts (screen_sort.cuh, decide_column): the lanes'
// counts summed in shared memory, then one integer atomicAdd a listed row
// into dec.counts (screen_sort.cuh, Decide).
template <int NMAX>
__device__ __forceinline__ void record_decisions(const LaneCounts<NMAX>& lanes, const int* s_nbr,
                                                 int count, int* s_trim, const Decide& dec,
                                                 size_t row0) {
  lanes.flush(s_trim, threadIdx.x & 31);
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += kThreads) {
    if (s_trim[i] != 0) atomicAdd(dec.counts + row0 + s_nbr[i], s_trim[i]);
  }
}

// Experiment blockIdx.z of the launch (screen_sort.cuh, Experiments):
// its rows, self values, outputs, b and adjacency.  kDecide: the decide
// form, which also decides each column (decide_column: up to kDecideRegs
// rows from the unsorted copy it keeps in registers, above by re-reading
// the listed rows) and records the block's decisions (record_decisions);
// its threads past d read column d - 1 for the ballots and write nothing.
template <int NMAX, bool kDecide, class Rows>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                          const float* __restrict__ self_vals, float* __restrict__ out, int m,
                          int d, int b, bool recip, Experiments ex, Decide dec) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_warp[kWarps];
  __shared__ float2 s_pair[Rows::kPairs];
  __shared__ int s_trim[kDecide ? kMaxRows : 1];
  const int j = blockIdx.y, e = blockIdx.z;
  const Rows src = rows.experiment(e);
  if constexpr (kDecide) s_trim[threadIdx.x] = 0;  // visible after load_neighbors' barriers
  const int count = load_neighbors(adj + e * ex.s_mask, m, j, s_nbr, s_warp);
  src.stage(s_nbr, count, s_pair, blockIdx.x);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (!kDecide && k >= d) return;
  const int kc = kDecide ? min(k, d - 1) : k;
  const size_t at = (static_cast<size_t>(e) * m + j) * d + kc;
  const int be = ex.b_of(e, b);
  LaneCounts<NMAX> lanes;
  for_bucket<NMAX>(count, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    load_column<N>(v, src, s_pair, s_nbr, count, d, kc);
    float kept[N];
    if constexpr (kDecide && N <= kDecideRegs) {
#pragma unroll
      for (int i = 0; i < N; ++i) kept[i] = v[i];
    }
    batcher_sort<N>(v);
    const float res = trimmed_mean_sorted<N>(v, count, be, self_vals[at], recip);
    if (k < d) out[at] = res;
    if constexpr (kDecide) {
      decide_column<N>(lanes, kept, count, trim_window<N>(v, count, be),
                       k < d && k % dec.stride == 0, threadIdx.x & 31,
                       [&](int i) { return src.load(s_pair, s_nbr[i], i, d, kc); });
    }
  });
  if constexpr (kDecide) {
    record_decisions(lanes, s_nbr, count, s_trim, dec,
                     (static_cast<size_t>(e) * m + j) * dec.width);
  }
}

template <int NMAX, bool kDecide, class Rows>
__global__ void __launch_bounds__(kThreads)
median_dense_kernel(Rows rows, const uint8_t* __restrict__ adj,
                    const float* __restrict__ self_vals, float* __restrict__ out, int m, int d,
                    Experiments ex, Decide dec) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_warp[kWarps];
  __shared__ float2 s_pair[Rows::kPairs];
  __shared__ int s_trim[kDecide ? kMaxRows : 1];
  const int j = blockIdx.y, e = blockIdx.z;
  const Rows src = rows.experiment(e);
  if constexpr (kDecide) s_trim[threadIdx.x] = 0;  // visible after load_neighbors' barriers
  const int count = load_neighbors(adj + e * ex.s_mask, m, j, s_nbr, s_warp);
  src.stage(s_nbr, count, s_pair, blockIdx.x);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (!kDecide && k >= d) return;
  const int kc = kDecide ? min(k, d - 1) : k;
  const size_t at = (static_cast<size_t>(e) * m + j) * d + kc;
  // the node's own (uncompressed) value joins as one more row
  const float own = sanitize(self_vals[at]);
  LaneCounts<NMAX> lanes;
  for_bucket<NMAX>(count + 1, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    load_column<N>(v, src, s_pair, s_nbr, count, d, kc);
    float kept[N];
    if constexpr (kDecide && N <= kDecideRegs) {
#pragma unroll
      for (int i = 0; i < N; ++i) kept[i] = v[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == count) v[i] = own;
    }
    batcher_sort<N>(v);
    const float res = median_sorted<N>(v, count + 1);
    if (k < d) out[at] = res;
    if constexpr (kDecide) {
      decide_column<N>(lanes, kept, count, median_window<N>(v, count + 1),
                       k < d && k % dec.stride == 0, threadIdx.x & 31,
                       [&](int i) { return src.load(s_pair, s_nbr[i], i, d, kc); });
    }
  });
  if constexpr (kDecide) {
    record_decisions(lanes, s_nbr, count, s_trim, dec,
                     (static_cast<size_t>(e) * m + j) * dec.width);
  }
}

// Launch over rows to sort: m for the trimmed mean, m + 1 for the median,
// with the kernel compiled for the next power of two (NMAX), which holds
// every bucket a block of this launch can pick, and ex.count experiments
// along gridDim.z; cudaErrorInvalidValue above kMaxRows or
// kMaxExperiments.  kDecide: the decide form, recording into dec.
template <bool kDecide = false, class Rows>
cudaError_t launch_trimmed_mean_dense(const Rows& rows, const uint8_t* adj,
                                      const float* self_vals, float* out, int m, int d, int b,
                                      bool recip, cudaStream_t s,
                                      const Experiments& ex = Experiments{},
                                      const Decide& dec = Decide{}) {
  if (ex.count < 1 || ex.count > kMaxExperiments) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m, ex.count);
  if (m <= 16) {
    trimmed_mean_dense_kernel<16, kDecide, Rows><<<grid, kThreads, 0, s>>>(
        rows, adj, self_vals, out, m, d, b, recip, ex, dec);
  } else if (m <= 32) {
    trimmed_mean_dense_kernel<32, kDecide, Rows><<<grid, kThreads, 0, s>>>(
        rows, adj, self_vals, out, m, d, b, recip, ex, dec);
  } else if (m <= 64) {
    trimmed_mean_dense_kernel<64, kDecide, Rows><<<grid, kThreads, 0, s>>>(
        rows, adj, self_vals, out, m, d, b, recip, ex, dec);
  } else if (m <= kMaxRows) {
    trimmed_mean_dense_kernel<128, kDecide, Rows><<<grid, kThreads, 0, s>>>(
        rows, adj, self_vals, out, m, d, b, recip, ex, dec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <bool kDecide = false, class Rows>
cudaError_t launch_median_dense(const Rows& rows, const uint8_t* adj, const float* self_vals,
                                float* out, int m, int d, cudaStream_t s,
                                const Experiments& ex = Experiments{},
                                const Decide& dec = Decide{}) {
  if (ex.count < 1 || ex.count > kMaxExperiments) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m, ex.count);
  const int n = m + 1;
  if (n <= 16) {
    median_dense_kernel<16, kDecide, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out,
                                                                      m, d, ex, dec);
  } else if (n <= 32) {
    median_dense_kernel<32, kDecide, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out,
                                                                      m, d, ex, dec);
  } else if (n <= 64) {
    median_dense_kernel<64, kDecide, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out,
                                                                      m, d, ex, dec);
  } else if (n <= kMaxRows) {
    median_dense_kernel<128, kDecide, Rows><<<grid, kThreads, 0, s>>>(rows, adj, self_vals, out,
                                                                       m, d, ex, dec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace screen
