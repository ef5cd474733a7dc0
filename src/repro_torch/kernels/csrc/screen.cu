// Dense coordinate-wise screening kernels for Hopper (sm_90a).
//
// screen_trimmed_mean_dense replaces the TPU kernel
//   src/repro/kernels/trimmed_mean.py::trimmed_mean_pallas   (BRIDGE-T)
// screen_median_dense replaces the TPU kernel
//   src/repro/kernels/median.py::median_pallas               (BRIDGE-M)
//
// What they compute.  Every node j screens the shared broadcast w [M, d]
// under its in-neighbor row adj[j, :] (adj[j, i] != 0: i sends to j) and
// writes out[j, :].  The arithmetic is that of the rules the reference
// trainer runs (src/repro/core/screening.py), not of the Pallas kernels:
//   * NaN payloads become +inf; absent rows are +inf sentinels;
//   * each column is sorted ascending (bitonic network in registers);
//   * trimmed mean: b_eff = min(b, (count-1)/2); ranks [b_eff, count-b_eff)
//     are summed left to right with IEEE adds, the node's own value
//     (unsanitized) is added, and the total is divided, IEEE-rounded, by
//     count - 2 b_eff + 1;
//   * median: the node's own value joins as one more (sanitized) row; the
//     result is 0.5f * (o[(c-1)/2] + o[c/2]) over the c = count + 1 rows.
// Up to 64 rows that order is the reference's exactly (its sequential
// sum_rows), so the output equals it bit for bit up to the sign of a zero.
// Intrinsics (__fadd_rn, __fdiv_rn, __fmul_rn) keep the compiler from
// contracting or approximating any step.  The sort network and the two
// reductions live in screen_sort.cuh, shared with gather_screen.cu.
//
// Design.  The TPU kernel tiled [n, 512] blocks of a pre-gathered
// [E, n, d] tensor and extracted extremes with masked max/min passes.  Here
// the grid is (coordinate block, node): one block per (j, 128 coordinates),
// one thread per coordinate.  The block reads adj[j, :] once, compacts it
// into a neighbor list in shared memory and derives count and b_eff there;
// each thread gathers its column straight from w (coalesced across the
// warp), so the [M, M, d] tensor is never formed.  The column lives in a
// register array of N_PAD in {16, 32, 64, 128} entries (a template
// parameter, the next power of two above the row count); indices are
// compile-time constants after unrolling, so nothing goes to local memory
// up to N_PAD = 64 (check the ptxas report the build writes).
//
// What bounds it on an H100.  Bytes: w is read M times through L2 (each
// node reads its neighbors' rows); device memory sees M*d*4 bytes of w and
// of self_vals in and M*d*4 out.  Operations: the bitonic network does
// N_PAD/4 * log2(N_PAD) * (log2(N_PAD) + 1) compare-exchanges (two fp32
// min/max each) per column per node, a few times the ~n/2 log^2 n that a
// Batcher network over the true count needs.  At the main path's shapes
// (M = 50, d = 7850) the operation bound is the larger; the kernel is
// simple first and leaves padding-aware networks for later work.

#include <stdint.h>

#include "screen_sort.cuh"

namespace {

using screen::kThreads;
constexpr int kMaxRows = 128;  // largest N_PAD instantiated

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

template <int N>
__global__ void __launch_bounds__(kThreads)
trimmed_mean_dense_kernel(const float* __restrict__ w, const uint8_t* __restrict__ adj,
                          const float* __restrict__ self_vals, float* __restrict__ out,
                          int m, int d, int b) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_count;
  const int j = blockIdx.y;
  load_neighbors(adj, m, j, s_nbr, &s_count);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const int count = s_count;

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = CUDART_INF_F;
    if (i < count) v[i] = screen::sanitize(w[static_cast<size_t>(s_nbr[i]) * d + k]);
  }
  screen::bitonic_sort<N>(v);
  const size_t at = static_cast<size_t>(j) * d + k;
  out[at] = screen::trimmed_mean_sorted<N>(v, count, b, self_vals[at]);
}

template <int N>
__global__ void __launch_bounds__(kThreads)
median_dense_kernel(const float* __restrict__ w, const uint8_t* __restrict__ adj,
                    const float* __restrict__ self_vals, float* __restrict__ out, int m, int d) {
  __shared__ int s_nbr[kMaxRows];
  __shared__ int s_count;
  const int j = blockIdx.y;
  load_neighbors(adj, m, j, s_nbr, &s_count);
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= d) return;
  const int count = s_count;
  const size_t at = static_cast<size_t>(j) * d + k;
  const float own = screen::sanitize(self_vals[at]);

  float v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = i == count ? own : CUDART_INF_F;
    if (i < count) v[i] = screen::sanitize(w[static_cast<size_t>(s_nbr[i]) * d + k]);
  }
  screen::bitonic_sort<N>(v);
  out[at] = screen::median_sorted<N>(v, count + 1);
}

template <int N>
cudaError_t launch_trimmed_mean(const float* w, const uint8_t* adj, const float* self_vals,
                                float* out, int m, int d, int b, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  trimmed_mean_dense_kernel<N><<<grid, kThreads, 0, stream>>>(w, adj, self_vals, out, m, d, b);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_median(const float* w, const uint8_t* adj, const float* self_vals, float* out,
                          int m, int d, cudaStream_t stream) {
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  median_dense_kernel<N><<<grid, kThreads, 0, stream>>>(w, adj, self_vals, out, m, d);
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape it does not take); the
// caller raises on anything but cudaSuccess.  Rows to sort: m for the
// trimmed mean, m + 1 for the median; at most kMaxRows.
extern "C" int screen_trimmed_mean_dense(const float* w, const uint8_t* adj,
                                         const float* self_vals, float* out, int m, int d, int b,
                                         void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 16) return launch_trimmed_mean<16>(w, adj, self_vals, out, m, d, b, s);
  if (m <= 32) return launch_trimmed_mean<32>(w, adj, self_vals, out, m, d, b, s);
  if (m <= 64) return launch_trimmed_mean<64>(w, adj, self_vals, out, m, d, b, s);
  if (m <= 128) return launch_trimmed_mean<128>(w, adj, self_vals, out, m, d, b, s);
  return cudaErrorInvalidValue;
}

extern "C" int screen_median_dense(const float* w, const uint8_t* adj, const float* self_vals,
                                   float* out, int m, int d, void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = m + 1;
  if (rows <= 16) return launch_median<16>(w, adj, self_vals, out, m, d, s);
  if (rows <= 32) return launch_median<32>(w, adj, self_vals, out, m, d, s);
  if (rows <= 64) return launch_median<64>(w, adj, self_vals, out, m, d, s);
  if (rows <= 128) return launch_median<128>(w, adj, self_vals, out, m, d, s);
  return cudaErrorInvalidValue;
}
