// Sparse-layout coordinate-wise screening kernels for Hopper (sm_90a).
//
// gather_screen_trimmed_mean and gather_screen_median replace the TPU kernel
//   src/repro/kernels/gather_screen.py::gather_screen_pallas (rule=trimmed_mean|median)
// gather_dequant_screen_trimmed_mean and gather_dequant_screen_median
// replace the TPU kernel
//   src/repro/kernels/gather_screen.py::gather_dequant_screen_pallas (rule=...)
//
// What they compute.  Node j's in-neighbors are the slots of row j of a
// static [M, K] table: safe_idx[j, k] names a row of the broadcast w [M, d]
// and valid[j, k] marks the slot real (padded slots hold a clamped index and
// are +inf sentinels).  Every node screens its K gathered rows and writes
// out[j, :], with the numerics of the rules the reference trainer runs
// (src/repro/core/screening.py through screen_views_banked), the same as
// screen.cu: NaN payloads become +inf, each column is sorted ascending, the
// trimmed mean sums ranks [b_eff, count - b_eff) left to right, adds the
// node's own value and divides (IEEE); the median joins the node's own
// (sanitized) value and averages the two middle order statistics.  Up to 64
// sorted rows (K <= 63, so K + 1 rows for the median) that is the
// reference's order exactly.
//
// The codeword forms read int8 codewords instead of w: codes q [M, d] and
// one (scale, zero) pair per 128 coordinates, scale [M, S, 2]; each value is
// decoded as dequant.cu does (fma(q, scale, zero) rounded once, NaN -> +inf)
// and screened against the uncompressed self_vals.  The kernels are one
// template over the row source (screen_sort.cuh), so a codeword screen
// equals dequant followed by the float screen bit for bit, and neither the
// decoded bank nor the gathered [M, K, d] tensor reaches device memory.
//
// Design.  One block per (node j, 128 coordinates), one thread per
// coordinate.  The block loads row j of safe_idx and valid into shared
// memory once (one slot per thread) and counts the valid slots at the same
// barrier; each thread then gathers its K values straight from w (the warp
// reads 32 neighbouring floats of one row, coalesced), so neither [M, M, d]
// nor [M, K, d] is formed.  The column sits in a register array of the
// smallest network bucket that holds K (K + 1 for the median), padded and
// invalid slots +inf, and is sorted by that bucket's Batcher network
// (screen_sort.cuh, shared with screen.cu); NMAX in {16, 32, 64}, the
// largest bucket a kernel compiles, comes from K on the host.
//
// What bounds it on an H100.  Bytes: the sparse layout's point is that K is
// small, so the work per byte is low.  At M = 512, K = 16, d = 7850 the
// function reads w (16.1 MB, which L2 holds, so the K-fold re-reads stay on
// chip) and self_vals and writes the output: about 48 MB, 0.014 ms at
// 3.35 TB/s.  Operations: Batcher over 16-17 rows is 63-80 compare-exchanges
// per column per node, about 0.008 ms at 67 TFLOP/s.  So this kernel is
// bounded by bytes, unlike the dense ones; the network sorts the bucket of
// K (16 rows for the trimmed mean, 24 for the median at K = 16), a few
// comparators more than the valid slots need, and stays under the bytes.
// The codeword forms read a quarter of w's bytes: at the same shape about
// 4.0 MB of codes, 0.25 MB of scales and 16.1 MB of self_vals in and
// 16.1 MB out, 0.011 ms at 3.35 TB/s, three quarters of the float screen's
// bound.  After the table row, the block stages the (scale, zero) pairs of
// its K rows for its 128 coordinates (one scale block) in shared memory;
// threads then read one int8 code a row.

#include <stdint.h>

#include "screen_sort.cuh"

namespace {

using screen::kThreads;
constexpr int kMaxSlots = 64;  // largest NMAX instantiated

// Threads k < K load slot k of node j's table row into shared memory; the
// barrier returns the number of valid slots to every thread.
__device__ __forceinline__ int load_slots(const int32_t* __restrict__ idx,
                                          const uint8_t* __restrict__ valid, int m, int k, int j,
                                          int* s_idx, uint8_t* s_valid) {
  const int t = threadIdx.x;
  bool live = false;
  if (t < k) {
    const size_t at = static_cast<size_t>(j) * k + t;
    s_idx[t] = min(max(idx[at], 0), m - 1);
    live = valid[at] != 0;
    s_valid[t] = live;
  }
  return __syncthreads_count(live);
}

// The column of coordinate c over node j's slots, sanitized, +inf where a
// slot is padded or beyond K.
template <int N, class Rows>
__device__ __forceinline__ void gather_column(float (&v)[N], const Rows& rows,
                                              const float2* s_pair, const int* s_idx,
                                              const uint8_t* s_valid, int k, int d, int c) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    v[i] = CUDART_INF_F;
    if (i < k && s_valid[i]) v[i] = rows.load(s_pair, s_idx[i], i, d, c);
  }
}

template <int NMAX, class Rows>
__global__ void __launch_bounds__(kThreads)
gather_trimmed_mean_kernel(Rows rows, const int32_t* __restrict__ idx,
                           const uint8_t* __restrict__ valid, const float* __restrict__ self_vals,
                           float* __restrict__ out, int m, int k, int d, int b) {
  __shared__ int s_idx[kMaxSlots];
  __shared__ uint8_t s_valid[kMaxSlots];
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y;
  const int count = load_slots(idx, valid, m, k, j, s_idx, s_valid);
  rows.stage(s_idx, k, s_pair);
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const size_t at = static_cast<size_t>(j) * d + c;
  screen::for_bucket<NMAX>(k, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    gather_column<N>(v, rows, s_pair, s_idx, s_valid, k, d, c);
    screen::batcher_sort<N>(v);
    out[at] = screen::trimmed_mean_sorted<N>(v, count, b, self_vals[at]);
  });
}

template <int NMAX, class Rows>
__global__ void __launch_bounds__(kThreads)
gather_median_kernel(Rows rows, const int32_t* __restrict__ idx,
                     const uint8_t* __restrict__ valid, const float* __restrict__ self_vals,
                     float* __restrict__ out, int m, int k, int d) {
  __shared__ int s_idx[kMaxSlots];
  __shared__ uint8_t s_valid[kMaxSlots];
  __shared__ float2 s_pair[Rows::kPairs];
  const int j = blockIdx.y;
  const int count = load_slots(idx, valid, m, k, j, s_idx, s_valid);
  rows.stage(s_idx, k, s_pair);
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  const size_t at = static_cast<size_t>(j) * d + c;
  // the node's own value takes the slot after the K table slots (the sort
  // makes the position irrelevant)
  const float own = screen::sanitize(self_vals[at]);
  screen::for_bucket<NMAX>(k + 1, [&](auto bucket) {
    constexpr int N = decltype(bucket)::value;
    float v[N];
    gather_column<N>(v, rows, s_pair, s_idx, s_valid, k, d, c);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (i == k) v[i] = own;
    }
    screen::batcher_sort<N>(v);
    out[at] = screen::median_sorted<N>(v, count + 1);
  });
}

// Launch over rows to sort: K for the trimmed mean, K + 1 for the median;
// cudaErrorInvalidValue above kMaxSlots.
template <class Rows>
cudaError_t launch_trimmed_mean(const Rows& rows, const int32_t* idx, const uint8_t* valid,
                                const float* self_vals, float* out, int m, int k, int d, int b,
                                cudaStream_t s) {
  if (m < 1 || d < 1 || k < 0) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  if (k <= 16) {
    gather_trimmed_mean_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals,
                                                                    out, m, k, d, b);
  } else if (k <= 32) {
    gather_trimmed_mean_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals,
                                                                    out, m, k, d, b);
  } else if (k <= 64) {
    gather_trimmed_mean_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals,
                                                                    out, m, k, d, b);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <class Rows>
cudaError_t launch_median(const Rows& rows, const int32_t* idx, const uint8_t* valid,
                          const float* self_vals, float* out, int m, int k, int d,
                          cudaStream_t s) {
  if (m < 1 || d < 1 || k < 0) return cudaErrorInvalidValue;
  const dim3 grid((d + kThreads - 1) / kThreads, m);
  const int n = k + 1;
  if (n <= 16) {
    gather_median_kernel<16, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals, out, m,
                                                              k, d);
  } else if (n <= 32) {
    gather_median_kernel<32, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals, out, m,
                                                              k, d);
  } else if (n <= 64) {
    gather_median_kernel<64, Rows><<<grid, kThreads, 0, s>>>(rows, idx, valid, self_vals, out, m,
                                                              k, d);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool scales_fit(int d, int nblk) {
  return nblk == (d + screen::kScaleBlock - 1) / screen::kScaleBlock;
}

}  // namespace

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape it does not take); the
// caller raises on anything but cudaSuccess.  Rows to sort: K for the
// trimmed mean, K + 1 for the median; at most kMaxSlots.  The codeword
// forms also refuse nblk != ceil(d / 128).
extern "C" int gather_screen_trimmed_mean(const float* w, const int32_t* idx,
                                          const uint8_t* valid, const float* self_vals,
                                          float* out, int m, int k, int d, int b, void* stream) {
  return launch_trimmed_mean(screen::FloatRows{w}, idx, valid, self_vals, out, m, k, d, b,
                             static_cast<cudaStream_t>(stream));
}

extern "C" int gather_screen_median(const float* w, const int32_t* idx, const uint8_t* valid,
                                    const float* self_vals, float* out, int m, int k, int d,
                                    void* stream) {
  return launch_median(screen::FloatRows{w}, idx, valid, self_vals, out, m, k, d,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int gather_dequant_screen_trimmed_mean(const int8_t* q, const float* scale,
                                                  const int32_t* idx, const uint8_t* valid,
                                                  const float* self_vals, float* out, int m,
                                                  int k, int d, int nblk, int b, void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return launch_trimmed_mean(screen::CodewordRows{q, scale, nblk}, idx, valid, self_vals, out, m,
                             k, d, b, static_cast<cudaStream_t>(stream));
}

extern "C" int gather_dequant_screen_median(const int8_t* q, const float* scale,
                                            const int32_t* idx, const uint8_t* valid,
                                            const float* self_vals, float* out, int m, int k,
                                            int d, int nblk, void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return launch_median(screen::CodewordRows{q, scale, nblk}, idx, valid, self_vals, out, m, k, d,
                       static_cast<cudaStream_t>(stream));
}
