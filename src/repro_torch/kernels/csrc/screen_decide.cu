// The decide form of the dense coordinate-wise screens, for Hopper (sm_90a).
//
// screen_trimmed_mean_dense_decide and screen_median_dense_decide are the
// kernels of screen.cu (screen_dense.cuh, kDecide) that also record each
// node's per-edge decisions: the reference's *_with_decisions twins
// (src/repro/core/screening.py trimmed_mean_with_decisions,
// coordinate_median_with_decisions), which the trust layer and the trace's
// forensics read.  The reference computes these decisions in jnp; it has
// no Pallas kernel for them, so this is new kernel work, not a port.
//
// What they compute.  The output is screen.cu's, bit for bit (the same
// sort and the same summation).  Beside it, for each node j and each
// sender i it lists, the number of columns c (c % stride == 0, c < d) on
// which i's sanitized value lies outside the column's kept window: the
// trimmed mean's sorted ranks b_eff and max(count - b_eff - 1, b_eff), the
// median's two middle ranks of the count + 1 rows (self included); ties at
// a boundary are kept.  counts[e, j, i] (int32 [E, M, M], zeroed by the
// caller) gets them by integer atomics, so it does not depend on block
// order; the wrapper turns them into fractions (kernels/ref.py
// count_fraction).
//
// What bounds it on an H100.  The plain kernel's work plus a second read
// of each listed row's column (from L2: the rows were just read), a ballot
// and a popc a row and warp, and one shared and one global atomic a row
// and block.  Above 128 rows to sort the wrappers launch the wide path's
// decide form (screen_wide.cuh, kDecide) through
// screen_wide_trimmed_mean_dense_decide and screen_wide_median_dense_decide,
// which take the same operands: the same sort and sum as the plain wide
// kernel, then each listed row re-read (from L2) against its columns' kept
// windows, a warp a row, one integer atomic a row and block.

#include <stdint.h>

#include "screen_dense.cuh"
#include "screen_wide.cuh"

// C entry points (bound with ctypes): screen.cu's register entries'
// operands (no reciprocal form), then the counts [E, M, M] and the stride.
// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a shape it does not take).
namespace {
screen::FloatRows float_rows(const float* w, int m, int d) {
  return screen::FloatRows{w, static_cast<long long>(m) * d};
}
}  // namespace

extern "C" int screen_trimmed_mean_dense_decide(const float* w, const uint8_t* adj,
                                                const float* self_vals, float* out, int* counts,
                                                int m, int d, int b, int experiments,
                                                long long s_mask, const int* b_e, int stride,
                                                void* stream) {
  if (m < 1 || d < 1 || stride < 1) return cudaErrorInvalidValue;
  return screen::launch_trimmed_mean_dense<true>(
      float_rows(w, m, d), adj, self_vals, out, m, d, b, false,
      static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, b_e},
      screen::Decide{counts, m, stride});
}

extern "C" int screen_median_dense_decide(const float* w, const uint8_t* adj,
                                          const float* self_vals, float* out, int* counts, int m,
                                          int d, int experiments, long long s_mask, int stride,
                                          void* stream) {
  if (m < 1 || d < 1 || stride < 1) return cudaErrorInvalidValue;
  return screen::launch_median_dense<true>(
      float_rows(w, m, d), adj, self_vals, out, m, d, static_cast<cudaStream_t>(stream),
      screen::Experiments{experiments, s_mask, nullptr}, screen::Decide{counts, m, stride});
}

// The wide decide form over the same operands, for any M up to
// screen::kWideMaxRows rows to sort (M for the trimmed mean, M + 1 for the
// median).
extern "C" int screen_wide_trimmed_mean_dense_decide(const float* w, const uint8_t* adj,
                                                     const float* self_vals, float* out,
                                                     int* counts, int m, int d, int b,
                                                     int experiments, long long s_mask,
                                                     const int* b_e, int stride, void* stream) {
  return screen::launch_wide<false, true>(
      float_rows(w, m, d), screen::DenseList{adj, m}, self_vals, out, m, d, m, b, false,
      static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, b_e},
      screen::Decide{counts, m, stride});
}

extern "C" int screen_wide_median_dense_decide(const float* w, const uint8_t* adj,
                                               const float* self_vals, float* out, int* counts,
                                               int m, int d, int experiments, long long s_mask,
                                               int stride, void* stream) {
  return screen::launch_wide<true, true>(
      float_rows(w, m, d), screen::DenseList{adj, m}, self_vals, out, m, d, m, 0, false,
      static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, nullptr},
      screen::Decide{counts, m, stride});
}
