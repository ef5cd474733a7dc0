// The decide form of the sparse-layout screens (the gather tile kernel of
// screen_tile.cuh, kDecide, over float rows), for Hopper (sm_90a).
//
// gather_screen_trimmed_mean_decide and gather_screen_median_decide are
// gather_screen.cu's float entries that also record each node's per-slot
// decisions, as screen_decide.cu does on the dense layout (the reference's
// *_with_decisions twins through its decide-banked dispatch; no Pallas
// kernel there, so new kernel work).  The output is the plain kernel's bit
// for bit; counts [E, M, K] (int32, zeroed by the caller) gets, per node
// and table slot, the columns c (c % stride == 0) on which the slot's
// value fell outside the kept window.  The decide form sorts one column a
// lane (the plan's cols must be 1) and takes K <= 63: above, the wrappers
// launch the wide path's decide form (screen_wide.cuh, kDecide: a warp
// sorts a column, then each listed slot is re-read against its columns'
// kept windows) through gather_screen_wide_trimmed_mean_decide and
// gather_screen_wide_median_decide.

#include <stdint.h>

#include "screen_sort.cuh"
#include "screen_tile.cuh"
#include "screen_wide.cuh"

using screen::launch_tile;

// C entry points (bound with ctypes): gather_screen.cu's float operands,
// then the counts [E, M, K] and the stride, then the plan (tile, chunk,
// segments; one column a lane).
namespace {
screen::FloatRows float_rows(const float* w, int m, int d) {
  return screen::FloatRows{w, static_cast<long long>(m) * d};
}
}  // namespace

extern "C" int gather_screen_trimmed_mean_decide(const float* w, const int32_t* idx,
                                                 const uint8_t* valid, const float* self_vals,
                                                 float* out, int* counts, int m, int k, int d,
                                                 int b, int experiments, long long s_mask,
                                                 const int* b_e, int stride, int tile, int chunk,
                                                 int segments, void* stream) {
  return launch_tile<false>(float_rows(w, m, d), idx, valid, self_vals, out, m, k, d, b, tile,
                            chunk, segments, 1, static_cast<cudaStream_t>(stream),
                            screen::Experiments{experiments, s_mask, b_e},
                            screen::Decide{counts, k, stride});
}

extern "C" int gather_screen_median_decide(const float* w, const int32_t* idx,
                                           const uint8_t* valid, const float* self_vals,
                                           float* out, int* counts, int m, int k, int d,
                                           int experiments, long long s_mask, int stride,
                                           int tile, int chunk, int segments, void* stream) {
  return launch_tile<true>(float_rows(w, m, d), idx, valid, self_vals, out, m, k, d, 0, tile,
                           chunk, segments, 1, static_cast<cudaStream_t>(stream),
                           screen::Experiments{experiments, s_mask, nullptr},
                           screen::Decide{counts, k, stride});
}

// The wide decide form (screen_wide.cuh) over the same operands but the
// plan, for any K up to screen::kWideMaxRows rows to sort (K for the
// trimmed mean, K + 1 for the median).
extern "C" int gather_screen_wide_trimmed_mean_decide(const float* w, const int32_t* idx,
                                                      const uint8_t* valid,
                                                      const float* self_vals, float* out,
                                                      int* counts, int m, int k, int d, int b,
                                                      int experiments, long long s_mask,
                                                      const int* b_e, int stride, void* stream) {
  return screen::launch_wide<false, true>(
      float_rows(w, m, d), screen::SlotList{idx, valid, m, k}, self_vals, out, m, d, k, b, false,
      static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, b_e},
      screen::Decide{counts, k, stride});
}

extern "C" int gather_screen_wide_median_decide(const float* w, const int32_t* idx,
                                                const uint8_t* valid, const float* self_vals,
                                                float* out, int* counts, int m, int k, int d,
                                                int experiments, long long s_mask, int stride,
                                                void* stream) {
  return screen::launch_wide<true, true>(
      float_rows(w, m, d), screen::SlotList{idx, valid, m, k}, self_vals, out, m, d, k, 0, false,
      static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, nullptr},
      screen::Decide{counts, k, stride});
}
