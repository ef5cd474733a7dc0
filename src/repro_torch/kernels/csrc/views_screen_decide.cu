// The decide form of the views screens (the tile kernel of screen_tile.cuh,
// kDecide, over the runtime's mailbox views), for Hopper (sm_90a).
//
// views_screen_trimmed_mean_decide and views_screen_median_decide are
// views_screen.cu's tile entries that also record each node's per-view
// decisions, as screen_decide.cu does on the dense layout (the reference's
// screen_views_decide_banked; no Pallas kernel there, so new kernel work).
// The output is the plain kernel's bit for bit; counts [E, M, W] (int32,
// zeroed by the caller) gets, per node and view slot, the columns c
// (c % stride == 0) on which the view's value fell outside the kept
// window.  One column a lane (the plan's cols must be 1), W <= 63: above,
// the wrappers launch the wide path's decide form (screen_wide.cuh,
// kDecide, over DenseList{mask, W}) through
// views_screen_wide_trimmed_mean_decide and views_screen_wide_median_decide.

#include <stdint.h>

#include "screen_sort.cuh"
#include "screen_tile.cuh"
#include "screen_wide.cuh"

// C entry points (bound with ctypes): views_screen.cu's tile operands, then
// the counts [E, M, W] and the stride, then the plan (tile, chunk,
// segments; one column a lane).
namespace {
screen::ViewRows view_rows(const float* v, long long s_exp, long long s_recv, long long s_slot) {
  return screen::ViewRows{v, s_recv, s_slot, s_exp};
}
}  // namespace

extern "C" int views_screen_trimmed_mean_decide(const float* v, long long s_exp,
                                                long long s_recv, long long s_slot,
                                                const uint8_t* mask, const float* self_vals,
                                                float* out, int* counts, int m, int w, int d,
                                                int b, int experiments, long long s_mask,
                                                const int* b_e, int stride, int tile, int chunk,
                                                int segments, void* stream) {
  return screen::launch_tile<false>(view_rows(v, s_exp, s_recv, s_slot), nullptr, mask,
                                    self_vals, out, m, w, d, b, tile, chunk, segments, 1,
                                    static_cast<cudaStream_t>(stream),
                                    screen::Experiments{experiments, s_mask, b_e},
                                    screen::Decide{counts, w, stride});
}

extern "C" int views_screen_median_decide(const float* v, long long s_exp, long long s_recv,
                                          long long s_slot, const uint8_t* mask,
                                          const float* self_vals, float* out, int* counts, int m,
                                          int w, int d, int experiments, long long s_mask,
                                          int stride, int tile, int chunk, int segments,
                                          void* stream) {
  return screen::launch_tile<true>(view_rows(v, s_exp, s_recv, s_slot), nullptr, mask,
                                   self_vals, out, m, w, d, 0, tile, chunk, segments, 1,
                                   static_cast<cudaStream_t>(stream),
                                   screen::Experiments{experiments, s_mask, nullptr},
                                   screen::Decide{counts, w, stride});
}

// The wide decide form (screen_wide.cuh) over the same operands but the
// plan, for any W up to screen::kWideMaxRows rows to sort (W for the
// trimmed mean, W + 1 for the median).
extern "C" int views_screen_wide_trimmed_mean_decide(const float* v, long long s_exp,
                                                     long long s_recv, long long s_slot,
                                                     const uint8_t* mask, const float* self_vals,
                                                     float* out, int* counts, int m, int w, int d,
                                                     int b, int experiments, long long s_mask,
                                                     const int* b_e, int stride, void* stream) {
  return screen::launch_wide<false, true>(
      view_rows(v, s_exp, s_recv, s_slot), screen::DenseList{mask, w}, self_vals, out, m, d, w, b,
      false, static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, b_e},
      screen::Decide{counts, w, stride});
}

extern "C" int views_screen_wide_median_decide(const float* v, long long s_exp, long long s_recv,
                                               long long s_slot, const uint8_t* mask,
                                               const float* self_vals, float* out, int* counts,
                                               int m, int w, int d, int experiments,
                                               long long s_mask, int stride, void* stream) {
  return screen::launch_wide<true, true>(
      view_rows(v, s_exp, s_recv, s_slot), screen::DenseList{mask, w}, self_vals, out, m, d, w, 0,
      false, static_cast<cudaStream_t>(stream), screen::Experiments{experiments, s_mask, nullptr},
      screen::Decide{counts, w, stride});
}
