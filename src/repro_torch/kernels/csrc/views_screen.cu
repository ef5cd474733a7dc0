// Coordinate-wise screening of the network runtime's mailbox views, for
// Hopper (sm_90a).
//
// views_screen_trimmed_mean and views_screen_median replace, in their own
// form, the TPU kernels
//   src/repro/kernels/trimmed_mean.py::trimmed_mean_pallas
//   src/repro/kernels/median.py::median_pallas
// which screen values [E, n, d] under mask [E, n] against self [E, d]: one
// block of views a node.  The runtime's step screens exactly that, with
// E = M and n = W: the mailbox views [M, W, d] (W = M on the dense per-link
// layout, K on the neighbor-indexed one) under the usable mask [M, W]
// (src/repro/core/bridge.py, screen_views_banked).  A net grid screens E
// cells' views [E, M, W, d] in one launch, experiment e on gridDim.y with
// its own views (ViewRows::experiment), mask, self values, outputs and b.
//
// What they compute is the gather screens' arithmetic (gather_screen.cu):
// NaN -> +inf, each column of node j's usable slots sorted ascending, the
// trimmed mean summing ranks [b_eff, count - b_eff) left to right, adding
// the node's own value and dividing (IEEE), the median joining the node's
// own (sanitized) value and averaging the two middle order statistics.  A
// node with no usable slot (a starved node) gets its own value back from
// the trimmed mean and its own sanitized value from the median: finite
// where self is, and the step discards it.  Up to 64 rows it equals the
// plain versions (kernels/ref.py trimmed_mean_views, median_views) bit for
// bit, up to the sign of a zero.
//
// Design.  The same kernels as the gather screens, over the ViewRows row
// source (screen_sort.cuh): node j's slot k at coordinate c is read at
// j s_recv + k s_slot + c, from the views' own strides, so no index tensor
// is loaded and no view is copied.  A receiver stride of 0 (the
// synchronous runtime's broadcast expanded over the receivers) reads the
// broadcast's rows in place, exactly the dense screen's rows.  Up to 63
// slots the tile kernel (screen_tile.cuh) sorts in register networks, with
// the gather screens' plan (kernels/gather_screen.py tile_plan for float
// rows) and the slot itself as the row of a node's list; above, the wide
// path (screen_wide.cuh) over DenseList{mask, W}.
//
// What bounds it on an H100.  Device memory: unlike the broadcast screens,
// whose [M, d] rows every node shares in L2, each node's views are its own,
// so the usable views come from HBM once, with self_vals and the output:
// about 38.5 MB at dense M = 50 on erdos_renyi(50, 0.5, 4) (0.012 ms at
// 3.35 TB/s), at most 289 MB at sparse M = 512, K = 16 (0.086 ms).

#include <stdint.h>

#include "screen_sort.cuh"
#include "screen_tile.cuh"
#include "screen_wide.cuh"

// C entry points (bound with ctypes).  views [E, M, W, d] float32 with unit
// coordinate stride, s_exp, s_recv and s_slot its cell, node and slot
// strides in elements (s_exp 0 for one cell); mask [M, W] (s_mask 0, every
// cell's) or [E, M, W] (s_mask = M W) uint8 contiguous; self_vals and out
// [E, M, d] contiguous; the trimmed mean trims b_e[e] (int32 [E] on the
// card) or, with a null b_e, b.  The experiment operands are
// screen_sort.cuh's Experiments (a launch's gridDim.y), as the gather
// screens take them (gather_screen.cu).  The tile entries take W <= 63 and
// the plan (tile, chunk, segments, cols) of kernels/gather_screen.py; the
// wide ones any W up to screen::kWideMaxRows rows to sort.  Each returns
// cudaGetLastError() after its launch (cudaErrorInvalidValue for a shape
// or plan it does not take).
namespace {
screen::ViewRows view_rows(const float* v, long long s_exp, long long s_recv, long long s_slot) {
  return screen::ViewRows{v, s_recv, s_slot, s_exp};
}
}  // namespace

extern "C" int views_screen_trimmed_mean(const float* v, long long s_exp, long long s_recv,
                                         long long s_slot, const uint8_t* mask,
                                         const float* self_vals, float* out, int m, int w, int d,
                                         int b, int experiments, long long s_mask, const int* b_e,
                                         int tile, int chunk, int segments, int cols,
                                         void* stream) {
  return screen::launch_tile<false>(view_rows(v, s_exp, s_recv, s_slot), nullptr, mask,
                                    self_vals, out, m, w, d, b, tile, chunk, segments, cols,
                                    static_cast<cudaStream_t>(stream),
                                    screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int views_screen_median(const float* v, long long s_exp, long long s_recv,
                                   long long s_slot, const uint8_t* mask, const float* self_vals,
                                   float* out, int m, int w, int d, int experiments,
                                   long long s_mask, int tile, int chunk, int segments, int cols,
                                   void* stream) {
  return screen::launch_tile<true>(view_rows(v, s_exp, s_recv, s_slot), nullptr, mask,
                                   self_vals, out, m, w, d, 0, tile, chunk, segments, cols,
                                   static_cast<cudaStream_t>(stream),
                                   screen::Experiments{experiments, s_mask, nullptr});
}

extern "C" int views_screen_wide_trimmed_mean(const float* v, long long s_exp, long long s_recv,
                                              long long s_slot, const uint8_t* mask,
                                              const float* self_vals, float* out, int m, int w,
                                              int d, int b, int experiments, long long s_mask,
                                              const int* b_e, void* stream) {
  return screen::launch_wide<false>(view_rows(v, s_exp, s_recv, s_slot),
                                    screen::DenseList{mask, w}, self_vals, out, m, d, w, b, false,
                                    static_cast<cudaStream_t>(stream),
                                    screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int views_screen_wide_median(const float* v, long long s_exp, long long s_recv,
                                        long long s_slot, const uint8_t* mask,
                                        const float* self_vals, float* out, int m, int w, int d,
                                        int experiments, long long s_mask, void* stream) {
  return screen::launch_wide<true>(view_rows(v, s_exp, s_recv, s_slot),
                                   screen::DenseList{mask, w}, self_vals, out, m, d, w, 0, false,
                                   static_cast<cudaStream_t>(stream),
                                   screen::Experiments{experiments, s_mask, nullptr});
}
