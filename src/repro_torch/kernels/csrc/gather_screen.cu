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
// reference's order exactly, and the output equals the plain version bit
// for bit up to the sign of a zero.
//
// The codeword forms read int8 codewords instead of w: codes q [M, d] and
// one (scale, zero) pair per 128 coordinates, scale [M, S, 2]; each value is
// decoded as dequant.cu does (fma(q, scale, zero) rounded once, NaN -> +inf)
// and screened against the uncompressed self_vals.  The kernels are one
// template over the row source, so a codeword screen equals dequant
// followed by the float screen bit for bit, and neither the decoded bank nor
// the gathered [M, K, d] tensor reaches device memory.
//
// The tile kernel is screen_tile.cuh's (K <= 63); above 63 slots the
// wrappers launch the wide path (screen_wide.cuh).
//
// What bounds it on an H100.  Device memory: w (16.1 MB at M = 512,
// d = 7850), self_vals and the output once, about 48 MB, 0.014 ms at
// 3.35 TB/s; the codeword forms read 4 MB of codes in place of w.  Between
// L2 and the SMs every node reads its own rows: 225 MB a launch at K = 16
// on the small world (83.5 MB for codeword rows).  At the card's
// L2-resident read rate (kernel_times.py --sweep-gather) that traffic takes
// at most half the float kernels' time and about an eighth of the codeword
// ones' (PERF.md, the gather screens' findings), so neither bytes bound
// them: instructions do, the network's compare-exchanges and, around each
// value, an address, a load and the NaN guard (a codeword's decode too).
// Staging the distinct rows a tile's slots name once, through a cp.async
// ring in shared memory, cut the L2 traffic 2.3x on the small world and
// ran slower than these direct reads on every table timed: its copies and
// a barrier a chunk cost more than the traffic saved.

#include <stdint.h>

#include "screen_sort.cuh"
#include "screen_tile.cuh"
#include "screen_wide.cuh"

using screen::launch_tile;
using screen::scales_fit;

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape or plan it does not take);
// the caller raises on anything but cudaSuccess.  The tile kernels take
// K <= 63 and, after the operands, the plan of kernels/gather_screen.py
// (tile_plan): tile nodes a block, chunk coordinates at a time (32, 64 or
// 128), the chunk ranges a tile is cut into, and the columns a lane sorts
// (1, or 2 for the float median of at most 32 rows).  The codeword forms
// also refuse nblk != ceil(d / 128).
//
// The float forms take the experiment axis: w, self_vals and out [E, M, d]
// contiguous (E = experiments, 1 for the unbatched form), the indices
// shared and experiment e's valid mask e s_mask bytes in (0: shared); it
// trims b_e[e] (int32 [E] on the card) or, with a null b_e, b.
namespace {
screen::FloatRows float_rows(const float* w, int m, int d) {
  return screen::FloatRows{w, static_cast<long long>(m) * d};
}
}  // namespace

extern "C" int gather_screen_trimmed_mean(const float* w, const int32_t* idx,
                                          const uint8_t* valid, const float* self_vals,
                                          float* out, int m, int k, int d, int b,
                                          int experiments, long long s_mask, const int* b_e,
                                          int tile, int chunk, int segments, int cols,
                                          void* stream) {
  return launch_tile<false>(float_rows(w, m, d), idx, valid, self_vals, out, m, k, d, b, tile,
                            chunk, segments, cols, static_cast<cudaStream_t>(stream),
                            screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int gather_screen_median(const float* w, const int32_t* idx, const uint8_t* valid,
                                    const float* self_vals, float* out, int m, int k, int d,
                                    int experiments, long long s_mask, int tile, int chunk,
                                    int segments, int cols, void* stream) {
  return launch_tile<true>(float_rows(w, m, d), idx, valid, self_vals, out, m, k, d, 0, tile,
                           chunk, segments, cols, static_cast<cudaStream_t>(stream),
                           screen::Experiments{experiments, s_mask, nullptr});
}

extern "C" int gather_dequant_screen_trimmed_mean(const int8_t* q, const float* scale,
                                                  const int32_t* idx, const uint8_t* valid,
                                                  const float* self_vals, float* out, int m,
                                                  int k, int d, int nblk, int b, int tile,
                                                  int chunk, int segments, int cols,
                                                  void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return launch_tile<false>(screen::CodewordRows{q, scale, nblk}, idx, valid, self_vals, out, m, k,
                            d, b, tile, chunk, segments, cols, static_cast<cudaStream_t>(stream));
}

extern "C" int gather_dequant_screen_median(const int8_t* q, const float* scale,
                                            const int32_t* idx, const uint8_t* valid,
                                            const float* self_vals, float* out, int m, int k,
                                            int d, int nblk, int tile, int chunk, int segments,
                                            int cols, void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return launch_tile<true>(screen::CodewordRows{q, scale, nblk}, idx, valid, self_vals, out, m, k,
                           d, 0, tile, chunk, segments, cols, static_cast<cudaStream_t>(stream));
}

// The wide path (screen_wide.cuh) over the same operands, for any K up to
// screen::kWideMaxRows rows to sort (K for the trimmed mean, K + 1 for the
// median); the wrappers launch it above 63 slots.
extern "C" int gather_screen_wide_trimmed_mean(const float* w, const int32_t* idx,
                                               const uint8_t* valid, const float* self_vals,
                                               float* out, int m, int k, int d, int b,
                                               int experiments, long long s_mask,
                                               const int* b_e, void* stream) {
  return screen::launch_wide<false>(float_rows(w, m, d), screen::SlotList{idx, valid, m, k},
                                    self_vals, out, m, d, k, b, false,
                                    static_cast<cudaStream_t>(stream),
                                    screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int gather_screen_wide_median(const float* w, const int32_t* idx, const uint8_t* valid,
                                         const float* self_vals, float* out, int m, int k, int d,
                                         int experiments, long long s_mask,
                                         void* stream) {
  return screen::launch_wide<true>(float_rows(w, m, d), screen::SlotList{idx, valid, m, k},
                                   self_vals, out, m, d, k, 0, false,
                                   static_cast<cudaStream_t>(stream),
                                   screen::Experiments{experiments, s_mask, nullptr});
}

extern "C" int gather_dequant_screen_wide_trimmed_mean(const int8_t* q, const float* scale,
                                                       const int32_t* idx, const uint8_t* valid,
                                                       const float* self_vals, float* out, int m,
                                                       int k, int d, int nblk, int b,
                                                       void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_wide<false>(screen::CodewordRows{q, scale, nblk},
                                    screen::SlotList{idx, valid, m, k}, self_vals, out, m, d, k, b,
                                    false, static_cast<cudaStream_t>(stream));
}

extern "C" int gather_dequant_screen_wide_median(const int8_t* q, const float* scale,
                                                 const int32_t* idx, const uint8_t* valid,
                                                 const float* self_vals, float* out, int m, int k,
                                                 int d, int nblk, void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_wide<true>(screen::CodewordRows{q, scale, nblk},
                                   screen::SlotList{idx, valid, m, k}, self_vals, out, m, d, k, 0,
                                   false, static_cast<cudaStream_t>(stream));
}
