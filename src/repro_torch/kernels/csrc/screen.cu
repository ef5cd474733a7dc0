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
//     c = count - 2 b_eff + 1 — or, with `recip`, multiplied by the
//     correctly rounded 1/c (__frcp_rn), which is what XLA compiles the
//     division into when c folds to a constant: ByRDiE's block screen,
//     whose adjacency is closed over and whose b is static
//     (src/repro/core/byrdie.py; tools/xla_divisor_forms.py);
//   * median: the node's own value joins as one more (sanitized) row; the
//     result is 0.5f * (o[(c-1)/2] + o[c/2]) over the c = count + 1 rows.
// Up to 64 rows that order is the reference's exactly (its sequential
// sum_rows), so the output equals it bit for bit up to the sign of a zero.
// Intrinsics (__fadd_rn, __fdiv_rn, __fmul_rn) keep the compiler from
// contracting or approximating any step.  The kernels live in
// screen_dense.cuh, templated on how a thread reads a row (here: float
// rows); dequant_screen.cu instantiates them over int8 codewords.  The sort
// network and the two reductions live in screen_sort.cuh.
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

#include "screen_dense.cuh"

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape it does not take); the
// caller raises on anything but cudaSuccess.  Rows to sort: m for the
// trimmed mean, m + 1 for the median; at most screen::kMaxRows.  A nonzero
// `recip` selects the trimmed mean's reciprocal form.
extern "C" int screen_trimmed_mean_dense(const float* w, const uint8_t* adj,
                                         const float* self_vals, float* out, int m, int d, int b,
                                         int recip, void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  return screen::launch_trimmed_mean_dense(screen::FloatRows{w}, adj, self_vals, out, m, d, b,
                                           recip != 0, static_cast<cudaStream_t>(stream));
}

extern "C" int screen_median_dense(const float* w, const uint8_t* adj, const float* self_vals,
                                   float* out, int m, int d, void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  return screen::launch_median_dense(screen::FloatRows{w}, adj, self_vals, out, m, d,
                                     static_cast<cudaStream_t>(stream));
}
