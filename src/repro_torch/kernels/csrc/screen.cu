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
//   * each column is sorted ascending (Batcher network in registers);
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
// one thread per coordinate.  The block compacts adj[j, :] into a neighbor
// list in shared memory in parallel (a ballot per warp, popc prefix counts)
// and derives count and b_eff there; each thread gathers its column
// straight from w (coalesced across the warp), so the [M, M, d] tensor is
// never formed.  The column lives in a register array sized to the block's
// own row count, rounded up to a bucket (8, 16, ..., 64, 80, ..., 128):
// count is uniform over the block, so one branch picks the bucket without
// divergence, and the column is sorted by Batcher's odd-even merge network
// for exactly that bucket (the reference's schedule, generated by
// kernels/networks.py), every index a compile-time constant: at M = 50
// the in-degrees (17-31 on erdos_renyi(50, 0.5)) fall in the 24- and
// 32-row buckets, 132 and 191 compare-exchanges, where a bitonic network
// padded to the next power of two above M would run 672.
//
// What bounds it on an H100.  Bytes: w is read M times through L2 (each
// node reads its neighbors' rows); device memory sees M*d*4 bytes of w and
// of self_vals in and M*d*4 out.  Operations: Batcher's network over the
// bucket, about n/4 log^2 n compare-exchanges (two fp32 min/max each) per
// column per node, plus the kept ranks' adds.  At the main path's shapes
// (M = 50, d = 7850) the operations over the true in-degrees are the larger
// bound (the bucket adds at most 7 +inf rows); the gathers' L2 latency and
// the network's instruction count are what the kernel spends its time on.
//
// Above 128 rows to sort the wrappers launch the wide path instead
// (screen_wide.cuh: the same arithmetic, each column sorted by a warp in
// registers),
// through screen_wide_trimmed_mean_dense and screen_wide_median_dense.

#include <stdint.h>

#include "screen_dense.cuh"
#include "screen_wide.cuh"

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape it does not take); the
// caller raises on anything but cudaSuccess.  Rows to sort: m for the
// trimmed mean, m + 1 for the median; at most screen::kMaxRows.  A nonzero
// `recip` selects the trimmed mean's reciprocal form.
//
// The experiment axis: w, self_vals and out are [E, M, d] contiguous
// (E = experiments, 1 for the unbatched form); experiment e's adjacency
// starts e s_mask bytes into adj (s_mask 0: one [M, M] every experiment
// shares), and it trims b_e[e] (b_e: int32 [E] on the card) or, with a
// null b_e, b.
namespace {
screen::FloatRows float_rows(const float* w, int m, int d) {
  return screen::FloatRows{w, static_cast<long long>(m) * d};
}
}  // namespace

extern "C" int screen_trimmed_mean_dense(const float* w, const uint8_t* adj,
                                         const float* self_vals, float* out, int m, int d, int b,
                                         int recip, int experiments, long long s_mask,
                                         const int* b_e, void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  return screen::launch_trimmed_mean_dense(float_rows(w, m, d), adj, self_vals, out, m, d, b,
                                           recip != 0, static_cast<cudaStream_t>(stream),
                                           screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int screen_median_dense(const float* w, const uint8_t* adj, const float* self_vals,
                                   float* out, int m, int d, int experiments, long long s_mask,
                                   void* stream) {
  if (m < 1 || d < 1) return cudaErrorInvalidValue;
  return screen::launch_median_dense(float_rows(w, m, d), adj, self_vals, out, m, d,
                                     static_cast<cudaStream_t>(stream),
                                     screen::Experiments{experiments, s_mask, nullptr});
}

// The wide path over the same operands (screen_wide.cuh), for any M up to
// screen::kWideMaxRows rows to sort (M for the trimmed mean, M + 1 for the
// median).
extern "C" int screen_wide_trimmed_mean_dense(const float* w, const uint8_t* adj,
                                              const float* self_vals, float* out, int m, int d,
                                              int b, int recip, int experiments,
                                              long long s_mask, const int* b_e, void* stream) {
  return screen::launch_wide<false>(float_rows(w, m, d), screen::DenseList{adj, m}, self_vals,
                                    out, m, d, m, b, recip != 0,
                                    static_cast<cudaStream_t>(stream),
                                    screen::Experiments{experiments, s_mask, b_e});
}

extern "C" int screen_wide_median_dense(const float* w, const uint8_t* adj, const float* self_vals,
                                        float* out, int m, int d, int experiments, long long s_mask,
                                   void* stream) {
  return screen::launch_wide<true>(float_rows(w, m, d), screen::DenseList{adj, m}, self_vals,
                                   out, m, d, m, 0, false, static_cast<cudaStream_t>(stream),
                                   screen::Experiments{experiments, s_mask, nullptr});
}
