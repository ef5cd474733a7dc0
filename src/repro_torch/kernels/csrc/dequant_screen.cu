// Fused int8-codeword screening kernels for Hopper (sm_90a), dense layout.
//
// dequant_screen_trimmed_mean_dense replaces the TPU kernel
//   src/repro/kernels/dequant_screen.py::dequant_trimmed_mean_pallas  (BRIDGE-T)
// dequant_screen_median_dense replaces the TPU kernel
//   src/repro/kernels/dequant_screen.py::dequant_median_pallas        (BRIDGE-M)
//
// What they compute.  Every sender i broadcasts one int8 codeword (the
// codec's wire layout, src/repro/comm/codec.py): codes q[i, :] and one
// (scale, zero) pair per 128 coordinates, scale [M, S, 2], S = ceil(d/128).
// Node j screens the codewords of its in-neighbors (adj[j, i] != 0) against
// its own uncompressed value self_vals[j, :] and writes out[j, :], without
// the decoded float32 bank ever reaching device memory.  Each value is
// decoded as dequant.cu decodes it, fma(q, scale, zero) rounded once, NaN
// (an inf scale times a zero code, whatever a wire attack left in the scale
// field) -> +inf; the screen is screen.cu's, unchanged: the same kernels
// (screen_dense.cuh), instantiated over a codeword row source instead of a
// float one.  So the output equals dequant followed by
// screen_trimmed_mean_dense / screen_median_dense bit for bit, by
// construction.  The median joins the node's own value, sanitized, as one
// more row, as the TPU kernel's _fused_med_kernel does.  Codes of -128,
// which no honest codec writes and garbage_codeword does, decode as any
// other.
//
// Design.  One block per (node j, 128 coordinates): since a block is one
// codec scale block, every listed row has one (scale, zero) pair in it, at
// index blockIdx.x.  After the block compacts the neighbor list, its
// threads copy the listed rows' pairs into shared memory (one a thread);
// each thread then reads one int8 code per row of its column, decodes it
// with the staged pair and sorts the column in registers with the Batcher
// network of its row-count bucket (screen_dense.cuh).  The simple
// first version reads one byte a thread (a warp reads 32 consecutive
// bytes of a row); wider loads are later work.
//
// What bounds it on an H100.  At the dense path's M = 50, d = 7850 on
// erdos_renyi(50, 0.5, 4): operations, like screen.cu (the Batcher network
// over each node's true in-degree, plus one FMA per gathered value); the
// bytes are a quarter of the float screen's codes, M*d int8, plus
// M*d*4 of self_vals in and M*d*4 out.
//
// Above 128 rows to sort the wrappers launch the wide path
// (screen_wide.cuh) over the same codeword source, whose scale pairs it
// stages for every listed row of a block: dequant_screen_wide_trimmed_mean_dense
// and dequant_screen_wide_median_dense.

#include <stdint.h>

#include "screen_dense.cuh"
#include "screen_wide.cuh"

namespace {

bool scales_fit(int d, int nblk) {
  return nblk == (d + screen::kScaleBlock - 1) / screen::kScaleBlock;
}

}  // namespace

// C entry points (bound with ctypes).  Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for a shape it does not take: more than
// 128 rows to sort, or nblk != ceil(d / 128)).
extern "C" int dequant_screen_trimmed_mean_dense(const int8_t* q, const float* scale,
                                                 const uint8_t* adj, const float* self_vals,
                                                 float* out, int m, int d, int nblk, int b,
                                                 void* stream) {
  if (m < 1 || d < 1 || !scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_trimmed_mean_dense(screen::CodewordRows{q, scale, nblk}, adj, self_vals,
                                           out, m, d, b, false, static_cast<cudaStream_t>(stream));
}

extern "C" int dequant_screen_median_dense(const int8_t* q, const float* scale,
                                           const uint8_t* adj, const float* self_vals, float* out,
                                           int m, int d, int nblk, void* stream) {
  if (m < 1 || d < 1 || !scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_median_dense(screen::CodewordRows{q, scale, nblk}, adj, self_vals, out,
                                     m, d, static_cast<cudaStream_t>(stream));
}

// The wide path over the same operands (screen_wide.cuh), for any M up to
// screen::kWideMaxRows rows to sort.
extern "C" int dequant_screen_wide_trimmed_mean_dense(const int8_t* q, const float* scale,
                                                      const uint8_t* adj, const float* self_vals,
                                                      float* out, int m, int d, int nblk, int b,
                                                      void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_wide<false>(screen::CodewordRows{q, scale, nblk},
                                    screen::DenseList{adj, m}, self_vals, out, m, d, m, b, false,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" int dequant_screen_wide_median_dense(const int8_t* q, const float* scale,
                                                const uint8_t* adj, const float* self_vals,
                                                float* out, int m, int d, int nblk, void* stream) {
  if (!scales_fit(d, nblk)) return cudaErrorInvalidValue;
  return screen::launch_wide<true>(screen::CodewordRows{q, scale, nblk},
                                   screen::DenseList{adj, m}, self_vals, out, m, d, m, 0, false,
                                   static_cast<cudaStream_t>(stream));
}
