// int8 codeword decode for Hopper (sm_90a).
//
// dequant and dequant_carry replace the TPU kernel
//   src/repro/kernels/dequant_screen.py::dequant_pallas
//
// What they compute.  An int8 wire codeword (src/repro/comm/codec.py) is
// q [n, d] int8 codes and one affine pair (scale, zero) per SCALE_BLOCK = 128
// coordinates, scale [n, S, 2] float32 with S = ceil(d / 128).
//   * dequant: out = q * scale + zero, rounded once (__fmaf_rn), with NaN (an
//     inf scale times a zero code) mapped to +inf, as dequant_pallas does.
//   * dequant_carry: the decode the trainer runs, with the codec's
//     error-feedback carry (src/repro/comm/exchange.py::decode_bank) in the
//     same pass: x_hat = est + decoded and resid = target - decoded.  For a
//     zero of exactly 0 (every codeword the codec writes) each output is ONE
//     fused multiply-add, x_hat = fma(q, s, est) and resid = fma(-q, s,
//     target): the reference's program folds the constant zero away and XLA
//     contracts the multiply into the add, so a decode whose output was
//     added afterwards could not equal it.  Any other zero decodes first,
//     dec = fma(q, s, zero), then adds and subtracts, as the reference does
//     when the zero is a run-time value.  No NaN guard, as in decode_bank.
//     The fused form is taken only where the caller says the zero is the
//     encoder's constant (zero_folded != 0): a wire attack that rewrites the
//     scale field (scale_abuse) makes the reference's zero a run-time value
//     on every row, and then every row decodes first.
// Intrinsics (__fmaf_rn, __fadd_rn, __fsub_rn) fix every rounding, so
// nvcc's own contraction cannot change one.
//
// Design.  One block per (row, 128 coordinates): the block is exactly one
// scale block, so it reads its single (scale, zero) pair once, through
// shared memory; one thread per coordinate, neighbouring threads on
// neighbouring bytes and floats.
//
// What bounds it on an H100: bytes.  The carry form reads 1 + 4 + 4 bytes
// and writes 8 per coordinate (plus 8 bytes per 128 for the pair): at
// n = 512, d = 7850 about 68 MB, 0.02 ms at 3.35 TB/s; it does two FMAs per
// coordinate, 8M operations, far under the float32 rate.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // SCALE_BLOCK: coordinates per (scale, zero) pair

__device__ __forceinline__ void load_pair(const float* __restrict__ scale, int row, int blk,
                                          int nblk, float* s_pair) {
  if (threadIdx.x < 2) {
    s_pair[threadIdx.x] = scale[(static_cast<size_t>(row) * nblk + blk) * 2 + threadIdx.x];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kBlock)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, int d, int nblk) {
  __shared__ float s_pair[2];
  const int row = blockIdx.y;
  load_pair(scale, row, blockIdx.x, nblk, s_pair);
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= d) return;
  const size_t at = static_cast<size_t>(row) * d + c;
  const float v = __fmaf_rn(static_cast<float>(q[at]), s_pair[0], s_pair[1]);
  out[at] = isnan(v) ? CUDART_INF_F : v;
}

__global__ void __launch_bounds__(kBlock)
dequant_carry_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                     const float* __restrict__ est, const float* __restrict__ target,
                     float* __restrict__ x_hat, float* __restrict__ resid, int d, int nblk,
                     bool zero_folded) {
  __shared__ float s_pair[2];
  const int row = blockIdx.y;
  load_pair(scale, row, blockIdx.x, nblk, s_pair);
  const int c = blockIdx.x * kBlock + threadIdx.x;
  if (c >= d) return;
  const size_t at = static_cast<size_t>(row) * d + c;
  const float qf = static_cast<float>(q[at]);
  const float s = s_pair[0];
  const float z = s_pair[1];
  if (zero_folded && z == 0.0f) {
    x_hat[at] = __fmaf_rn(qf, s, est[at]);
    resid[at] = __fmaf_rn(-qf, s, target[at]);
  } else {
    const float dec = __fmaf_rn(qf, s, z);
    x_hat[at] = __fadd_rn(est[at], dec);
    resid[at] = __fsub_rn(target[at], dec);
  }
}

}  // namespace

// C entry points (bound with ctypes); each returns cudaGetLastError() after
// its launch.  nblk is the number of scale pairs per row, ceil(d / 128).
extern "C" int dequant(const int8_t* q, const float* scale, float* out, int n, int d, int nblk,
                       void* stream) {
  if (n < 1 || d < 1 || nblk != (d + kBlock - 1) / kBlock) return cudaErrorInvalidValue;
  const dim3 grid(nblk, n);
  dequant_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(q, scale, out, d, nblk);
  return cudaGetLastError();
}

extern "C" int dequant_carry(const int8_t* q, const float* scale, const float* est,
                             const float* target, float* x_hat, float* resid, int n, int d,
                             int nblk, int zero_folded, void* stream) {
  if (n < 1 || d < 1 || nblk != (d + kBlock - 1) / kBlock) return cudaErrorInvalidValue;
  const dim3 grid(nblk, n);
  dequant_carry_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scale, est, target, x_hat, resid, d, nblk, zero_folded != 0);
  return cudaGetLastError();
}
