// int8 codeword decode for Hopper (sm_90a).
//
// dequant and dequant_carry replace the TPU kernel
//   src/repro/kernels/dequant_screen.py::dequant_pallas
//
// What they compute.  An int8 wire codeword (src/repro/comm/codec.py) is
// q [n, d] int8 codes and one affine pair (scale, zero) per SCALE_BLOCK = 128
// coordinates, scale [n, S, 2] float32 with S = ceil(d / 128).
//   * dequant: out = q * scale + zero, rounded once (__fmaf_rn), with NaN (an
//     inf scale times a zero code) mapped to +inf, as dequant_pallas does;
//     with keep_nan != 0 a NaN stays NaN: the plain product q * scale that
//     src/repro/core/gossip.py decodes its int8 gossip with (zero 0).
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
// What bounds them on an H100: bytes.  dequant reads 1 byte and writes 4 a
// coordinate (plus 8 bytes per 128 for the pair): at n = 512, d = 7850
// about 20 MB, 0.0061 ms at 3.35 TB/s, and one FMA a coordinate, far
// under the float32 rate.  The carry form reads 1 + 4 + 4 bytes and writes
// 8 a coordinate, about 68 MB, 0.020 ms.
//
// Design of dequant.  It walks the flat [n * d] index in groups of 4 codes:
// each a 4-byte load of q and a 16-byte store of out, consecutive threads
// on consecutive groups, so every load and store instruction of a warp
// covers 128 and 512 contiguous bytes.  The grid fills the card and no
// more (at most 8 blocks of 256 threads an SM, one group a thread a pass,
// a grid-stride loop over the rest): about 4 groups a thread at
// [512, 7850], where a block per row and 128 coordinates made 31,744
// blocks of one byte and one float a thread; at the main path's [50, 3925]
// one group a thread over 192 blocks.  Rows of 7850 codes are not 16-byte
// aligned, so the groups cannot follow rows: a thread divides a group's
// first flat index by d (32-bit when n * d fits), then steps its row and
// coordinate across the group (over a row boundary, several for d < 4),
// reading the (scale, zero) pair through the read-only cache whenever the
// coordinate enters another scale block; no shared memory and no barrier.
// The groups start at q's first 4-byte boundary; the codes before it (a
// view at a storage offset) and the last (n * d - head) % 4 after the
// groups are the same kernel's scalar head and tail, which block 0
// decodes.  Where out is not 16-byte aligned at a group's start (q
// misaligned by other than a multiple of 4 bytes), the stores are scalar.
// A first version with one 16-byte load of q and four 16-byte stores a
// thread left each store instruction of a warp 64-byte strided and ran
// slower than the kernel it replaced.
//
// Design of dequant_carry: one block per (row, 128 coordinates), exactly one
// scale block, so it reads its single (scale, zero) pair once, through
// shared memory; one thread per coordinate, neighbouring threads on
// neighbouring bytes and floats.  On an H100 it runs at about 58% of its
// bytes bound, so it keeps this design.  The rows ride on gridDim.y, which
// CUDA caps at 65535; above that (the network runtime's per-link decode of
// [M W, d] rows, M W = 65536 at a dense M = 256) a block takes every
// 65535th row, so any n runs.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;  // SCALE_BLOCK: coordinates per (scale, zero) pair

static_assert(kBlock == 128, "c >> 7 is a coordinate's scale block");
constexpr int kGroup = 4;         // codes a dequant group: one 4-byte load, one 16-byte store
constexpr int kVecThreads = 256;  // threads a dequant block
constexpr int kBlocksPerSm = 8;   // dequant blocks an SM holds (2048 threads)

__device__ __forceinline__ float2 pair_at(const float* __restrict__ scale, size_t row, int blk,
                                          int nblk) {
  const float* p = scale + (row * nblk + blk) * 2;
  return make_float2(__ldg(p), __ldg(p + 1));
}

// KeepNan: a NaN product stays NaN; otherwise it becomes +inf.
template <bool KeepNan>
__device__ __forceinline__ float decode(int code, float2 sz) {
  const float v = __fmaf_rn(static_cast<float>(code), sz.x, sz.y);
  return !KeepNan && isnan(v) ? CUDART_INF_F : v;
}

// Element e of the flat [n * d] codeword, alone.
template <bool KeepNan>
__device__ __forceinline__ void dequant_one(const int8_t* __restrict__ q,
                                            const float* __restrict__ scale,
                                            float* __restrict__ out, size_t e, int d, int nblk) {
  const size_t row = e / d;
  const int c = static_cast<int>(e - row * d);
  out[e] = decode<KeepNan>(q[e], pair_at(scale, row, c >> 7, nblk));
}

// Group g decodes codes head + 4 g .. head + 4 g + 3, thread t of the grid
// groups t, t + threads, ...; block 0 also decodes the `head` codes before
// the groups and the ones after the last.  Index: the flat index's type,
// 32-bit when n * d fits; KeepNan as in decode.
template <class Index, bool KeepNan>
__global__ void __launch_bounds__(kVecThreads)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, int d, int nblk, Index total, int head, Index groups,
               bool vec_store) {
  const Index threads = static_cast<Index>(gridDim.x) * kVecThreads;
  for (Index g = static_cast<Index>(blockIdx.x) * kVecThreads + threadIdx.x; g < groups;
       g += threads) {
    const Index e0 = head + g * kGroup;
    const unsigned word = __ldg(reinterpret_cast<const unsigned*>(q + e0));
    Index row = e0 / static_cast<Index>(d);
    int c = static_cast<int>(e0 - row * static_cast<Index>(d));
    float2 sz = pair_at(scale, row, c >> 7, nblk);
    float f[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      f[k] = decode<KeepNan>(static_cast<int>(word << (24 - 8 * k)) >> 24, sz);  // byte k, signed
      if (k + 1 < kGroup) {
        if (++c == d) {
          c = 0;
          ++row;
          sz = pair_at(scale, row, 0, nblk);
        } else if ((c & (kBlock - 1)) == 0) {
          sz = pair_at(scale, row, c >> 7, nblk);
        }
      }
    }
    if (vec_store) {
      *reinterpret_cast<float4*>(out + e0) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kGroup; ++k) out[e0 + k] = f[k];
    }
  }
  if (blockIdx.x == 0) {
    const Index after = head + groups * kGroup;
    if (threadIdx.x < head) dequant_one<KeepNan>(q, scale, out, threadIdx.x, d, nblk);
    if (threadIdx.x < total - after) {
      dequant_one<KeepNan>(q, scale, out, after + threadIdx.x, d, nblk);
    }
  }
}

template <class Index, bool KeepNan>
int launch_dequant(const int8_t* q, const float* scale, float* out, int d, int nblk,
                   long long total, cudaStream_t s) {
  // the codes before q's first 4-byte boundary
  const long long to4 = (4 - reinterpret_cast<uintptr_t>(q) % 4) % 4;
  const int head = static_cast<int>(to4 < total ? to4 : total);
  const long long groups = (total - head) / kGroup;
  const bool vec_store = (reinterpret_cast<uintptr_t>(out) + 4ull * head) % 16 == 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const long long needed = (groups + kVecThreads - 1) / kVecThreads;
  const long long blocks = needed < 1 ? 1 : needed < most ? needed : most;
  dequant_kernel<Index, KeepNan><<<static_cast<unsigned>(blocks), kVecThreads, 0, s>>>(
      q, scale, out, d, nblk, static_cast<Index>(total), head, static_cast<Index>(groups),
      vec_store);
  return cudaGetLastError();
}

// gridDim.y's limit: a block takes rows blockIdx.y, blockIdx.y + gridDim.y, ...
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kBlock)
dequant_carry_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                     const float* __restrict__ est, const float* __restrict__ target,
                     float* __restrict__ x_hat, float* __restrict__ resid, int n, int d,
                     int nblk, bool zero_folded) {
  __shared__ float s_pair[2];
  const int c = blockIdx.x * kBlock + threadIdx.x;
  for (int row = blockIdx.y; row < n; row += gridDim.y) {
    if (threadIdx.x < 2) {
      s_pair[threadIdx.x] = scale[(static_cast<size_t>(row) * nblk + blockIdx.x) * 2 + threadIdx.x];
    }
    __syncthreads();
    if (c < d) {
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
    __syncthreads();  // the pair is rewritten for the block's next row
  }
}

template <bool KeepNan>
int dispatch_dequant(const int8_t* q, const float* scale, float* out, int d, int nblk,
                     long long total, cudaStream_t s) {
  return total < (1ll << 32)
             ? launch_dequant<unsigned, KeepNan>(q, scale, out, d, nblk, total, s)
             : launch_dequant<size_t, KeepNan>(q, scale, out, d, nblk, total, s);
}

}  // namespace

// C entry points (bound with ctypes); each returns cudaGetLastError() after
// its launch.  nblk is the number of scale pairs per row, ceil(d / 128).
extern "C" int dequant(const int8_t* q, const float* scale, float* out, int n, int d, int nblk,
                       int keep_nan, void* stream) {
  if (n < 1 || d < 1 || nblk != (d + kBlock - 1) / kBlock) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(n) * d;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keep_nan ? dispatch_dequant<true>(q, scale, out, d, nblk, total, s)
                  : dispatch_dequant<false>(q, scale, out, d, nblk, total, s);
}

extern "C" int dequant_carry(const int8_t* q, const float* scale, const float* est,
                             const float* target, float* x_hat, float* resid, int n, int d,
                             int nblk, int zero_folded, void* stream) {
  if (n < 1 || d < 1 || nblk != (d + kBlock - 1) / kBlock) return cudaErrorInvalidValue;
  const dim3 grid(nblk, n < kMaxGridY ? n : kMaxGridY);
  dequant_carry_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      q, scale, est, target, x_hat, resid, n, d, nblk, zero_folded != 0);
  return cudaGetLastError();
}
