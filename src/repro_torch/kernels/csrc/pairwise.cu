// Pairwise squared distances for Hopper (sm_90a) — the hot loop of
// BRIDGE-K (Krum) and BRIDGE-B (Bulyan).
//
// pairwise_sq_dists replaces the TPU kernel
//   src/repro/kernels/krum.py::pairwise_sq_dists_pallas
//
// What it computes.  For the rows of x [n, d] (float32): the Gram
// g = x x^T accumulated in float32 with fused multiply-adds, then
// d2[i, j] = max(g_ii + g_jj - 2 g_ij, 0) with NaN kept.  The TPU kernel
// accumulates the Gram over 512-wide coordinate blocks on the MXU and takes
// the norms from jnp.diagonal(gram); so does this one, from its own Gram.
//
// Contracts.  (1) d2[i, i] == 0 exactly for a finite row: the norms g_ii
// are the Gram's own diagonal (the same FMA chain, read back, not a
// separate reduction), and (g + g) - 2g is exact.  (2) d2 is symmetric bit
// for bit: a lower-triangle entry is read from its mirror in the upper
// triangle, and on a diagonal tile g_ij and g_ji are the same chain of
// __fmaf_rn(x_ik, x_jk, acc) with its operands swapped, which rounds the
// same.  (3) NaN propagates: the clamp is v < 0 ? 0 : v (fmaxf would give 0
// for a NaN, where jnp.maximum keeps it).  No tensor cores and no TF32:
// the H100 has no full-fp32 mma, and the reference's dot is float32.
//
// Design: two launches.
//   gram_partial: one block per (upper-triangle 64x64 output tile, split of
//     the coordinates).  256 threads, 4x4 outputs each (rows ty*4 + a,
//     columns tx*4 + b), 32-coordinate chunks staged through shared memory
//     coordinate-major with an XOR swizzle (see swizzle()): per coordinate
//     a thread reads its 4 rows and its 4 columns as two float4 loads (3
//     shared-memory wavefronts a warp for 16 FMAs a thread), and the
//     transposed stores are free of bank conflicts.  Each split
//     accumulates its coordinates in ascending order from +0 and writes its
//     partial Gram to the workspace [splits, n, n].
//   sq_dists_epilogue: one thread per (i, j) sums the splits in ascending
//     order (IEEE adds), reads g_ii and g_jj the same way, and writes d2.
//   The split count comes from the shapes alone (the Python wrapper's
//   plan), so the summation order is fixed for a given [n, d].
//
// What bounds it on an H100.  The function reads x once (n d 4 bytes) and
// writes n^2 floats; it does 2 n^2 d operations (half of them for the upper
// triangle).  At the dense path's [50, 7850] the bytes (1.6 MB, ~0.5 us)
// and the operations (~0.6 us at 67 TFLOP/s) are both far below the two
// launches' cost; at the sparse path's [512, 7850] the operations bound it
// (4.1 GFLOP, ~61 us; ~31 us for the upper triangle this kernel computes).
// The inner loop issues 2 float4 shared-memory loads for 16 FMAs a thread,
// so the FMA units, not the shared-memory pipe, should be its limit; the
// chunk's loads are not overlapped with its FMAs (no double buffering), and
// larger register tiles or wgmma-era designs are left for later work.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 32;     // coordinates per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSub = 16;       // thread grid edge

// Shared-memory layout of a staged chunk: coordinate-major, [kChunk][kTile],
// each coordinate's 64 rows as 16 float4 slots, slot r/4 stored at
// (r/4) ^ (k % 16).  A thread's four rows (or columns) are then one aligned
// float4, and the transposed stores below hit 32 distinct banks.
__device__ __forceinline__ int swizzle(int r, int k) {
  return (((r >> 2) ^ (k & 15)) << 2) | (r & 3);
}

__global__ void __launch_bounds__(kThreads)
gram_partial_kernel(const float* __restrict__ x, float* __restrict__ part, int n, int d,
                    int tiles, int split_len) {
  // upper-triangle tile pair (bi <= bj) of this block
  int p = blockIdx.x, bi = 0, row_len = tiles;
  while (p >= row_len) {
    p -= row_len;
    ++bi;
    --row_len;
  }
  const int bj = bi + p;
  const int row0 = bi * kTile, col0 = bj * kTile;
  const int k0 = blockIdx.y * split_len;
  const int k1 = min(d, k0 + split_len);

  __shared__ __align__(16) float sa[kChunk][kTile];
  __shared__ __align__(16) float sb[kChunk][kTile];
  const int tx = threadIdx.x % kSub, ty = threadIdx.x / kSub;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  }

  for (int kc = k0; kc < k1; kc += kChunk) {
    // 64 rows x 32 coordinates per tile; a warp loads 8 consecutive
    // coordinates of 4 rows (32-byte runs) and stores them transposed,
    // conflict-free through the swizzle.  Out-of-range entries are 0, and
    // fma(0, 0, acc) == acc for every accumulator this chain can hold.
    for (int u = threadIdx.x; u < kTile * kChunk; u += kThreads) {
      const int r = (u >> 7) * 4 + ((u >> 3) & 3), c = ((u >> 5) & 3) * 8 + (u & 7);
      const int k = kc + c, ra = row0 + r, rb = col0 + r, at = swizzle(r, c);
      sa[c][at] = (ra < n && k < k1) ? x[static_cast<size_t>(ra) * d + k] : 0.f;
      sb[c][at] = (rb < n && k < k1) ? x[static_cast<size_t>(rb) * d + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[c][swizzle(ty * 4, c)]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[c][swizzle(tx * 4, c)]);
      const float va[4] = {a4.x, a4.y, a4.z, a4.w};
      const float vb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = __fmaf_rn(va[a], vb[b], acc[a][b]);
      }
    }
    __syncthreads();
  }

  float* out = part + static_cast<size_t>(blockIdx.y) * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty * 4 + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = col0 + tx * 4 + b;
      if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = acc[a][b];
    }
  }
}

// The Gram entry (a, b), tile(a) <= tile(b), summed over the splits in order.
__device__ __forceinline__ float gram_at(const float* __restrict__ part, int n, int splits, int a,
                                         int b) {
  const size_t at = static_cast<size_t>(a) * n + b, stride = static_cast<size_t>(n) * n;
  float g = part[at];
  for (int s = 1; s < splits; ++s) g = __fadd_rn(g, part[s * stride + at]);
  return g;
}

__global__ void sq_dists_epilogue(const float* __restrict__ part, float* __restrict__ out, int n,
                                  int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * n) return;
  const int i = idx / n, j = idx % n;
  const bool lower = i / kTile > j / kTile;  // only upper-triangle tiles were computed
  const float g = gram_at(part, n, splits, lower ? j : i, lower ? i : j);
  const float gi = gram_at(part, n, splits, i, i);
  const float gj = gram_at(part, n, splits, j, j);
  const float v = __fsub_rn(__fadd_rn(gi, gj), __fmul_rn(2.f, g));
  out[idx] = v < 0.f ? 0.f : v;
}

}  // namespace

// C entry point (bound with ctypes): x [n, d] float32 contiguous, part a
// workspace of splits * n * n floats, out [n, n].  split_len * splits must
// cover d.  Returns cudaGetLastError() after the two launches
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int pairwise_sq_dists(const float* x, float* part, float* out, int n, int d,
                                 int split_len, int splits, void* stream) {
  if (n < 1 || d < 1 || split_len < 1 || splits < 1 ||
      static_cast<long long>(split_len) * splits < d || n > 32 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + kTile - 1) / kTile;
  const dim3 grid(tiles * (tiles + 1) / 2, splits);
  gram_partial_kernel<<<grid, kThreads, 0, s>>>(x, part, n, d, tiles, split_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int threads = 256;
  const long long total = static_cast<long long>(n) * n;
  sq_dists_epilogue<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
      part, out, n, splits);
  return cudaGetLastError();
}
