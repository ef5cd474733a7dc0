// Pairwise squared distances for Hopper (sm_90a) — the hot loop of
// BRIDGE-K (Krum) and BRIDGE-B (Bulyan).
//
// pairwise_sq_dists replaces the TPU kernel
//   src/repro/kernels/krum.py::pairwise_sq_dists_pallas
// and pairwise_sq_dists_batched is the same kernel with a leading batch
// axis: [B, n, d] -> [B, n, n], the per-node distances of Krum and Bulyan
// over the network runtime's mailbox views (batch = node, each node's W
// views and its own value, n = W + 1) and the grids' per-cell distances
// (batch = experiment).
//
// What it computes.  For the rows of x [n, d] (float32): the Gram
// g = x x^T accumulated in float32 with fused multiply-adds, then
// d2[i, j] = max(g_ii + g_jj - 2 g_ij, 0) with NaN kept.  The TPU kernel
// accumulates the Gram over 512-wide coordinate blocks on the MXU and takes
// the norms from jnp.diagonal(gram); this one takes them from the same FMA
// chain as its own Gram's diagonal.
//
// Contracts.  (1) d2[i, i] == 0 exactly for a finite row: the norm g_ii is
// the chain __fmaf_rn(x_ik, x_ik, acc) over the same coordinates in the same
// order, from the same +0, summed over the same splits in the same order as
// the Gram's diagonal entry, so the two are equal bit for bit, and
// (g + g) - 2g is exact.  (2) d2 is symmetric bit for bit: an entry below
// the diagonal tiles is written from its mirror's value, and inside a
// diagonal tile g_ij and g_ji are the same chain with the FMA's operands
// swapped, which rounds the same.  (3) NaN propagates: the clamp is
// v < 0 ? 0 : v (fmaxf would give 0 for a NaN, where jnp.maximum keeps it).
// (4) The summation order is a function of [n, d] alone: the split plan
// (kernels/pairwise.py, split_plan) is; a batch element runs under the plan
// of its own [n, d], so it equals the unbatched kernel of its rows bit for
// bit, whatever B.  No tensor cores and no TF32: the
// H100 has no full-fp32 mma, and the reference's dot is float32.
//
// Batch axis.  Element e's rows are read at strides (s_batch, s_row) in
// elements, its row n - 1 optionally from self + e s_self (the node's own
// value appended without forming the [B, n, d] stack, 273 MB at M = 512,
// K = 16); s_batch may be 0 (a broadcast expanded over the receivers, read
// in place).  Two bodies take it, both under split_plan(n, d)'s order
// (kernels/pairwise.py batch_plan picks one from [B, n, d]): the cluster
// body (pairwise_sq_dists_batched: elements on gridDim.z, a cluster's
// blocks all on one element, with a loop past 65535; each element's tiles
// are the unbatched kernel's) and, for elements of at most 17 rows, the
// batch body (pairwise_sq_dists_batch_body, below the cluster body: a
// block of four warps an element, no cluster, a lane a split).  The copies
// are as wide as every row start allows (the row and batch strides,
// self's stride and the base addresses).
//
// Design: one launch, no workspace.
//   A *unit* of 64 threads (an 8 x 8 grid) computes one T x T output tile,
//   T = 8R (R = 4, 6 or 8), over one split of the coordinates: R x R
//   outputs a thread, rows ty + 8a and columns tx + 8b.  A block holds four
//   units (four splits of one tile, 8 warps) and asks for more than half an
//   SM's shared memory, so every block has an SM of its own; a
//   thread-block cluster of C <= 8 blocks along gridDim.y holds the tile's
//   4C splits, and gridDim.x walks the upper-triangle tile pairs.  Each unit
//   streams its split through a 3-stage ring of 32-coordinate chunks in
//   shared memory, filled with cp.async (16-, 8- or 4-byte copies, the
//   widest that the row stride and x's address allow: at d = 7850 the
//   stride, 31,400 bytes, is 8-byte aligned only, so no pad and no copy of
//   x), so two chunks' loads are in flight while one chunk's FMAs run.
//   Rows are staged row-major with a 36-float pitch: per 4 coordinates a
//   thread reads its R rows and R columns as float4s (conflict-free), then
//   runs the R x R FMAs one coordinate at a time, R^2 independent FMAs
//   between two of one chain.  Along the way each unit takes the norms of
//   its tile's 2T rows from the staged chunks, the same chain as the Gram's
//   diagonal, so no tile waits on another.  At the end each unit parks its
//   partial tile and norms in its shared memory, the cluster synchronises,
//   and every block reduces a stripe of the tile's rows over the 4C
//   partials in ascending split order (IEEE adds, the first split's value
//   first), all of an element's loads through distributed shared memory
//   (mapa / ld.shared::cluster) in flight at once, then writes d2 and, for
//   an off-diagonal tile, its mirror.  The plan (R, C and the split length,
//   a multiple of 32) comes from the shape alone: kernels/pairwise.py
//   split_plan, which models the waves of clusters the card's GPCs hold and
//   the measured time of a chunk for each R.
//
// What bounds it on an H100.  The function reads x once (n d 4 bytes) and
// writes n^2 floats; it does 2 n^2 d operations (half of them for the upper
// triangle this kernel computes).  At the dense path's [50, 7850] and
// [100, 7850] the bytes (1.6 / 3.2 MB, ~0.5 / 1 us) and the operations are
// both far below a launch's latency: the kernel is latency-bound there, so
// its plan cuts d into the most splits (32, over 8 SMs a tile) and the
// time is the chunks' and the cluster reduction's latency.  At the sparse
// path's [512, 7850] the operations bound it (2.06 GFLOP for the upper
// triangle, ~31 us at 67 TFLOP/s): the plan takes 48 x 48 tiles, whose 66
// pairs in clusters of 2 fill the 132 SMs in one wave; its FMAs then run at
// about a third of the SMs' fp32 peak, the shared-memory loads (2R float4s
// per 4R^2 FMAs) and their latency taking the rest (PERF.md).
//
// The batch body's design and bound.  Many small elements (sparse views
// K / B: B = 512 nodes of n = 17 rows) are bound by bytes: 273 MB, 82 us
// at 3.35 TB/s, against 1.2 GFLOP of FMAs for the upper triangles.  The
// cluster body spends a cluster of eight 120 KB blocks (an SM each) on an
// element, 16 clusters at once, 32 waves at B = 512.  The batch body
// gives an element a block of 104 KB (two an SM, all 512 elements in two
// waves) and the register reuse a Gram of 17 rows allows: a lane holds a
// split's chains of a quarter of the 153 entries and reads each staged
// coordinate of the 17 rows once for them (17 loads a coordinate against
// 38 FMAs), where a thread with an R x R tile loads 2R for R^2.  Its
// stages are 16 coordinates of all 32 splits (64 contiguous bytes of each
// split's row), so its reads of device memory come in pieces of 64 bytes
// at 32 places a row; each copy asks L2 to fetch 128 bytes, and three
// stages keep two in flight.  It runs at about 1.4 TB/s at B = 512
// (PERF.md), below the card's streaming rate: device memory serves such
// pieces more slowly than whole rows, and the FMAs, whose staged loads
// each warp repeats, overlap the copies only in part.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnit = 64;           // threads of a unit: an 8 x 8 grid
constexpr int kUnits = 4;           // units (splits of one tile) a block: 8 warps
constexpr int kChunk = 32;          // coordinates per ring stage
constexpr int kPitch = kChunk + 4;  // floats per staged row: float4 reads conflict-free
constexpr int kStages = 3;          // ring depth
constexpr int kMaxCluster = 8;      // blocks of a cluster (portable size)
constexpr int kMaxRows = 32 * 1024;
// Dynamic shared memory a block asks for at least: more than half an SM's
// 228 KB, so no SM holds two blocks and every block has an SM of its own.
constexpr int kMinSmemBytes = 120 * 1024;

// Shared-memory layout of one unit: the ring (kStages x [A rows | B rows]),
// which the partial tile [T][T + 1] reuses after the loop, then the norms of
// the tile's A rows and B rows [2T].
template <int R>
struct Geometry {
  static constexpr int kTile = 8 * R;
  static constexpr int kStageFloats = 2 * kTile * kPitch;
  static constexpr int kRingFloats = kStages * kStageFloats;
  static constexpr int kPartPitch = kTile + 1;
  static constexpr int kPartFloats = kTile * kPartPitch;
  static constexpr int kNormOffset = kRingFloats > kPartFloats ? kRingFloats : kPartFloats;
  static constexpr int kUnitFloats = kNormOffset + 2 * kTile;
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One cp.async of BYTES (4, 8 or 16) bytes; zero-fills the destination when
// !ok (src-size 0: nothing is read from src).
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src), "n"(BYTES),
               "r"(ok ? BYTES : 0)
               : "memory");
}

// Barrier over one unit's 64 threads (named barrier 1 + g).
__device__ __forceinline__ void unit_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(kUnit) : "memory");
}

// The shared::cluster address of `p` (this block's shared memory) in the
// block of cluster rank `rank`, and a 4-byte load from such an address.
__device__ __forceinline__ uint32_t cluster_address(const float* p, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))), "r"(rank));
  return out;
}

__device__ __forceinline__ float load_cluster(uint32_t at) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(at) : "memory");
  return v;
}

constexpr int kBatch = 2;  // elements a thread reduces at once

// out[q] = the float at offset at[q] of every split's unit, summed over the
// splits in ascending order (IEEE adds, the first split's value first);
// at[q] < 0 is skipped.  Every load is issued before the first add, so the
// splits cost one round trip, not one each.
template <int S>
__device__ __forceinline__ void split_sums(const uint32_t (&unit_at)[S], int splits,
                                           const int (&at)[kBatch], float (&out)[kBatch]) {
  float v[kBatch][S];
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s < splits && at[q] >= 0) v[q][s] = load_cluster(unit_at[s] + 4u * at[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kBatch; ++q) {
    out[q] = v[q][0];
#pragma unroll
    for (int s = 1; s < S; ++s) {
      if (s < splits) out[q] = __fadd_rn(out[q], v[q][s]);
    }
  }
}

// One batch element's rows: row i at base + i s_row (elements), and, with
// kSelf, the element's own value as its last row (i == last).
template <bool kSelf>
struct ElementRows {
  const float* base;
  long long s_row;
  const float* self;
  int last;
  __device__ __forceinline__ const float* row(int i) const {
    if (kSelf && i == last) return self;
    return base + i * s_row;
  }
};

// Stage rows [row0, row0 + T) x coordinates [kc, kc + kChunk) of the
// element's rows into dst[r * kPitch + c], V floats a copy.  Coordinates
// >= k1 (the split's or the row's end) are zeros, and fma(0, 0, acc) == acc
// for every accumulator these chains hold; rows >= n repeat row n - 1, so
// every address is valid without a predicate a copy: their outputs and
// norms are never written.
template <int T, int V, class Rows>
__device__ __forceinline__ void stage_rows(float* dst, const Rows& rows, int row0, int n, int kc,
                                           int k1, int t) {
  constexpr int kPerRow = kChunk / V;        // copies a row
  constexpr int kRowStep = kUnit / kPerRow;  // rows between a thread's copies
  static_assert(kUnit % kPerRow == 0 && T % kRowStep == 0, "every thread issues the same copies");
  const int r0 = t / kPerRow, c = (t % kPerRow) * V;
  const bool in_split = kc + c < k1;
  float* at = dst + r0 * kPitch + c;
#pragma unroll
  for (int i = 0; i < T / kRowStep; ++i) {
    const int row = min(row0 + r0 + i * kRowStep, n - 1);
    cp_async<4 * V>(at + i * kRowStep * kPitch, in_split ? rows.row(row) + kc + c : rows.base,
                    in_split);
  }
}

template <int T, class Rows>
__device__ __forceinline__ void stage_chunk(float* stage, bool diag, const Rows& rows, int row0,
                                            int col0, int n, int kc, int k1, int vec, int t) {
  float* sb = stage + T * kPitch;
  if (vec == 4) {
    stage_rows<T, 4>(stage, rows, row0, n, kc, k1, t);
    if (!diag) stage_rows<T, 4>(sb, rows, col0, n, kc, k1, t);
  } else if (vec == 2) {
    stage_rows<T, 2>(stage, rows, row0, n, kc, k1, t);
    if (!diag) stage_rows<T, 2>(sb, rows, col0, n, kc, k1, t);
  } else {
    stage_rows<T, 1>(stage, rows, row0, n, kc, k1, t);
    if (!diag) stage_rows<T, 1>(sb, rows, col0, n, kc, k1, t);
  }
}

// One batch element: the d2 tile pair of this cluster over its rows.
template <int R, class Rows>
__device__ __forceinline__ void pairwise_tile(const Rows& src, float* __restrict__ out, int n,
                                              int d, int tiles, int split_len, int vec,
                                              float* smem, cg::cluster_group& cluster, int csize,
                                              int rank) {
  using Geo = Geometry<R>;
  constexpr int T = Geo::kTile;
  // upper-triangle tile pair (bi <= bj) of this cluster
  int p = blockIdx.x, bi = 0, row_len = tiles;
  while (p >= row_len) {
    p -= row_len;
    ++bi;
    --row_len;
  }
  const int bj = bi + p;
  const bool diag = bi == bj;
  const int row0 = bi * T, col0 = bj * T;

  const int g = threadIdx.x / kUnit, t = threadIdx.x % kUnit;
  const int ty = t / 8, tx = t % 8;
  const int split = rank * kUnits + g;
  const int k0 = min(d, split * split_len), k1 = min(d, k0 + split_len);
  const int chunks = (k1 - k0 + kChunk - 1) / kChunk;
  float* unit = smem + g * Geo::kUnitFloats;

  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) acc[a][b] = 0.f;
  }
  // norms of the rows t + 64 q of [A rows | B rows] (kNorms a thread)
  constexpr int kNorms = (2 * T + kUnit - 1) / kUnit;
  float nrm[kNorms];
#pragma unroll
  for (int q = 0; q < kNorms; ++q) nrm[q] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < chunks)
      stage_chunk<T>(unit + s * Geo::kStageFloats, diag, src, row0, col0, n, k0 + s * kChunk, k1,
                     vec, t);
    cp_async_commit();
  }
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<kStages - 2>();
    unit_sync(g);
    // refill the slot chunk ch - 1 used, which every thread of the unit has
    // finished with (the barrier above)
    const int next = ch + kStages - 1;
    if (next < chunks)
      stage_chunk<T>(unit + (next % kStages) * Geo::kStageFloats, diag, src, row0, col0, n,
                     k0 + next * kChunk, k1, vec, t);
    cp_async_commit();

    const float* sa = unit + (ch % kStages) * Geo::kStageFloats;
    const float* sb = diag ? sa : sa + T * kPitch;
#pragma unroll
    for (int c = 0; c < kChunk; c += 4) {
      // this thread's R rows and R columns at coordinates c..c+3, then one
      // coordinate at a time over all R x R accumulators (R^2 independent
      // FMAs between two of one chain)
      float4 av[R], bv[R];
#pragma unroll
      for (int a = 0; a < R; ++a)
        av[a] = *reinterpret_cast<const float4*>(sa + (ty + 8 * a) * kPitch + c);
#pragma unroll
      for (int b = 0; b < R; ++b)
        bv[b] = *reinterpret_cast<const float4*>(sb + (tx + 8 * b) * kPitch + c);
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = __fmaf_rn(av[a].x, bv[b].x, acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = __fmaf_rn(av[a].y, bv[b].y, acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = __fmaf_rn(av[a].z, bv[b].z, acc[a][b]);
      }
#pragma unroll
      for (int a = 0; a < R; ++a) {
#pragma unroll
        for (int b = 0; b < R; ++b) acc[a][b] = __fmaf_rn(av[a].w, bv[b].w, acc[a][b]);
      }
    }
#pragma unroll
    for (int q = 0; q < kNorms; ++q) {
      const int r = t + kUnit * q;
      if (2 * T % kUnit == 0 || r < 2 * T) {
        const float* row = r < T ? sa + r * kPitch : sb + (r - T) * kPitch;
#pragma unroll
        for (int c = 0; c < kChunk; c += 4) {
          const float4 f = *reinterpret_cast<const float4*>(row + c);
          nrm[q] = __fmaf_rn(f.x, f.x, nrm[q]);
          nrm[q] = __fmaf_rn(f.y, f.y, nrm[q]);
          nrm[q] = __fmaf_rn(f.z, f.z, nrm[q]);
          nrm[q] = __fmaf_rn(f.w, f.w, nrm[q]);
        }
      }
    }
  }
  cp_async_wait<0>();
  unit_sync(g);

  // park the partial tile and the norms for the cluster's reduction
#pragma unroll
  for (int a = 0; a < R; ++a) {
#pragma unroll
    for (int b = 0; b < R; ++b) unit[(ty + 8 * a) * Geo::kPartPitch + tx + 8 * b] = acc[a][b];
  }
#pragma unroll
  for (int q = 0; q < kNorms; ++q) {
    if (2 * T % kUnit == 0 || t + kUnit * q < 2 * T) unit[Geo::kNormOffset + t + kUnit * q] = nrm[q];
  }
  cluster.sync();

  // this block's stripe of tile rows [r0, r1), reduced over the splits in
  // ascending order: split s lives in unit s % 4 of cluster rank s / 4
  constexpr int kMaxSplits = kMaxCluster * kUnits;
  const int splits = csize * kUnits;
  uint32_t unit_at[kMaxSplits];  // each split's unit, as a shared::cluster address
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    unit_at[s] =
        s < splits ? cluster_address(smem + (s % kUnits) * Geo::kUnitFloats, s / kUnits) : 0u;
  const int stripe = (T + csize - 1) / csize;
  const int r0 = min(T, rank * stripe), r1 = min(T, r0 + stripe), rows = r1 - r0;
  float* vals = smem + kUnits * Geo::kUnitFloats;  // [stripe][T] the stripe's d2
  float* norm = vals + stripe * T;            // [rows + T] g_ii of the stripe, then g_jj
  for (int e0 = threadIdx.x; e0 < rows + T; e0 += kBatch * blockDim.x) {
    int at[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      at[q] = e < rows + T ? Geo::kNormOffset + (e < rows ? r0 + e : T + e - rows) : -1;
    }
    float sum[kBatch];
    split_sums(unit_at, splits, at, sum);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (at[q] >= 0) norm[e0 + q * blockDim.x] = sum[q];
    }
  }
  __syncthreads();
  const int cells = rows * T;
  for (int e0 = threadIdx.x; e0 < cells; e0 += kBatch * blockDim.x) {
    int at[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      at[q] = e < cells ? (r0 + e / T) * Geo::kPartPitch + e % T : -1;
    }
    float gram[kBatch];
    split_sums(unit_at, splits, at, gram);
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + q * blockDim.x;
      if (e < cells) {
        const int i = e / T, j = e % T;
        const float v = __fsub_rn(__fadd_rn(norm[i], norm[rows + j]), __fmul_rn(2.f, gram[q]));
        const float d2 = v < 0.f ? 0.f : v;
        vals[i * T + j] = d2;
        const int r = row0 + r0 + i, c = col0 + j;
        if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = d2;
      }
    }
  }
  if (!diag) {
    // the mirror tile below the diagonal: consecutive threads on a row of it
    __syncthreads();
    for (int e = threadIdx.x; e < cells; e += blockDim.x) {
      const int j = e / rows, i = e % rows;
      const int r = col0 + j, c = row0 + r0 + i;
      if (r < n && c < n) out[static_cast<size_t>(r) * n + c] = vals[i * T + j];
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// Where the batch elements' rows are (elements): element e's row i < n - 1
// at x + e s_batch + i s_row, and its row n - 1 there too or, with kSelf,
// at self + e s_self.  s_batch may be 0 (a broadcast over the batch).
struct Batch {
  const float* x;
  long long s_batch, s_row;
  const float* self;
  long long s_self;
  int count;  // B
};

template <int R, bool kSelf>
__global__ void __launch_bounds__(kUnit * kUnits)
pairwise_kernel(Batch batch, float* __restrict__ out, int n, int d, int tiles, int split_len,
                int vec) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // batch elements along gridDim.z, a cluster's blocks all on the same
  // ones: the loop past 65535 elements runs as often in each, and the
  // cluster barrier that ends an element guards its shared memory
  for (int e = blockIdx.z; e < batch.count; e += gridDim.z) {
    const ElementRows<kSelf> rows{batch.x + e * batch.s_batch, batch.s_row,
                                  batch.self + (kSelf ? e * batch.s_self : 0), n - 1};
    pairwise_tile<R>(rows, out + static_cast<size_t>(e) * n * n, n, d, tiles, split_len, vec,
                     smem, cluster, csize, rank);
  }
}

constexpr int kMaxGridZ = 65535;  // batch elements a launch spreads over gridDim.z

template <int R, bool kSelf>
cudaError_t launch(const Batch& batch, float* out, int n, int d, int cluster, int split_len,
                   int vec, cudaStream_t s) {
  using Geo = Geometry<R>;
  constexpr int T = Geo::kTile;
  const int tiles = (n + T - 1) / T;
  const int stripe = (T + cluster - 1) / cluster;
  const size_t need =
      sizeof(float) * (static_cast<size_t>(kUnits) * Geo::kUnitFloats + stripe * T + stripe + T);
  const size_t bytes = need > kMinSmemBytes ? need : kMinSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(pairwise_kernel<R, kSelf>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles) * (tiles + 1) / 2, cluster,
                     batch.count < kMaxGridZ ? batch.count : kMaxGridZ);
  cfg.blockDim = dim3(kUnit * kUnits, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pairwise_kernel<R, kSelf>, batch, out, n, d, tiles, split_len,
                           vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The widest copy (4, 2 or 1 floats) every row start allows: each row
// start's address a multiple of 4 V bytes and d of V.
bool aligned(const Batch& b, int d, int v) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(b.x);
  const uintptr_t self = reinterpret_cast<uintptr_t>(b.self);
  return d % v == 0 && x % (4 * v) == 0 && b.s_row % v == 0 && b.s_batch % v == 0 &&
         (b.self == nullptr || (self % (4 * v) == 0 && b.s_self % v == 0));
}

int run(const Batch& batch, float* out, int n, int d, int rows_per_thread, int cluster,
        int split_len, void* stream) {
  const long long splits = static_cast<long long>(kUnits) * cluster;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(batch.x);
  if (n < 1 || n > kMaxRows || d < 1 || batch.count < 1 || cluster < 1 ||
      cluster > kMaxCluster || split_len < 1 || split_len % kChunk != 0 ||
      splits * split_len < d || addr % 4 != 0 || batch.s_row < 0 || batch.s_batch < 0 ||
      (batch.self != nullptr && (reinterpret_cast<uintptr_t>(batch.self) % 4 != 0 || n < 2)))
    return cudaErrorInvalidValue;
  const int vec = aligned(batch, d, 4) ? 4 : aligned(batch, d, 2) ? 2 : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool self = batch.self != nullptr;
  switch (rows_per_thread) {
    case 4: return self ? launch<4, true>(batch, out, n, d, cluster, split_len, vec, s)
                        : launch<4, false>(batch, out, n, d, cluster, split_len, vec, s);
    case 6: return self ? launch<6, true>(batch, out, n, d, cluster, split_len, vec, s)
                        : launch<6, false>(batch, out, n, d, cluster, split_len, vec, s);
    case 8: return self ? launch<8, true>(batch, out, n, d, cluster, split_len, vec, s)
                        : launch<8, false>(batch, out, n, d, cluster, split_len, vec, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The batch body, for elements of at most 17 rows: a block of four warps,
// no cluster, runs one element, a lane a split.  Lane s of every warp runs
// split s's chains over the split's coordinates and the zeros that pad
// them to whole chunks of 32, exactly as the cluster body's unit of that
// split does; the element's 153 entries (the upper triangle of 17 rows
// with its diagonal, the norms) are dealt round-robin to the warps, entry
// e to warp e % 4.  Then each entry's lane values are summed in ascending
// split order (split 0's value first, then IEEE adds), so it is
// split_plan's sum bit for bit, the cluster body's.  A stage holds 16
// coordinates of every split of the element's rows, copied by the block
// together: eight threads copy a split's row's 64 contiguous bytes, so a
// copy instruction reads four pieces of device memory, and each copy asks
// L2 to fetch the 128 bytes around it, so the next stage of that split's
// row comes from L2.
// ---------------------------------------------------------------------------

constexpr int kLanes = 32;         // a warp; split_plan's splits are at most 4 x 8 = 32
constexpr int kWarps = 4;          // warps of a batch block
constexpr int kBatchThreads = kWarps * kLanes;
constexpr int kOneTile = 17;       // rows of an element the batch body takes at most
constexpr int kStageCoords = 16;   // coordinates of every split a stage
constexpr int kCoordPairs = kStageCoords / 2;
constexpr int kBatchStages = 3;    // ring depth: two stages in flight while one computes
constexpr int kEntries = kOneTile * (kOneTile + 1) / 2;
constexpr int kSlots = (kEntries + kWarps - 1) / kWarps;          // chains a lane
constexpr int kStageFloats = kOneTile * kStageCoords * kLanes;    // [row][pair][split'][2]
constexpr int kFoldPitch = kLanes + 1;                            // [slot][split]
constexpr int kFoldFloats = kWarps * kSlots * kFoldPitch;         // then the totals
static_assert(kFoldFloats + kEntries <= kBatchStages * kStageFloats, "the fold fits the ring");

// A batch element's rows with its own value, if any, as row `last`.
struct BatchRows {
  const float* base;
  long long s_row;
  const float* self;  // null: every row from base
  int last;
  __device__ __forceinline__ const float* row(int i) const {
    return self != nullptr && i == last ? self : base + i * s_row;
  }
};

// index of (i, j), i <= j, in the upper triangle
__device__ __forceinline__ int tri(int i, int j) {
  return i * kOneTile - i * (i - 1) / 2 + (j - i);
}

// A split's coordinates: [k0, k1), run to kpad (whole chunks of 32, as the
// cluster body's unit runs it); a split past the last is empty.
struct SplitRange {
  int k0, k1, kpad;
  __device__ __forceinline__ SplitRange(int s, int splits, int split_len, int d) {
    k0 = s < splits ? min(d, s * split_len) : d;
    k1 = min(d, k0 + split_len);
    kpad = k0 + (k1 - k0 + kChunk - 1) / kChunk * kChunk;
  }
};

// Where split s's coordinate pair p of a staged row sits among the row's 32
// float2s of that pair: XOR-swizzled, so that a copy instruction (four
// splits, eight pairs each) writes two wavefronts and a lane's read (one
// pair, every split) none twice.
__device__ __forceinline__ int swizzle(int s, int p) { return s ^ (4 * p); }

// cp_async, asking L2 to fetch the 128 bytes around the source.
template <int BYTES>
__device__ __forceinline__ void cp_async_l2(float* dst, const float* src, bool ok) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], %2, %3;\n" ::"r"(at), "l"(src),
               "n"(BYTES), "r"(ok ? BYTES : 0)
               : "memory");
}

// Stage q into dst: coordinates k0 + 16q .. + 16 of each split of each row
// (rows >= n are skipped: no entry that is written reads them; so is a
// split's stage past its padded end), those >= k1 zeros.  Thread t copies
// coordinate pair t % 8 of splits t / 8 and t / 8 + 16, V floats a copy.
template <int V>
__device__ __forceinline__ void stage_element(float* dst, const BatchRows& rows, int n, int q,
                                              const SplitRange (&range)[2], int t) {
  const int p = t % kCoordPairs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = t / kCoordPairs + h * (kBatchThreads / kCoordPairs);
    const int kc = range[h].k0 + q * kStageCoords;
    if (kc >= range[h].kpad) continue;
    const int k = kc + 2 * p, k1 = range[h].k1;
#pragma unroll
    for (int r = 0; r < kOneTile; ++r) {
      if (r >= n) break;
      const float* src = rows.row(r);
      float* at = dst + ((r * kCoordPairs + p) * kLanes + swizzle(s, p)) * 2;
      if constexpr (V == 2) {
        cp_async_l2<8>(at, k < k1 ? src + k : rows.base, k < k1);
      } else {
        cp_async_l2<4>(at, k < k1 ? src + k : rows.base, k < k1);
        cp_async_l2<4>(at + 1, k + 1 < k1 ? src + k + 1 : rows.base, k + 1 < k1);
      }
    }
  }
}

// One stage of this lane's split into warp W's chains, coordinates
// ascending: entry e = W + 4 slot, the product of rows i <= j.
template <int W>
__device__ __forceinline__ void stage_fmas(const float* stage, int lane, float (&acc)[kSlots]) {
#pragma unroll
  for (int p = 0; p < kCoordPairs; ++p) {
    float2 v[kOneTile];
#pragma unroll
    for (int r = 0; r < kOneTile; ++r) {
      const int at = (r * kCoordPairs + p) * kLanes + swizzle(lane, p);
      v[r] = *reinterpret_cast<const float2*>(stage + at * 2);
    }
    int e = 0;
#pragma unroll
    for (int i = 0; i < kOneTile; ++i) {
#pragma unroll
      for (int j = i; j < kOneTile; ++j, ++e) {
        if (e % kWarps == W) {
          float& a = acc[e / kWarps];
          a = __fmaf_rn(v[i].x, v[j].x, a);
          a = __fmaf_rn(v[i].y, v[j].y, a);
        }
      }
    }
  }
}

template <int V>
__device__ __forceinline__ void batch_element(const BatchRows& src, float* __restrict__ out, int n,
                                              int d, int splits, int split_len, float* smem) {
  const int t = threadIdx.x, warp = t / kLanes, lane = t % kLanes;
  const SplitRange mine(lane, splits, split_len, d);
  const SplitRange copied[2] = {
      SplitRange(t / kCoordPairs, splits, split_len, d),
      SplitRange(t / kCoordPairs + kBatchThreads / kCoordPairs, splits, split_len, d)};
  const int stages = split_len / kStageCoords;

  float acc[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) acc[k] = 0.f;

  auto stage = [&](int q) {
    if (q < stages)
      stage_element<V>(smem + (q % kBatchStages) * kStageFloats, src, n, q, copied, t);
    cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < kBatchStages - 1; ++q) stage(q);
  for (int q = 0; q < stages; ++q) {
    __syncthreads();  // every warp has run stage q - 1, whose slot this refills
    stage(q + kBatchStages - 1);
    cp_async_wait<kBatchStages - 1>();
    __syncthreads();  // stage q's copies, by the whole block
    if (mine.k0 + q * kStageCoords < mine.kpad) {
      const float* st = smem + (q % kBatchStages) * kStageFloats;
      switch (warp) {
        case 0: stage_fmas<0>(st, lane, acc); break;
        case 1: stage_fmas<1>(st, lane, acc); break;
        case 2: stage_fmas<2>(st, lane, acc); break;
        default: stage_fmas<3>(st, lane, acc); break;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // each warp's chains into fold[warp][slot][split]; lane l sums slots l,
  // l + 32, ... over the splits in ascending order into totals[entry]
  float* fold = smem + warp * kSlots * kFoldPitch;
  float* totals = smem + kFoldFloats;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) fold[k * kFoldPitch + lane] = acc[k];
  __syncwarp();
  for (int k = lane; k < kSlots; k += kLanes) {
    const int e = k * kWarps + warp;
    if (e >= kEntries) continue;
    const float* f = fold + k * kFoldPitch;
    float v = f[0];
    for (int s = 1; s < splits; ++s) v = __fadd_rn(v, f[s]);
    totals[e] = v;
  }
  __syncthreads();
  // d2[i, j]: the Gram from the upper triangle (g_ij and g_ji are one
  // chain), the norms from its diagonal
  for (int e = t; e < n * n; e += kBatchThreads) {
    const int i = e / n, j = e % n;
    const float g = totals[tri(min(i, j), max(i, j))];
    const float v = __fsub_rn(__fadd_rn(totals[tri(i, i)], totals[tri(j, j)]), __fmul_rn(2.f, g));
    out[e] = v < 0.f ? 0.f : v;
  }
  // the next element's stages refill the shared memory this epilogue read
  __syncthreads();
}

template <int V>
__global__ void __launch_bounds__(kBatchThreads)
pairwise_batch_kernel(Batch batch, float* __restrict__ out, int n, int d, int splits,
                      int split_len) {
  extern __shared__ __align__(16) float smem[];
  for (long long e = blockIdx.x; e < batch.count; e += gridDim.x) {
    const BatchRows rows{batch.x + e * batch.s_batch, batch.s_row,
                         batch.self == nullptr ? nullptr : batch.self + e * batch.s_self, n - 1};
    batch_element<V>(rows, out + static_cast<size_t>(e) * n * n, n, d, splits, split_len, smem);
  }
}

template <int V>
cudaError_t launch_batch(const Batch& batch, float* out, int n, int d, int splits, int split_len,
                         cudaStream_t s) {
  const size_t bytes = sizeof(float) * kBatchStages * kStageFloats;
  cudaError_t err = cudaFuncSetAttribute(pairwise_batch_kernel<V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  pairwise_batch_kernel<V><<<batch.count, kBatchThreads, bytes, s>>>(batch, out, n, d, splits,
                                                                     split_len);
  return cudaGetLastError();
}

int run_batch(const Batch& batch, float* out, int n, int d, int splits, int split_len,
              void* stream) {
  if (n < 1 || n > kOneTile || d < 1 || batch.count < 1 || splits < 1 || splits > kLanes ||
      split_len < kChunk || split_len % kChunk != 0 ||
      static_cast<long long>(splits) * split_len < d ||
      reinterpret_cast<uintptr_t>(batch.x) % 4 != 0 || batch.s_row < 0 || batch.s_batch < 0 ||
      (batch.self != nullptr && (reinterpret_cast<uintptr_t>(batch.self) % 4 != 0 || n < 2)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aligned(batch, d, 2) ? launch_batch<2>(batch, out, n, d, splits, split_len, s)
                              : launch_batch<1>(batch, out, n, d, splits, split_len, s);
}

}  // namespace

// C entry points (bound with ctypes).  The plan (kernels/pairwise.py,
// split_plan): R rows and columns a thread (4, 6 or 8), a cluster of C <= 8
// blocks, and 4 C splits of split_len coordinates (a multiple of 32) that
// cover d (trailing splits may be empty: they add +0).  Each returns the
// launch's cudaError_t (cudaErrorInvalidValue for a shape or plan it does
// not take).
//
// x [n, d] float32 contiguous, out [n, n].
extern "C" int pairwise_sq_dists(const float* x, float* out, int n, int d, int rows_per_thread,
                                 int cluster, int split_len, void* stream) {
  const Batch one{x, 0, d, nullptr, 0, 1};
  return run(one, out, n, d, rows_per_thread, cluster, split_len, stream);
}

// The batched form: out [B, n, n] contiguous, element e's d2 among its rows
// (the Batch layout above: strides in elements, the coordinate stride 1;
// self_vals null, or each element's own value as row n - 1), each element
// under the plan of [n, d], so it equals pairwise_sq_dists of its rows
// bit for bit.
extern "C" int pairwise_sq_dists_batched(const float* x, long long s_batch, long long s_row,
                                         const float* self_vals, long long s_self, float* out,
                                         int batch, int n, int d, int rows_per_thread,
                                         int cluster, int split_len, void* stream) {
  const Batch b{x, s_batch, s_row, self_vals, s_self, batch};
  return run(b, out, n, d, rows_per_thread, cluster, split_len, stream);
}

// The batch body of the batched form (same operands), for elements of at
// most 17 rows: a block of four warps, no cluster, an element, a lane a
// split; the order is split_plan's (splits, split_len: the plan's 4C and
// split length), so each element equals the cluster body's, and
// pairwise_sq_dists of its rows, bit for bit.
extern "C" int pairwise_sq_dists_batch_body(const float* x, long long s_batch, long long s_row,
                                            const float* self_vals, long long s_self, float* out,
                                            int batch, int n, int d, int splits, int split_len,
                                            void* stream) {
  const Batch b{x, s_batch, s_row, self_vals, s_self, batch};
  return run_batch(b, out, n, d, splits, split_len, stream);
}
