// The tile kernel of the gather screens (K <= 63 slots a node), shared by
// gather_screen.cu (rows of the broadcast, or of its int8 codewords, named
// by an [M, K] neighbor table) and views_screen.cu (the runtime's mailbox
// views [M, W, d], each node's own rows, named by their slot).  A template
// on the row source (screen_sort.cuh): FloatRows, CodewordRows, ViewRows.
//
// Design (the tile kernel, K <= 63).  A block of 256 threads owns a tile of
// T consecutive nodes and walks a range of coordinate chunks of C (a plan
// from kernels/gather_screen.py, tile_plan: T, C, the number of chunk
// ranges a tile is cut into, so that the grid is about one wave of the
// card's SMs, and the columns a lane sorts at once).
//   * Prologue, once a block: thread s loads slot s of the tile's T x K
//     table slots, and each node's valid slots become a list of rows in
//     shared memory, in slot order.
//   * A warp takes one node and 32 adjacent coordinates (64 for two columns
//     a lane) of a chunk at a time: each lane reads its column straight
//     from L2 (the lanes of a warp read 32 adjacent words of one row),
//     sorts it in registers and writes its result.  Up to 24 rows the
//     network is Batcher's for exactly the node's row count (for_rows;
//     above, the 8-row buckets of for_bucket), uniform over the warp, and
//     the median keeps of it only the compare-exchanges that reach the two
//     middle ranks (median_select).  The kernel is compiled for the bucket
//     of K (K + 1 for the median), so its register array is that bucket's,
//     not the largest one's.
//   * Codeword blocks stage each chunk's (scale, zero) pair of every listed
//     row in shared memory once (a chunk lies in one scale block: C divides
//     128), in two buffers, so one barrier a chunk orders their writes and
//     reads.
// Each kernel has a decide form (kDecide: float rows and views), the same
// output bit for bit and the per-slot decisions of screen_sort.cuh's
// Decide, which the trust layer and the trace's forensics read.
// Above 63 slots the wrappers launch the wide path instead
// (screen_wide.cuh): the same arithmetic, each column sorted by a warp in
// registers.

#pragma once

#include <stdint.h>

#include "screen_sort.cuh"

namespace screen {

constexpr int kTileThreads = 256;
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kMaxTileSlots = kTileThreads;  // T * K: one slot a thread in the prologue
constexpr int kMaxTileNodes = 32;
constexpr int kMaxListed = 2 * kMaxTileSlots;  // T * NMAX: the nodes' lists, NMAX apart
constexpr int kRegisterSlots = 63;             // K the tile kernel takes: K + 1 <= 64 rows

// A value of a listed row, read straight from L2: a float row's word, a
// codeword row's code decoded with the row's (scale, zero) pair `sz` for
// the chunk (staged by the block), or a mailbox view's word.
__device__ __forceinline__ float load_value(const FloatRows& r, int row, int d, int c,
                                            float2) {
  return sanitize(__ldg(r.w + static_cast<size_t>(row) * d + c));
}

__device__ __forceinline__ float load_value(const CodewordRows& r, int row, int d, int c,
                                            float2 sz) {
  const float qf = static_cast<float>(__ldg(r.q + static_cast<size_t>(row) * d + c));
  return sanitize(__fmaf_rn(qf, sz.x, sz.y));
}

// A node's mailbox views: the slot's word at its strides.
__device__ __forceinline__ float load_value(const NodeViews& r, int row, int, int c,
                                            float2) {
  return sanitize(__ldg(r.v + row * r.s_slot + c));
}

// The (scale, zero) pairs of the tile's listed rows for scale block blk.
__device__ __forceinline__ void stage_pairs(const CodewordRows& r, const int* s_node,
                                            const int* s_cnt, int nt, int nmax, int blk,
                                            float2* pairs) {
  for (int e = threadIdx.x; e < nt * nmax; e += kTileThreads) {
    const int t = e / nmax;
    if (e - t * nmax < s_cnt[t]) {
      pairs[e] = __ldg(reinterpret_cast<const float2*>(r.scale) +
                       static_cast<size_t>(s_node[e]) * r.nblk + blk);
    }
  }
}

// Blocks an SM the registers must allow: two, but one where a column's
// loads in flight would spill under two (a 64-bit address and a value
// each: codeword rows from 48 rows, float rows at 64).
template <int NMAX, class Rows>
constexpr int tile_min_blocks() {
  return NMAX <= (Rows::kStaged ? 32 : 48) ? 2 : 1;
}

// COLS columns a lane: coordinates 32 apart of one node, so one network.
// kDecide: the decide form (float rows and views only, one column a lane),
// which also records the decisions (screen_sort.cuh, Decide): after a
// column's network a lane holds its kept window and, per listed row, the
// warp counts its trimmed columns with a ballot (decide_column: from the
// unsorted column it kept in registers, up to kDecideRegs rows, above by
// re-reading the row from L2) into counts its lanes hold; the block sums
// them in shared memory, by node and listed row, and ends in one integer
// atomicAdd a listed row into dec.counts at the row's slot.
template <int NMAX, bool kMedian, int COLS, class Rows, bool kDecide = false>
__global__ void __launch_bounds__(kTileThreads, (tile_min_blocks<NMAX, Rows>()))
gather_tile_kernel(Rows rows, const int32_t* __restrict__ idx, const uint8_t* __restrict__ valid,
                   const float* __restrict__ self_vals, float* __restrict__ out, int m, int k,
                   int d, int b, int tile, int chunk, int segments, Experiments ex,
                   Decide dec) {
  constexpr bool kCodes = Rows::kStaged;
  static_assert(!(kDecide && kCodes), "the decide form reads float rows or views");
  static_assert(!kDecide || COLS == 1, "the decide form sorts one column a lane");
  __shared__ int s_slot[kMaxTileSlots];  // slot -> row, -1 when padded
  __shared__ int s_node[kMaxListed];     // node t's valid slots' rows, at t * NMAX
  __shared__ int s_cnt[kMaxTileNodes];   // node -> valid slots
  // decide: each listed row's slot and its trimmed columns, at t * NMAX
  __shared__ int s_lslot[kDecide ? kMaxListed : 1];
  __shared__ int s_trim[kDecide ? kMaxListed : 1];
  // codeword blocks: every listed row's scale pair for the chunk, two chunks
  __shared__ float2 s_pair[kCodes ? 2 * kMaxListed : 1];

  const int j0 = blockIdx.x / segments * tile, seg = blockIdx.x % segments;
  const int nt = min(tile, m - j0);
  const int chunks = (d + chunk - 1) / chunk;
  const int ch_begin = static_cast<int>(static_cast<long long>(seg) * chunks / segments);
  const int ch_end = static_cast<int>(static_cast<long long>(seg + 1) * chunks / segments);
  const int s = threadIdx.x, lane = s & 31, warp = s >> 5;
  // experiment blockIdx.y (screen_sort.cuh, Experiments): its rows, self
  // values, outputs, b and table mask (the indices are shared)
  const int e = blockIdx.y;
  valid += e * ex.s_mask;
  const Rows exp_rows = rows.experiment(e);
  const size_t exp_at = static_cast<size_t>(e) * m * d;
  const int be = ex.b_of(e, b);

  // prologue: the tile's slots, then each node's list of rows in slot order
  // (no index table: the views' slot itself)
  int row = -1;
  if (s < nt * k) {
    const size_t at = static_cast<size_t>(j0) * k + s;
    if (valid[at] != 0) row = idx != nullptr ? min(max(idx[at], 0), m - 1) : s % k;
  }
  s_slot[s] = row;
  __syncthreads();
  if (s < nt) {  // the list's tail holds row 0, so any of its NMAX entries can be read
    int cnt = 0;
    for (int i = 0; i < k; ++i) {
      const int r = s_slot[s * k + i];
      if (r >= 0) {
        if constexpr (kDecide) s_lslot[s * NMAX + cnt] = i;
        s_node[s * NMAX + cnt++] = r;
      }
    }
    for (int i = cnt; i < NMAX; ++i) s_node[s * NMAX + i] = 0;
    s_cnt[s] = cnt;
  }
  if constexpr (kDecide) {
    for (int x = s; x < nt * NMAX; x += kTileThreads) s_trim[x] = 0;
  }
  __syncthreads();

  const int subs = chunk / (32 * COLS);
  for (int ci = ch_begin; ci < ch_end; ++ci) {
    const float2* pairs = s_pair + ((ci - ch_begin) & 1) * kMaxListed;
    if constexpr (kCodes) {
      // one barrier a chunk: the other buffer's readers finished before it
      stage_pairs(exp_rows, s_node, s_cnt, nt, NMAX, ci * chunk / kScaleBlock,
                  s_pair + ((ci - ch_begin) & 1) * kMaxListed);
      __syncthreads();
    }
    for (int task = warp; task < nt * subs; task += kTileWarps) {
      const int t = task / subs;
      const int cl = (task % subs) * 32 * COLS + lane;
      const int cnt = s_cnt[t];
      const int* list = s_node + t * NMAX;
      const auto src = exp_rows.at(j0 + t);  // the row source bound to the node
      float own[COLS];
#pragma unroll
      for (int q = 0; q < COLS; ++q) {
        // lanes past d read at d - 1 and discard it
        own[q] = __ldg(self_vals + exp_at + static_cast<size_t>(j0 + t) * d +
                       min(ci * chunk + cl + 32 * q, d - 1));
      }
      auto column = [&](auto bucket) {
        constexpr int N = decltype(bucket)::value;
        // exactly N rows: cnt == N for the trimmed mean, cnt + 1 == N for
        // the median, whose own value then takes the last row
        constexpr bool exact = decltype(bucket)::lo == N;
        float v[COLS][N];
        float kept[N];  // decide: the unsorted column (one a lane), up to kDecideRegs rows
#pragma unroll
        for (int i = 0; i < N; ++i) {
          if (kMedian && exact && i == N - 1) {
#pragma unroll
            for (int q = 0; q < COLS; ++q) v[q][i] = sanitize(own[q]);
            continue;
          }
          const int r = list[i];
          const float2 sz = kCodes ? pairs[t * NMAX + i] : float2{};
#pragma unroll
          for (int q = 0; q < COLS; ++q) {
            const float x = load_value(src, r, d, min(ci * chunk + cl + 32 * q, d - 1), sz);
            if (exact) {
              v[q][i] = x;
            } else {
              v[q][i] = i < cnt ? x
                                : (kMedian && i == cnt ? sanitize(own[q]) : CUDART_INF_F);
            }
            if constexpr (kDecide && N <= kDecideRegs) kept[i] = x;
          }
        }
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          if (kMedian && exact) {
            median_select<N>(v[q]);
          } else {
            batcher_sort<N>(v[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int c = ci * chunk + cl + 32 * q;
          if (c < d) {
            float res;
            if (kMedian) {
              res = median_sorted<N>(v[q], exact ? N : cnt + 1);
            } else if (exact) {
              res = trimmed_mean_exact<N>(v[q], be, own[q]);
            } else {
              res = trimmed_mean_sorted<N>(v[q], cnt, be, own[q]);
            }
            out[exp_at + static_cast<size_t>(j0 + t) * d + c] = res;
          }
        }
        if constexpr (kDecide) {
          const int c = ci * chunk + cl;
          const float2 window = kMedian ? median_window<N>(v[0], exact ? N : cnt + 1)
                                        : trim_window<N>(v[0], exact ? N : cnt, be);
          LaneCounts<NMAX> lanes;
          decide_column<N>(lanes, kept, cnt, window, c < d && c % dec.stride == 0, lane,
                           [&](int i) {
                             return load_value(src, list[i], d, min(c, d - 1), float2{});
                           });
          lanes.flush(s_trim + t * NMAX, lane);
        }
      };
      const int rows_to_sort = kMedian ? cnt + 1 : cnt;
      if constexpr (NMAX <= kExactRows) {
        for_rows<NMAX>(rows_to_sort, column);
      } else {
        for_bucket<NMAX>(rows_to_sort, column);
      }
    }
  }
  if constexpr (kDecide) {
    __syncthreads();
    for (int x = s; x < nt * NMAX; x += kTileThreads) {
      const int t = x / NMAX;
      if (x - t * NMAX < s_cnt[t] && s_trim[x] != 0) {
        atomicAdd(dec.counts + (static_cast<size_t>(e) * m + j0 + t) * dec.width + s_lslot[x],
                  s_trim[x]);
      }
    }
  }
}

// A launch's operands besides the row source.
struct TileArgs {
  const int32_t* idx;
  const uint8_t* valid;
  const float* self_vals;
  float* out;
  int m, k, d, b, tile, chunk, segments;
  Experiments ex;
  Decide dec;
};

template <int NMAX, bool kMedian, int COLS, class Rows, bool kDecide = false>
cudaError_t run_tile(const Rows& rows, const TileArgs& a, cudaStream_t s) {
  if (a.tile * NMAX > kMaxListed) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((a.m + a.tile - 1) / a.tile) * a.segments, a.ex.count);
  gather_tile_kernel<NMAX, kMedian, COLS, Rows, kDecide><<<grid, kTileThreads, 0, s>>>(
      rows, a.idx, a.valid, a.self_vals, a.out, a.m, a.k, a.d, a.b, a.tile, a.chunk, a.segments,
      a.ex, a.dec);
  return cudaGetLastError();
}

template <int NMAX, bool kMedian, class Rows>
cudaError_t run_tile_cols(int cols, const Rows& rows, const TileArgs& a, cudaStream_t s) {
  if (a.dec.counts != nullptr) {
    // the decide form: float rows or views, one column a lane
    if constexpr (!Rows::kStaged) {
      if (cols == 1) return run_tile<NMAX, kMedian, 1, Rows, true>(rows, a, s);
    }
    return cudaErrorInvalidValue;
  }
  if (cols == 1) return run_tile<NMAX, kMedian, 1>(rows, a, s);
  // two columns a lane: the float median of at most 32 rows only
  // (kernels/gather_screen.py); two arrays of 64 would spill
  if constexpr (kMedian && !Rows::kStaged && NMAX <= 32) {
    if (cols == 2) return run_tile<NMAX, kMedian, 2>(rows, a, s);
  }
  return cudaErrorInvalidValue;
}

inline bool plan_fits(int m, int k, int d, int tile, int chunk, int segments, int cols) {
  return m >= 1 && d >= 1 && k >= 0 && k <= kRegisterSlots && tile >= 1 &&
         tile <= kMaxTileNodes && tile * k <= kMaxTileSlots && chunk >= 32 && chunk % 32 == 0 &&
         kScaleBlock % chunk == 0 && segments >= 1 && (cols == 1 || cols == 2) &&
         chunk >= 32 * cols &&
         static_cast<long long>((m + tile - 1) / tile) * segments <= 0x7fffffffLL;
}

// Launch the tile kernel under a plan, ex.count experiments along
// gridDim.y; rows to sort K (K + 1 for the median) pick the compiled
// bucket.  cudaErrorInvalidValue for a shape or plan it does not take.
// A non-null dec.counts launches the decide form (float rows or views, one
// column a lane: cols 1), recording into dec (width K, stride >= 1).
template <bool kMedian, class Rows>
cudaError_t launch_tile(const Rows& rows, const int32_t* idx, const uint8_t* valid,
                        const float* self_vals, float* out, int m, int k, int d, int b, int tile,
                        int chunk, int segments, int cols, cudaStream_t s,
                        const Experiments& ex = Experiments{}, const Decide& dec = Decide{}) {
  if (!plan_fits(m, k, d, tile, chunk, segments, cols) || b < 0 || ex.count < 1 ||
      ex.count > kMaxExperiments ||
      (dec.counts != nullptr && (dec.width != k || dec.stride < 1)))
    return cudaErrorInvalidValue;
  const TileArgs a{idx, valid, self_vals, out, m, k, d, b, tile, chunk, segments, ex, dec};
  const int most = k + (kMedian ? 1 : 0);
  if (most <= 16) return run_tile_cols<16, kMedian>(cols, rows, a, s);
  if (most <= 24) return run_tile_cols<24, kMedian>(cols, rows, a, s);
  if (most <= 32) return run_tile_cols<32, kMedian>(cols, rows, a, s);
  if (most <= 48) return run_tile_cols<48, kMedian>(cols, rows, a, s);
  return run_tile_cols<64, kMedian>(cols, rows, a, s);
}

inline bool scales_fit(int d, int nblk) {
  return nblk == (d + kScaleBlock - 1) / kScaleBlock;
}

}  // namespace screen
