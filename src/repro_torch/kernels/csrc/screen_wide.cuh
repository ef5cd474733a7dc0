// The wide screening path: the trimmed mean and the median over more rows
// than the register networks hold (kMaxNetworkRows = 128 for the dense
// screens, 63 table slots for the gather screens), up to kWideMaxRows.
// screen.cu, dequant_screen.cu, gather_screen.cu and views_screen.cu
// instantiate it over their row sources (screen_sort.cuh) and row lists
// (below), so every
// screen of rows 1-3 and 6-8 of the kernel table takes any row count the
// reference takes, up to this path's limit.  It replaces, at those sizes,
// the TPU kernels src/repro/kernels/trimmed_mean.py::trimmed_mean_pallas,
// median.py::median_pallas, gather_screen.py::gather_screen_pallas and
// gather_dequant_screen_pallas, and dequant_screen.py::
// dequant_trimmed_mean_pallas and dequant_median_pallas.  Its decide form
// (kDecide, the trust layer's and the forensic trace's decisions;
// screen_decide.cu, gather_screen_decide.cu and views_screen_decide.cu
// have the `*_wide_*_decide` entries) replaces no TPU kernel: the
// reference decides in jnp (src/repro/core/screening.py:489, :525).
//
// What it computes is the register screens' arithmetic exactly: NaN -> +inf,
// the listed rows in list order padded with +inf, each column sorted
// ascending, then
//   * trimmed mean: ranks [b_eff, count - b_eff) summed left to right with
//     IEEE adds, the node's own value (unsanitized) added, divided (IEEE) by
//     count - 2 b_eff + 1, or multiplied by its correctly rounded reciprocal;
//   * median: the node's own value, sanitized, as one more row; the mean of
//     the two middle order statistics of the count + 1 rows.
// The sort's result does not depend on the network (it is the column's
// values in order), so up to the sign of a zero this equals the register
// kernels at any count they also take, and the plain versions wherever
// those sum left to right (at most ref.MAX_EXACT_ROWS = 64 rows); above, the
// plain versions sum with torch.sum, and the two agree within the float32
// summation bound.  NaN becomes +inf as a value is staged, before any
// fminf/fmaxf (which would drop a NaN).
//
// Design.  One block of 256 threads per (node, tile of `coords`
// coordinates), node-fastest over a 1-D grid, so the blocks in flight share
// the rows of one coordinate tile in L2.  The block compacts its node's row
// list into shared memory (a ballot per warp over the list's candidates,
// 256 at a time, in list order), stages what the row source needs of them
// (a codeword's scale pairs, one per listed row), then copies the column of
// each of its coordinates into shared memory (a row's coordinates are
// adjacent across the threads, so the loads coalesce; kStageBatch loads in
// flight a thread), padded with +inf to P rows: the next power of two of
// the block's own row count, at least 32.  After one barrier each warp
// sorts whole columns, one at a time, in registers: P = 32 R rows, R values
// a lane (R = 1, 2, ..., 64), sorted by the bitonic network
// warp_sort<R> that kernels/networks.py generates as straight-line code
// (screen_networks.cuh).  Its compare-exchanges all ascend (each merge
// first compares the two halves of a block mirrored), so no lane selects
// on a direction bit: an in-register compare-exchange is two FMNMX, where a
// lane-dependent direction adds two FSEL.  The layout is blocked (row
// i = lane R + r in register r): the network's frequent small strides, all
// but the 15 steps whose stride is R or more, pair registers of one lane,
// and only those 15 shuffle (__shfl_xor_sync, then the lower lane keeps
// the min); an interleaved layout (i = r 32 + lane) would shuffle on every
// stride below 32.  Only the warp takes part in a sort: no block barrier
// after the staging one.  A column stores row i at i + i / R (R > 1), so
// the 32 lanes' reads and writes of their R rows hit 32 banks (lane stride
// R + 1, odd), and with a column pitch of P + 33 floats (odd) the staging
// stores, one row across the coordinates, do too.  Each warp then reduces
// its own columns, lane l the l-th, after a __syncwarp: the sums run on all
// eight warps, each as soon as its own sorts are done.
//
// A kernel is compiled for the widest column its launch can reach (kRmax =
// 8, 16, 32 or 64 registers a lane, from the list's cap), with every sort
// up to that width inlined and a register budget to match (64 a thread up
// to 8 registers a lane: four blocks an SM; one block at 64).  A block
// covers as many coordinates as shared memory holds at that occupancy
// (wide_coords: 128 up to 64 rows, then 64, 32, 32, 16, 16).
//
// Shared memory: coords (P + 33) floats of columns (37-133 KB at the
// launch's largest P), plus the list (4 bytes a row) and the codeword
// source's pairs (8 bytes a row); the decide form (below) adds the list's
// slots (4 bytes a row) and the columns' kept windows (8 bytes a
// coordinate).
//
// What bounds it on an H100.  Instructions: a bitonic sort of P rows is
// log2(P) (log2(P) + 1) / 2 steps over all P values, each in-register step
// one FMNMX a value, each of the 15 shuffle steps a SHFL and two predicated
// FMNMX a value (both issue; cuobjdump shows no fused form).  The bound
// counted in the kernel table is the fp32 operations of Batcher's network
// over each node's true row count, which the bitonic sorter over the padded
// P exceeds.  Device memory sees each input once per coordinate tile of
// each node (L2 holds the rows the nodes share).

#pragma once

#include <stdint.h>

#include "screen_sort.cuh"

namespace screen {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxRows = 2048;  // rows (padded to a power of two) a block sorts
constexpr int kStageBatch = 8;      // column entries a thread loads before it stores them
static_assert(kWideMaxRows == 32 * kWarpRegsMax, "a warp sorts the widest column");

// Rows a column of n rows pads to: the next power of two, at least a warp.
__host__ __device__ __forceinline__ int wide_padded(int n) {
  int p = 32;
  while (p < n) p <<= 1;
  return p;
}

// Coordinates a block covers when its launch pads to at most `padded`
// rows: as many as the blocks an SM holds at that width leave shared
// memory for (wide_min_blocks: 37-50 KB of columns up to 256 rows, 64-70
// KB up to 1024, 133 KB at 2048), at most 128; a power of two that divides
// kScaleBlock, so a tile lies in one scale block.
__host__ __device__ __forceinline__ int wide_coords(int padded) {
  return padded <= 64 ? 128 : padded <= 256 ? 8192 / padded : padded <= 1024 ? 16384 / padded : 16;
}
static_assert(kScaleBlock % 128 == 0, "a wide tile must lie in one scale block");

// Floats a column of `padded` rows takes: one pad float every R rows
// (R > 1), and one more so that the pitch is odd.
__host__ __device__ __forceinline__ int wide_pitch(int padded) {
  return padded + (padded > 32 ? 32 : 0) + 1;
}

// Compacts the candidates i < n for which take(i) holds into s_list (in
// ascending i, the value row(i) each; with s_slot, i itself beside it:
// the slot the decide form records under) and returns their count to every
// thread; every thread of the block must call it.
template <class Take, class Row>
__device__ __forceinline__ int compact_list(int n, Take take, Row row, int* s_list, int* s_warp,
                                            int* s_slot) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int total = 0;
  for (int base = 0; base < n; base += kWideThreads) {
    const int i = base + t;
    const bool on = i < n && take(i);
    const unsigned votes = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_warp[warp] = __popc(votes);
    __syncthreads();
    int before = 0, sum = 0;
#pragma unroll
    for (int w = 0; w < kWideWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      sum += c;
    }
    if (on) {
      const int at = total + before + __popc(votes & ((1u << lane) - 1u));
      s_list[at] = row(i);
      if (s_slot != nullptr) s_slot[at] = i;
    }
    total += sum;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return total;
}

// Row lists: which rows node j screens (experiment(e, s_mask): experiment
// e's, its mask s_mask bytes after the previous experiment's).  Dense: the senders of adj[j, :],
// ascending (over mailbox views [M, W, d], the usable slots of mask[j, :]:
// DenseList{mask, W}).  Slots: the valid slots of row j of the [M, K] table, in slot
// order (padded slots are left out: they would sort last as +inf).
struct DenseList {
  const uint8_t* adj;
  int m;
  __device__ __forceinline__ DenseList experiment(int e, long long s_mask) const {
    return DenseList{adj + e * s_mask, m};
  }
  __device__ __forceinline__ int build(int j, int* s_list, int* s_warp, int* s_slot) const {
    const uint8_t* row = adj + static_cast<size_t>(j) * m;
    return compact_list(
        m, [&](int i) { return row[i] != 0; }, [](int i) { return i; }, s_list, s_warp, s_slot);
  }
};

struct SlotList {
  const int32_t* idx;
  const uint8_t* valid;
  int m, k;
  __device__ __forceinline__ SlotList experiment(int e, long long s_mask) const {
    return SlotList{idx, valid + e * s_mask, m, k};
  }
  __device__ __forceinline__ int build(int j, int* s_list, int* s_warp, int* s_slot) const {
    const size_t at = static_cast<size_t>(j) * k;
    return compact_list(
        k, [&](int i) { return valid[at + i] != 0; },
        [&](int i) { return min(max(idx[at + i], 0), m - 1); }, s_list, s_warp, s_slot);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory of a wide block whose list holds up to `cap` rows
// and whose columns pad to at most `padded` rows; the decide form adds the
// list's slots (4 bytes a row) and each column's kept window (8 bytes a
// coordinate).
__host__ __device__ __forceinline__ size_t wide_smem_bytes(int cap, int padded, bool pairs,
                                                          bool decide) {
  return align16(sizeof(int) * (static_cast<size_t>(cap) + kWideWarps)) +
         (decide ? align16(sizeof(int) * static_cast<size_t>(cap)) : 0) +
         (pairs ? align16(sizeof(float2) * static_cast<size_t>(cap)) : 0) +
         (decide ? align16(sizeof(float2) * static_cast<size_t>(wide_coords(padded))) : 0) +
         sizeof(float) * static_cast<size_t>(wide_coords(padded)) * wide_pitch(padded);
}

// Sorts the column at `col` (32 R rows, row i at i + i / R for R > 1) with
// the calling warp: lane `lane` loads rows lane R .. lane R + R - 1 into
// registers, the warp runs warp_sort<R>, and the lane stores them back.
template <int R>
__device__ __forceinline__ void sort_column(float* col, int lane) {
  float v[R];
  float* mine = col + lane * (R > 1 ? R + 1 : 1);
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = mine[r];
  warp_sort<R>(v, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) mine[r] = v[r];
}

// sort_column<regs> for the block-uniform `regs` (a power of two, R <= regs
// <= kRmax): a kernel compiles the sorts its launch can reach, no more.
template <int R, int kRmax>
__device__ __forceinline__ void sort_wide_column(float* col, int regs, int lane) {
  if constexpr (R < kRmax) {
    if (regs > R) {
      sort_wide_column<2 * R, kRmax>(col, regs, lane);
      return;
    }
  }
  sort_column<R>(col, lane);
}

// Registers a lane the widest column of a launch takes, at least 8 (one
// kernel for every launch up to 256 rows to sort); and the blocks an SM
// should hold at that width, which sets the register budget (64 a thread
// up to 8 registers a lane, 85 at 16, 128 at 32, 255 at 64).
__host__ __device__ constexpr int wide_regs(int padded) {
  return padded / 32 > 8 ? padded / 32 : 8;
}
__host__ __device__ constexpr int wide_min_blocks(int regs) {
  return regs <= 8 ? 4 : regs <= 16 ? 3 : regs <= 32 ? 2 : 1;
}

// kDecide: the decide form (the trust layer's and the trace's forensics),
// a second instantiation of the same code, so the plain form carries none
// of it (a runtime switch in one kernel measured 6-14% slower plain wide
// screens, PERF.md) and the output is the plain kernel's bit for bit
// (the same sort and sum).  Each column's kept window goes to shared
// memory as its lane reduces it (screen_sort.cuh trim_window /
// median_window: the same ranks), and after one barrier each warp decides
// whole listed rows, one at a time: its lanes re-read the row's values at
// the tile's columns (32 adjacent coordinates a load, from L2: the block
// staged them), a ballot and a popc count the counted columns outside
// their windows, and lane 0 adds the row's count into dec.counts under its
// slot with one integer atomic (so the counts do not depend on block
// order).  A column above kDecideRegs rows cannot keep an unsorted copy in
// registers, so every row is re-read.
template <bool kMedian, bool kDecide, int kRmax, class Rows, class List>
__global__ void __launch_bounds__(kWideThreads, wide_min_blocks(kRmax))
wide_screen_kernel(Rows rows, List list, const float* __restrict__ self_vals,
                   float* __restrict__ out, int nodes, int d, int cap, int coords, int b,
                   bool recip, Experiments ex, Decide dec) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_list = reinterpret_cast<int*>(smem);
  int* s_warp = s_list + cap;
  unsigned char* next = smem + align16(sizeof(int) * (static_cast<size_t>(cap) + kWideWarps));
  int* s_slot = nullptr;
  if constexpr (kDecide) {
    s_slot = reinterpret_cast<int*>(next);
    next += align16(sizeof(int) * static_cast<size_t>(cap));
  }
  float2* s_pair = reinterpret_cast<float2*>(next);
  if (Rows::kStaged) next += align16(sizeof(float2) * static_cast<size_t>(cap));
  float2* s_win = reinterpret_cast<float2*>(next);
  if constexpr (kDecide) next += align16(sizeof(float2) * static_cast<size_t>(coords));
  float* s_col = reinterpret_cast<float*>(next);

  const int j = blockIdx.x % nodes;
  const int c0 = (blockIdx.x / nodes) * coords;
  // experiment blockIdx.y (screen_sort.cuh, Experiments): its rows, self
  // values, outputs, b and row list
  const int e = blockIdx.y;
  const int count = list.experiment(e, ex.s_mask).build(j, s_list, s_warp, s_slot);
  const auto src = rows.experiment(e).at(j);
  src.stage(s_list, count, s_pair, c0 / kScaleBlock);
  const int n = kMedian ? count + 1 : count;
  const int padded = wide_padded(n);
  const int pitch = wide_pitch(padded);
  const int live = min(coords, d - c0);
  const size_t at0 = (static_cast<size_t>(e) * nodes + j) * d + c0;
  // every extent below is a power of two: shifts and masks, no division
  const int log_coords = __ffs(coords) - 1, log_padded = __ffs(padded) - 1;
  const int shift = log_padded > 5 ? log_padded - 5 : 31;  // row i sits at i + (i >> shift)

  // the columns, row-major across the threads (a row's coordinates
  // adjacent); kStageBatch loads in flight a thread before their stores
  const int entries = coords << log_padded;
  for (int base = threadIdx.x; base < entries; base += kStageBatch * kWideThreads) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + u * kWideThreads;
      const int i = e >> log_coords, c = e & (coords - 1);
      v[u] = CUDART_INF_F;
      if (e < entries && c < live) {
        if (i < count) {
          v[u] = src.load(s_pair, s_list[i], i, d, c0 + c);
        } else if (kMedian && i == count) {
          v[u] = sanitize(self_vals[at0 + c]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + u * kWideThreads;
      const int i = e >> log_coords;
      if (e < entries) s_col[(e & (coords - 1)) * pitch + i + (i >> shift)] = v[u];
    }
  }
  __syncthreads();

  // a warp a column, padded / 32 values a lane (uniform over the block);
  // then lane l of the warp reduces the warp's l-th column (coords <= 128:
  // at most 16 a warp), after only the warp's own barrier
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < live; c += kWideWarps) {
    sort_wide_column<1, kRmax>(s_col + c * pitch, padded >> 5, lane);
  }
  __syncwarp();
  const int c = warp + lane * kWideWarps;
  if (c < live) {
    const float* col = s_col + c * pitch;
    if (kMedian) {
      const int lo = (n - 1) / 2, hi = n / 2;
      const float2 window = make_float2(col[lo + (lo >> shift)], col[hi + (hi >> shift)]);
      out[at0 + c] = __fmul_rn(0.5f, __fadd_rn(window.x, window.y));
      if constexpr (kDecide) s_win[c] = window;
    } else {
      const int b_eff = trim_width(count, ex.b_of(e, b));
      float total = 0.0f;
      for (int i = b_eff; i < count - b_eff; ++i) total = __fadd_rn(total, col[i + (i >> shift)]);
      out[at0 + c] = trimmed_mean_finish(total, self_vals[at0 + c], count, b_eff, recip);
      if constexpr (kDecide) {
        const int hi = max(count - b_eff - 1, b_eff);
        s_win[c] = make_float2(col[b_eff + (b_eff >> shift)], col[hi + (hi >> shift)]);
      }
    }
  }
  if constexpr (kDecide) {
    __syncthreads();  // every column's window
    const size_t row0 = (static_cast<size_t>(e) * nodes + j) * dec.width;
    for (int i = warp; i < count; i += kWideWarps) {
      int trimmed = 0;
      for (int cb = 0; cb < live; cb += 32) {
        const int cc = cb + lane;
        const bool counted = cc < live && (c0 + cc) % dec.stride == 0;
        const bool cut =
            counted && outside(src.load(s_pair, s_list[i], i, d, c0 + cc), s_win[cc]);
        trimmed += __popc(__ballot_sync(0xffffffffu, cut));
      }
      if (lane == 0 && trimmed != 0) atomicAdd(dec.counts + row0 + s_slot[i], trimmed);
    }
  }
}

template <bool kMedian, bool kDecide, int kRmax, class Rows, class List>
cudaError_t launch_wide_kernel(const Rows& rows, const List& list, const float* self_vals,
                               float* out, int nodes, int d, int cap, int coords, int b,
                               bool recip, size_t bytes, unsigned blocks, cudaStream_t s,
                               const Experiments& ex, const Decide& dec) {
  auto kernel = wide_screen_kernel<kMedian, kDecide, kRmax, Rows, List>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, ex.count), kWideThreads, bytes, s>>>(rows, list, self_vals, out, nodes, d,
                                                             cap, coords, b, recip, ex, dec);
  return cudaGetLastError();
}

// Launch over `nodes` nodes whose lists hold at most `cap` rows (the rows to
// sort: cap, plus one for the median), ex.count experiments along
// gridDim.y; cudaErrorInvalidValue above kWideMaxRows or kMaxExperiments.
// kDecide: the decide form, recording into dec (counts [E, nodes,
// dec.width], zeroed by the caller).
template <bool kMedian, bool kDecide = false, class Rows, class List>
cudaError_t launch_wide(const Rows& rows, const List& list, const float* self_vals, float* out,
                        int nodes, int d, int cap, int b, bool recip, cudaStream_t s,
                        const Experiments& ex = Experiments{}, const Decide& dec = Decide{}) {
  const int most = cap + (kMedian ? 1 : 0);
  if (nodes < 1 || d < 1 || cap < 0 || most > kWideMaxRows || ex.count < 1 ||
      ex.count > kMaxExperiments)
    return cudaErrorInvalidValue;
  const int padded = wide_padded(most);
  const int coords = wide_coords(padded);
  const long long tiles = (d + coords - 1) / coords;
  if (tiles * nodes > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (kDecide && (dec.counts == nullptr || dec.stride < 1)) return cudaErrorInvalidValue;
  const size_t bytes = wide_smem_bytes(cap, padded, Rows::kStaged, kDecide);
  const unsigned blocks = static_cast<unsigned>(tiles * nodes);
  switch (wide_regs(padded)) {
    case 8:
      return launch_wide_kernel<kMedian, kDecide, 8>(rows, list, self_vals, out, nodes, d, cap,
                                                     coords, b, recip, bytes, blocks, s, ex, dec);
    case 16:
      return launch_wide_kernel<kMedian, kDecide, 16>(rows, list, self_vals, out, nodes, d, cap,
                                                      coords, b, recip, bytes, blocks, s, ex, dec);
    case 32:
      return launch_wide_kernel<kMedian, kDecide, 32>(rows, list, self_vals, out, nodes, d, cap,
                                                      coords, b, recip, bytes, blocks, s, ex, dec);
    default:
      return launch_wide_kernel<kMedian, kDecide, 64>(rows, list, self_vals, out, nodes, d, cap,
                                                      coords, b, recip, bytes, blocks, s, ex, dec);
  }
}

}  // namespace screen
