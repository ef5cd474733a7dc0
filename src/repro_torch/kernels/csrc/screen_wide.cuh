// The wide screening path: the trimmed mean and the median over more rows
// than the register networks hold (kMaxNetworkRows = 128 for the dense
// screens, 63 table slots for the gather screens), up to kWideMaxRows.
// screen.cu, dequant_screen.cu and gather_screen.cu instantiate it over
// their row sources (screen_sort.cuh) and row lists (below), so every
// screen of rows 1-3 and 6-8 of the kernel table takes any row count the
// reference takes, up to this path's limit.
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
// summation bound.
//
// Design.  One block of 256 threads per (node, tile of `coords`
// coordinates), node-fastest over a 1-D grid, so the blocks in flight share
// the rows of one coordinate tile in L2.  The block compacts its node's row
// list into shared memory (a ballot per warp over the list's candidates,
// 256 at a time, in list order), stages what the row source needs of them
// (a codeword's scale pairs, one per listed row), then copies the column of
// each of its coordinates into shared memory (a row's coordinates are
// adjacent across the threads, so the loads coalesce), pads it with +inf to
// the next power of two P of the block's own row count and sorts every
// column with a bitonic network that all threads share (P/2 compare-
// exchanges a column a step, log2(P) (log2(P) + 1) / 2 steps, a barrier
// each).  One warp then reduces the columns, a thread a column.  Columns
// are stored with a pitch of P + 1 floats, so neither the staging stores
// nor the reduction's reads conflict on a bank.
//
// Shared memory: coords (P + 1) floats of columns, plus the list (4 bytes
// a row) and the codeword source's pairs (8 bytes a row).  `coords` is 32
// up to 1024 padded rows and 16 up to 2048, 131 KB of columns at most, so
// at least 1024 rows fit in the 227 KB a block may use.
//
// What bounds it on an H100.  The sort: a bitonic network does about
// P/4 log2(P)^2 compare-exchanges a column, a barrier a step; and the
// reduction's left-to-right sum, one dependent add a kept rank, which only
// one warp of the block runs.  Device memory sees each input once per
// coordinate tile of each node (L2 holds the rows the nodes share).

#pragma once

#include <stdint.h>

#include "screen_sort.cuh"

namespace screen {

constexpr int kWideThreads = 256;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideMaxRows = 2048;  // rows (padded to a power of two) a block sorts
constexpr int kStageBatch = 8;      // column entries a thread loads before it stores them

__host__ __device__ __forceinline__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Coordinates a block covers at `padded` rows; a divisor of kScaleBlock, so
// a tile lies in one codec scale block.
__host__ __device__ __forceinline__ int wide_coords(int padded) { return padded <= 1024 ? 32 : 16; }
static_assert(kScaleBlock % 32 == 0, "a wide tile must lie in one scale block");

// Compacts the candidates i < n for which take(i) holds into s_list (in
// ascending i, the value row(i) each) and returns their count to every
// thread; every thread of the block must call it.
template <class Take, class Row>
__device__ __forceinline__ int compact_list(int n, Take take, Row row, int* s_list, int* s_warp) {
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
    if (on) s_list[total + before + __popc(votes & ((1u << lane) - 1u))] = row(i);
    total += sum;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return total;
}

// Row lists: which rows node j screens.  Dense: the senders of adj[j, :],
// ascending.  Slots: the valid slots of row j of the [M, K] table, in slot
// order (padded slots are left out: they would sort last as +inf).
struct DenseList {
  const uint8_t* adj;
  int m;
  __device__ __forceinline__ int build(int j, int* s_list, int* s_warp) const {
    const uint8_t* row = adj + static_cast<size_t>(j) * m;
    return compact_list(
        m, [&](int i) { return row[i] != 0; }, [](int i) { return i; }, s_list, s_warp);
  }
};

struct SlotList {
  const int32_t* idx;
  const uint8_t* valid;
  int m, k;
  __device__ __forceinline__ int build(int j, int* s_list, int* s_warp) const {
    const size_t at = static_cast<size_t>(j) * k;
    return compact_list(
        k, [&](int i) { return valid[at + i] != 0; },
        [&](int i) { return min(max(idx[at + i], 0), m - 1); }, s_list, s_warp);
  }
};

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Dynamic shared memory of a wide block whose list holds up to `cap` rows
// and whose columns pad to `padded` rows.
__host__ __device__ __forceinline__ size_t wide_smem_bytes(int cap, int padded, bool pairs) {
  return align16(sizeof(int) * (static_cast<size_t>(cap) + kWideWarps)) +
         (pairs ? align16(sizeof(float2) * static_cast<size_t>(cap)) : 0) +
         sizeof(float) * static_cast<size_t>(wide_coords(padded)) * (padded + 1);
}

template <bool kMedian, class Rows, class List>
__global__ void __launch_bounds__(kWideThreads)
wide_screen_kernel(Rows rows, List list, const float* __restrict__ self_vals,
                   float* __restrict__ out, int nodes, int d, int cap, int coords, int b,
                   bool recip) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_list = reinterpret_cast<int*>(smem);
  int* s_warp = s_list + cap;
  unsigned char* next = smem + align16(sizeof(int) * (static_cast<size_t>(cap) + kWideWarps));
  float2* s_pair = reinterpret_cast<float2*>(next);
  if (Rows::kStaged) next += align16(sizeof(float2) * static_cast<size_t>(cap));
  float* s_col = reinterpret_cast<float*>(next);

  const int j = blockIdx.x % nodes;
  const int c0 = (blockIdx.x / nodes) * coords;
  const int count = list.build(j, s_list, s_warp);
  rows.stage(s_list, count, s_pair, c0 / kScaleBlock);
  const int n = kMedian ? count + 1 : count;
  const int padded = next_pow2(n);
  const int pitch = padded + 1;
  const int live = min(coords, d - c0);
  const size_t at0 = static_cast<size_t>(j) * d + c0;
  // every extent below is a power of two: shifts and masks, no division
  const int log_coords = __ffs(coords) - 1, log_padded = __ffs(padded) - 1;

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
          v[u] = rows.load(s_pair, s_list[i], i, d, c0 + c);
        } else if (kMedian && i == count) {
          v[u] = sanitize(self_vals[at0 + c]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = base + u * kWideThreads;
      if (e < entries) s_col[(e & (coords - 1)) * pitch + (e >> log_coords)] = v[u];
    }
  }
  __syncthreads();

  // bitonic sort of every column, ascending (the last merge runs up
  // everywhere); (lo, lo + stride) with lo's `stride` bit clear
  const int log_half = log_padded - 1;
  for (int size = 2; size <= padded; size <<= 1) {
    for (int log_stride = __ffs(size) - 2; log_stride >= 0; --log_stride) {
      const int stride = 1 << log_stride;
#pragma unroll 4
      for (int e = threadIdx.x; e < coords << log_half; e += kWideThreads) {
        const int c = e >> log_half, q = e & ((1 << log_half) - 1);
        const int lo = ((q >> log_stride) << (log_stride + 1)) | (q & (stride - 1));
        float* col = s_col + c * pitch;
        const float a = col[lo], z = col[lo + stride];
        const float mn = fminf(a, z), mx = fmaxf(a, z);
        const bool up = (lo & size) == 0;
        col[lo] = up ? mn : mx;
        col[lo + stride] = up ? mx : mn;
      }
      __syncthreads();
    }
  }

  for (int c = threadIdx.x; c < live; c += kWideThreads) {
    const float* col = s_col + c * pitch;
    if (kMedian) {
      out[at0 + c] = __fmul_rn(0.5f, __fadd_rn(col[(n - 1) / 2], col[n / 2]));
    } else {
      const int b_eff = trim_width(count, b);
      float total = 0.0f;
      for (int i = b_eff; i < count - b_eff; ++i) total = __fadd_rn(total, col[i]);
      out[at0 + c] = trimmed_mean_finish(total, self_vals[at0 + c], count, b_eff, recip);
    }
  }
}

// Launch over `nodes` nodes whose lists hold at most `cap` rows (the rows to
// sort: cap, plus one for the median); cudaErrorInvalidValue above
// kWideMaxRows.
template <bool kMedian, class Rows, class List>
cudaError_t launch_wide(const Rows& rows, const List& list, const float* self_vals, float* out,
                        int nodes, int d, int cap, int b, bool recip, cudaStream_t s) {
  const int most = cap + (kMedian ? 1 : 0);
  if (nodes < 1 || d < 1 || cap < 0 || most > kWideMaxRows) return cudaErrorInvalidValue;
  const int padded = next_pow2(most);
  const int coords = wide_coords(padded);
  const long long tiles = (d + coords - 1) / coords;
  if (tiles * nodes > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t bytes = wide_smem_bytes(cap, padded, Rows::kStaged);
  auto kernel = wide_screen_kernel<kMedian, Rows, List>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(tiles * nodes), kWideThreads, bytes, s>>>(
      rows, list, self_vals, out, nodes, d, cap, coords, b, recip);
  return cudaGetLastError();
}

}  // namespace screen
