// The backward of the views screens, for Hopper (sm_90a).
//
// views_screen_grad_trimmed_mean and views_screen_grad_median are the
// gradients of views_screen_trimmed_mean / views_screen_median
// (views_screen.cu, which replace src/repro/kernels/trimmed_mean.py::
// trimmed_mean_pallas and median.py::median_pallas in the views form) with
// respect to the views and the node's own value, given the output's
// cotangent gy [E, M, d].  They are what kernels/autograd.py runs when the
// adaptive adversary inner_max ascends through the sparse runtime's
// screening oracle; the reference takes this gradient with jax.grad of
// src/repro/core/screening.py.
//
// What they compute: autograd.py's plain backward, exactly.  Per node j of
// cell e and coordinate c, each slot's key is its value with NaN read as
// +inf, or +inf for a slot the mask drops; its rank is the number of slots
// whose key is smaller, or equal at a lower slot (a stable sort's
// position).  With count usable slots:
//   * trimmed mean: b_eff = min(max(b, 0), max((count - 1) / 2, 0)), and
//     g = gy / (count - 2 b_eff + 1) (IEEE division) goes to each usable,
//     non-NaN slot ranked in [b_eff, count - b_eff) and to the node's own
//     value; 0 to the others;
//   * median: over the n = count + 1 members, the usable slots and the
//     node's own (sanitized) value last, 1/2 gy to each of the ranks
//     (n - 1) / 2 and n / 2 (gy to one member when they coincide); a NaN
//     member gets 0.
// Each output is one product or quotient, so the kernel equals the plain
// backward bit for bit.
//
// Design.  A thread a (node, coordinate) column: up to 64 slots it loads
// the column's W values into registers (W <= kMaxW, a template bound of 16,
// 32 or 64), ranks each by comparing it with all W (W^2 compares), and
// writes W gradients.  Above 64 slots (the dense runtime's views at M > 64)
// the wide kernel ranks the members kChunk at a time: their keys in
// registers, every member's key streamed past them from the column (through
// the cache), so a column is read W / kChunk + 1 times for the same W^2
// compares and the same ranks.  Consecutive threads take consecutive
// coordinates, so every load and store of a warp covers 128 contiguous
// bytes; a block's threads share one node, whose mask row they read through
// the cache.  Rows (cells x nodes) run on gridDim.y, looped past its limit.
//
// What bounds it on an H100: at sparse M = 512, K = 16, d = 7850 it reads
// the views (257 MB) and writes their gradient (257 MB), 0.154 ms at
// 3.35 TB/s; its 16^2 compares a column are 1.0 G operations, 0.015 ms at
// the float32 rate, so bytes bound it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float key_of(float v, bool usable) {
  return usable ? (isnan(v) ? __int_as_float(0x7f800000) : v) : __int_as_float(0x7f800000);
}

template <int kMaxW, bool kMedian>
__global__ void __launch_bounds__(kThreads)
views_grad_kernel(const float* __restrict__ views, long long s_exp, long long s_recv,
                  long long s_slot, const uint8_t* __restrict__ mask, long long s_mask,
                  const float* __restrict__ self_vals, const float* __restrict__ gy,
                  float* __restrict__ g_views, float* __restrict__ g_self, int e_count, int m,
                  int w, int d, int b, const int32_t* __restrict__ b_e) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const long long rows = static_cast<long long>(e_count) * m;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    if (c >= d) continue;
    const int e = static_cast<int>(row / m);
    const int j = static_cast<int>(row % m);
    const float* col = views + e * s_exp + j * s_recv + c;
    const uint8_t* mrow = mask + e * s_mask + static_cast<long long>(j) * w;
    float key[kMaxW + 1];
    bool live[kMaxW + 1];
    int count = 0;
#pragma unroll
    for (int i = 0; i < kMaxW; ++i) {
      if (i < w) {
        const float v = col[i * s_slot];
        const bool u = mrow[i] != 0;
        key[i] = key_of(v, u);
        live[i] = u && !isnan(v);
        count += u;
      }
    }
    const long long out = row * d + c;
    const float g = gy[out];
    float* grow = g_views + row * static_cast<long long>(w) * d + c;
    if (kMedian) {
      const float sv = self_vals[out];
      key[w] = key_of(sv, true);
      live[w] = !isnan(sv);
      const int n = count + 1;
      const int lo = (n - 1) / 2, hi = n / 2;
#pragma unroll
      for (int i = 0; i <= kMaxW; ++i) {
        if (i <= w) {
          int rank = 0;
#pragma unroll
          for (int k = 0; k <= kMaxW; ++k) {
            if (k <= w) rank += (key[k] < key[i]) || (key[k] == key[i] && k < i);
          }
          const float pick = 0.5f * (static_cast<float>(rank == lo) + static_cast<float>(rank == hi));
          const float gi = live[i] ? __fmul_rn(pick, g) : 0.0f;
          if (i < w) {
            grow[static_cast<long long>(i) * d] = gi;
          } else {
            g_self[out] = gi;
          }
        }
      }
    } else {
      const int bb = b_e != nullptr ? b_e[e] : b;
      const int widest = count > 0 ? (count - 1) / 2 : 0;
      const int b_eff = min(max(bb, 0), widest);
      const float scale = __fdiv_rn(g, static_cast<float>(count - 2 * b_eff + 1));
#pragma unroll
      for (int i = 0; i < kMaxW; ++i) {
        if (i < w) {
          int rank = 0;
#pragma unroll
          for (int k = 0; k < kMaxW; ++k) {
            if (k < w) rank += (key[k] < key[i]) || (key[k] == key[i] && k < i);
          }
          const bool kept = live[i] && rank >= b_eff && rank < count - b_eff;
          grow[static_cast<long long>(i) * d] = kept ? scale : 0.0f;
        }
      }
      g_self[out] = scale;
    }
  }
}

// Above 64 slots: the members (the slots, then the median's own value)
// ranked kChunk at a time against every member's key, read again from the
// column; the same keys, ranks and outputs as views_grad_kernel.
template <bool kMedian>
__global__ void __launch_bounds__(kThreads)
views_grad_wide_kernel(const float* __restrict__ views, long long s_exp, long long s_recv,
                       long long s_slot, const uint8_t* __restrict__ mask, long long s_mask,
                       const float* __restrict__ self_vals, const float* __restrict__ gy,
                       float* __restrict__ g_views, float* __restrict__ g_self, int e_count,
                       int m, int w, int d, int b, const int32_t* __restrict__ b_e) {
  constexpr int kChunk = 32;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const long long rows = static_cast<long long>(e_count) * m;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    if (c >= d) continue;
    const int e = static_cast<int>(row / m);
    const int j = static_cast<int>(row % m);
    const float* col = views + e * s_exp + j * s_recv + c;
    const uint8_t* mrow = mask + e * s_mask + static_cast<long long>(j) * w;
    int count = 0;
    for (int i = 0; i < w; ++i) count += mrow[i] != 0;
    const long long out = row * d + c;
    const float g = gy[out];
    const float sv = kMedian ? self_vals[out] : 0.0f;
    float* grow = g_views + row * static_cast<long long>(w) * d + c;
    const int members = w + (kMedian ? 1 : 0);
    int lo = 0, hi = 0, b_eff = 0;
    float scale = 0.0f;
    if (kMedian) {
      lo = count / 2;  // (n - 1) / 2 with n = count + 1 members
      hi = (count + 1) / 2;
    } else {
      const int bb = b_e != nullptr ? b_e[e] : b;
      const int widest = count > 0 ? (count - 1) / 2 : 0;
      b_eff = min(max(bb, 0), widest);
      scale = __fdiv_rn(g, static_cast<float>(count - 2 * b_eff + 1));
    }
    for (int i0 = 0; i0 < members; i0 += kChunk) {
      float key[kChunk];
      int rank[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t;
        key[t] = i < w ? key_of(col[i * s_slot], mrow[i] != 0) : key_of(sv, true);
        rank[t] = 0;
      }
      for (int k = 0; k < members; ++k) {
        const float kk = k < w ? key_of(col[k * s_slot], mrow[k] != 0) : key_of(sv, true);
#pragma unroll
        for (int t = 0; t < kChunk; ++t) {
          rank[t] += (kk < key[t]) || (kk == key[t] && k < i0 + t);
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        const int i = i0 + t;
        if (i >= members) break;
        const float v = i < w ? col[i * s_slot] : sv;
        const bool live = (i < w ? mrow[i] != 0 : true) && !isnan(v);
        if (kMedian) {
          const float pick = 0.5f * (static_cast<float>(rank[t] == lo) +
                                     static_cast<float>(rank[t] == hi));
          const float gi = live ? __fmul_rn(pick, g) : 0.0f;
          if (i < w) {
            grow[static_cast<long long>(i) * d] = gi;
          } else {
            g_self[out] = gi;
          }
        } else {
          const bool kept = live && rank[t] >= b_eff && rank[t] < count - b_eff;
          grow[static_cast<long long>(i) * d] = kept ? scale : 0.0f;
        }
      }
    }
    if (!kMedian) g_self[out] = scale;
  }
}

template <bool kMedian>
int launch(const float* views, long long s_exp, long long s_recv, long long s_slot,
           const uint8_t* mask, long long s_mask, const float* self_vals, const float* gy,
           float* g_views, float* g_self, int e_count, int m, int w, int d, int b,
           const int32_t* b_e, void* stream) {
  if (e_count < 1 || m < 1 || w < 1 || d < 1) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(e_count) * m;
  const dim3 grid((d + kThreads - 1) / kThreads,
                  static_cast<unsigned>(rows < kMaxGridY ? rows : kMaxGridY));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w <= 16) {
    views_grad_kernel<16, kMedian><<<grid, kThreads, 0, s>>>(
        views, s_exp, s_recv, s_slot, mask, s_mask, self_vals, gy, g_views, g_self, e_count, m,
        w, d, b, b_e);
  } else if (w <= 32) {
    views_grad_kernel<32, kMedian><<<grid, kThreads, 0, s>>>(
        views, s_exp, s_recv, s_slot, mask, s_mask, self_vals, gy, g_views, g_self, e_count, m,
        w, d, b, b_e);
  } else if (w <= 64) {
    views_grad_kernel<64, kMedian><<<grid, kThreads, 0, s>>>(
        views, s_exp, s_recv, s_slot, mask, s_mask, self_vals, gy, g_views, g_self, e_count, m,
        w, d, b, b_e);
  } else {
    views_grad_wide_kernel<kMedian><<<grid, kThreads, 0, s>>>(
        views, s_exp, s_recv, s_slot, mask, s_mask, self_vals, gy, g_views, g_self, e_count, m,
        w, d, b, b_e);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  views [E, M, W, d] float32 with unit
// coordinate stride and cell, node and slot strides s_exp, s_recv, s_slot
// in elements; mask uint8 [M, W] (s_mask 0) or [E, M, W] (s_mask = M W),
// contiguous; self_vals (the median's; unread by the trimmed mean), gy and
// g_self [E, M, d] contiguous; g_views [E, M, W, d] contiguous; the trimmed
// mean trims b_e[e] (int32 [E] on the card) or, with a null b_e, b.  Any
// W.  Each returns cudaGetLastError() after its launch
// (cudaErrorInvalidValue for a shape it does not take).
extern "C" int views_screen_grad_trimmed_mean(const float* views, long long s_exp,
                                              long long s_recv, long long s_slot,
                                              const uint8_t* mask, long long s_mask,
                                              const float* gy, float* g_views, float* g_self,
                                              int e_count, int m, int w, int d, int b,
                                              const int32_t* b_e, void* stream) {
  return launch<false>(views, s_exp, s_recv, s_slot, mask, s_mask, nullptr, gy, g_views, g_self,
                       e_count, m, w, d, b, b_e, stream);
}

extern "C" int views_screen_grad_median(const float* views, long long s_exp, long long s_recv,
                                        long long s_slot, const uint8_t* mask, long long s_mask,
                                        const float* self_vals, const float* gy, float* g_views,
                                        float* g_self, int e_count, int m, int w, int d,
                                        void* stream) {
  return launch<true>(views, s_exp, s_recv, s_slot, mask, s_mask, self_vals, gy, g_views, g_self,
                      e_count, m, w, d, 0, nullptr, stream);
}
