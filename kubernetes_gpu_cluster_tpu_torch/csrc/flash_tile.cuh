// One block's flash-attention tile machinery on CUDA cores: the fp32
// instance of the three attention kernels (paged_decode.cu,
// flash_prefill.cu, flash_prefill_hist.cu), whose bf16 instances run on the
// tensor cores (flash_mma.cuh).
//
// A block owns BQ query rows of one head and sweeps the keys it may attend
// in tiles of BK. Per tile: the K/V rows are gathered into shared memory in
// fp32 (the caller says where each key's row lives, so pages and flat
// layouts share one loader), scores S = Q K^T are formed with the caller's
// mask, and the fp32 online softmax (running max m, running sum l, rescale
// alpha) folds the tile into the per-thread output accumulators. Nothing but
// the final output row leaves the block.
//
// Plain CUDA cores, fp32 throughout: exact enough for the fp32 tests and
// debug models, which are not the served dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace kgct {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout of one tile. K rows are padded to HD + 1 floats so
// that the 32 lanes of a warp, each reading a different key at the same
// dimension, hit 32 different banks.
template <int BQ, int BK, int HD>
struct Tile {
  static constexpr int KP = HD + 1;
  static constexpr int kAcc = BQ * HD / kThreads;  // accumulators per thread
  static_assert((BQ * HD) % kThreads == 0, "BQ*HD must be a multiple of 128");
  static constexpr size_t kBytes =
      BK * sizeof(long long) +
      sizeof(float) * (BQ * HD + BK * KP + BK * HD + BQ * BK + 3 * BQ);

  long long* off;  // [BK] element offset of each key's head row, -1 = none
  float* q;        // [BQ][HD] pre-scaled queries
  float* k;        // [BK][KP]
  float* v;        // [BK][HD]
  float* s;        // [BQ][BK] scores, then probabilities
  float* m;        // [BQ] running max
  float* l;        // [BQ] running sum
  float* a;        // [BQ] this tile's rescale factor

  __device__ explicit Tile(unsigned char* base)
      : off(reinterpret_cast<long long*>(base)),
        q(reinterpret_cast<float*>(base + BK * sizeof(long long))),
        k(q + BQ * HD), v(k + BK * KP), s(v + BK * HD), m(s + BQ * BK),
        l(m + BQ), a(l + BQ) {}

  // Zero the running statistics. Visible after the next __syncthreads.
  __device__ void init_stats() {
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }

  // q row r <- src[row_of(r) ...] * scale (zeros where row_of(r) < 0).
  template <typename T, typename RowFn>
  __device__ void load_q(const T* src, float scale, RowFn row_of) {
    for (int e = threadIdx.x; e < BQ * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const long long o = row_of(r);
      q[e] = o >= 0 ? to_f(src[o + d]) * scale : 0.f;
    }
  }

  // Gather BK key rows into shared memory; keys with row_of(c) < 0 read as
  // zeros (never garbage: a masked key's probability is 0 and 0 * NaN
  // would still poison the row).
  template <typename T, typename RowFn>
  __device__ void load_kv(const T* kb, const T* vb, RowFn row_of) {
    for (int c = threadIdx.x; c < BK; c += kThreads) off[c] = row_of(c);
    __syncthreads();
    for (int e = threadIdx.x; e < BK * HD; e += kThreads) {
      const int c = e / HD, d = e - c * HD;
      const long long o = off[c];
      float kx = 0.f, vx = 0.f;
      if (o >= 0) {
        kx = to_f(kb[o + d]);
        vx = to_f(vb[o + d]);
      }
      k[c * KP + d] = kx;
      v[c * HD + d] = vx;
    }
    __syncthreads();
  }

  // Fold the loaded tile into the accumulators. valid(r, c) is the mask.
  template <typename Mask>
  __device__ void attend(float (&acc)[kAcc], Mask valid) {
    const int tid = threadIdx.x;
    for (int p = tid; p < BQ * BK; p += kThreads) {
      const int r = p / BK, c = p - r * BK;
      float x = -INFINITY;
      if (valid(r, c)) {
        const float* qr = q + r * HD;
        const float* kc = k + c * KP;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) dot = fmaf(qr[d], kc[d], dot);
        x = dot;
      }
      s[p] = x;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < BQ; r += kThreads / 32) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, s[r * BK + c]);
      mx = warp_max(mx);
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float x = s[r * BK + c];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        s[r * BK + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        // m_new == -inf: nothing valid yet in this row, keep the zeros.
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        a[r] = alpha;
        m[r] = m_new;
        l[r] = l[r] * alpha + sum;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / HD, d = e - r * HD;
      const float* pr = s + r * BK;
      float x = acc[i] * a[r];
      for (int c = 0; c < BK; ++c) x = fmaf(pr[c], v[c * HD + d], x);
      acc[i] = x;
    }
    __syncthreads();
  }

  // out row r <- acc / l (zeros where l == 0 or dst_of(r) < 0).
  template <typename T, typename RowFn>
  __device__ void store(T* dst, const float (&acc)[kAcc], RowFn dst_of) const {
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / HD, d = e - r * HD;
      const long long o = dst_of(r);
      if (o >= 0) {
        const float lr = l[r];
        dst[o + d] = from_f<T>(lr > 0.f ? acc[i] / lr : 0.f);
      }
    }
  }
};

// log2 of a power of two (host code: page sizes become shifts).
inline int ilog2(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

// Raise the dynamic shared-memory cap of `kernel` to `bytes` (needed above
// 48 KB) and launch nothing; returns the CUDA status.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace kgct
