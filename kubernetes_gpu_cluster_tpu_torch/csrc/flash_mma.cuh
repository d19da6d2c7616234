// Tensor-core building blocks for Hopper (sm_90a), shared by the kernels
// that run on mma.sync: cp.async copies, ldmatrix fragment loads, the
// m16n8k16 bf16 product with fp32 accumulation, and one warp's
// flash-attention tile (FlashAttention-2 style), used by the bf16 instances
// of flash_prefill.cu, flash_prefill_hist.cu and paged_decode.cu.
//
// Fragment layouts of mma.sync.m16n8k16 (gid = lane / 4, tig = lane % 4):
//   A 16x16 (row): a0 = (gid, 2tig..+1), a1 = (gid+8, 2tig..+1),
//                  a2 = (gid, 2tig+8..+9), a3 = (gid+8, 2tig+8..+9)
//   B 16x8 (col):  b0 = (k 2tig..+1, n gid), b1 = (k 2tig+8..+9, n gid)
//   C 16x8:        c0,c1 = (gid, 2tig..+1), c2,c3 = (gid+8, 2tig..+1)
// so the accumulators of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of the next product over those 16 columns: softmax
// probabilities never leave registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kgct {
namespace mma {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; valid == false zero-fills (source size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}
// {lo, hi} -> bf16x2 with lo in the low half (the lower column / k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8, and register i receives matrix i in the A/B fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// The same, each matrix transposed: rows given along k yield B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on the tensor cores, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's 16 query rows of flash attention with head dim HD, over K/V
// tiles of BK keys staged in shared memory as bf16 rows of RS bytes
// (RS = 2 HD + 16: the 16-byte pad puts the eight rows of an ldmatrix
// matrix on eight different groups of four banks).
//
// Scores are formed in fp32 by mma from register-held Q fragments and
// ldmatrix K fragments, scaled in fp32 by scale * log2(e) (hd^-0.5 is not a
// power of two, so it is not folded into a bf16 Q), and folded by the online
// softmax in the exp2 domain. Each thread holds rows gid and gid + 8: row
// max and row sum reduce over the four lanes of a quad. The probabilities
// are rounded to bf16 for the P.V product (2^-9 relative per term; the
// running sum l keeps them in fp32).
template <int HD, int BK>
struct AttnWarp {
  static constexpr int RS = 2 * HD + 16;
  static constexpr int KD = HD / 16;  // k-steps of Q.K^T
  static constexpr int ND = HD / 8;   // n8 tiles of the output
  static constexpr int NK = BK / 8;   // n8 tiles of the scores
  static_assert(HD % 16 == 0 && BK % 16 == 0, "tile sizes");

  uint32_t qf[KD][4];
  float o[ND][4];
  float m[2];  // running max (log2 domain) of rows gid, gid + 8
  float l[2];  // this thread's share of the running sum

  __device__ void init() {
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
  }

  // Q fragments of the warp's 16 rows, which start at qs.
  __device__ void load_q(const unsigned char* qs) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      ldmatrix_x4(qf[kd], qs + (lane % 16) * RS + (kd * 16 + (lane / 16) * 8) * 2);
  }

  // Fold one tile: ks, vs point at BK key rows. valid(hi, c) says whether
  // row gid + 8 hi may attend key c of the tile; MASK == false skips it.
  template <bool MASK, typename Valid>
  __device__ void attend(const unsigned char* ks, const unsigned char* vs, float scale_log2,
                         Valid valid) {
    const int lane = threadIdx.x % 32, tig = lane % 4;
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, ks + (np * 16 + lane % 8 + (lane / 16) * 8) * RS +
                           (kd * 16 + ((lane / 8) % 2) * 8) * 2);
        mma_bf16(s[2 * np], qf[kd], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kd], b[2], b[3]);
      }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[n][j] * scale_log2;
        if (MASK && !valid(j >= 2, n * 8 + 2 * tig + (j & 1))) x = -INFINITY;
        s[n][j] = x;
        mx[j >= 2] = fmaxf(mx[j >= 2], x);
      }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // Nothing valid in this row yet: keep l = 0 and the zeros, and never
      // form -inf - -inf.
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[n][j] - m_use[j >= 2]);
        s[n][j] = p;
        sum[j >= 2] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vs + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * RS +
                                 (dp * 16 + (lane / 16) * 8) * 2);
        mma_bf16(o[2 * dp], a, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }

  // out rows row0 (gid) and row0 + 8 <- o / l, zeros where l == 0; rows
  // with a null pointer are not stored. Rows are bf16 [HD].
  __device__ void store(__nv_bfloat16* row_lo, __nv_bfloat16* row_hi) {
    const int tig = threadIdx.x % 4;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = l[h];
      t += __shfl_xor_sync(0xffffffffu, t, 1);
      t += __shfl_xor_sync(0xffffffffu, t, 2);
      inv[h] = t > 0.f ? 1.f / t : 0.f;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = n * 8 + 2 * tig;
      if (row_lo)
        *reinterpret_cast<__nv_bfloat162*>(row_lo + c) =
            __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
      if (row_hi)
        *reinterpret_cast<__nv_bfloat162*>(row_hi + c) =
            __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
    }
  }
};

}  // namespace mma
}  // namespace kgct
