// W4A16 dequant-fused matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/int4_matmul.py
// (pallas_int4_matmul, body _int4_matmul_kernel):
//   out[T, N] f32 = x[T, K] @ dequant(w_packed [K/2, N] int8, scale [K/gs, N] f32)
// where byte i of a column holds input rows 2i (low nibble) and 2i+1 (high
// nibble), each a signed 4-bit value, and row k dequantizes as
// nibble * scale[k / gs].
//
// Bound on the H100: bytes at decode (T <= 32 rows: each packed byte feeds
// 4 * T flops, far below the ~295 flops/byte where the tensor cores would
// become the limit), operations at prefill (T = 2048).
//
// Design. A block owns a BM x 128 output tile (BM = 16, 32 or 64 rows by T)
// of one K slice and walks it in stages of 128 rows through a 3-deep
// cp.async ring in shared memory holding the packed bytes, the scale rows
// and the x tile, so each packed byte leaves device memory once per row
// tile: once in all at decode, where one row tile covers every row. Nibbles
// become bf16 values in registers by bit operations (exact, -8..7) and feed
// mma.sync m16n8k16 tensor-core products with fp32 accumulation. Each scale
// group gets its own partial sum, folded into the output accumulator times
// scale[g, n]: the JAX package's tgi,gio->tgo then tgo,go->to order, with
// every product exact, since no dequantized weight is rounded to bf16. An
// fp32 x is split into three bf16 terms (hi + mid + lo) so the same
// tensor-core path keeps fp32 accuracy. No dequantized weight is ever
// written to memory.
//
// A warp owns 32 columns as four 8-column mma tiles interleaved (tile t
// holds columns 4j + t), so one 32-bit shared load of four neighbouring
// packed bytes feeds all four tiles. When the output tiles alone cannot fill
// the card (decode), the wrapper cuts K into slices of whole groups, one
// block per slice writes its partial to a workspace, and a second pass sums
// the slices in a fixed order, so results do not depend on timing.
//
// The TPU kernel's sublane stack/reshape, its revisited output block over a
// sequential K grid and its 128-lane tiles answer Mosaic's rules and have no
// counterpart here. A step of 16 rows must lie inside one group, so gs is a
// multiple of 16. wgmma/TMA tiles and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace kgct {
namespace {

constexpr int kThreads = 128;          // four warps, side by side along N
constexpr int kWarpN = 32;             // columns per warp: four mma tiles
constexpr int kBN = 4 * kWarpN;        // columns per block
constexpr int kKC = 128;               // K rows per pipeline stage
// Pipeline depth. Three keep a 64-row bf16 block under 114 KB of shared
// memory, so two share an SM; at decode, more resident blocks beat a
// fourth stage (measured on the H100).
constexpr int kStages = 3;
// Packed-row stride in shared memory: 160 bytes puts the four rows a warp
// reads for one fragment on four disjoint groups of eight banks.
constexpr int kWRow = kBN + 32;
// Scale rows a stage can touch: its 128 rows span at most 128/16 + 1 groups.
constexpr int kSRows = kKC / 16 + 1;

template <typename XT> struct XSplit;
template <> struct XSplit<__nv_bfloat16> { static constexpr int k = 1; };
template <> struct XSplit<float> { static constexpr int k = 3; };

template <typename XT, int MT>
struct Stage {
  static constexpr int BM = 16 * MT;
  // x rows padded by 16 bytes: ldmatrix's eight rows hit eight bank groups.
  static constexpr int kXRow = kKC * static_cast<int>(sizeof(XT)) + 16;
  static constexpr int kWBytes = (kKC / 2) * kWRow;
  static constexpr int kSBytes = kSRows * kBN * 4;
  static constexpr int kBytes = kWBytes + kSBytes + BM * kXRow;
  static constexpr size_t kSmem = static_cast<size_t>(kStages) * kBytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
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

template <typename XT> __device__ __forceinline__ XT zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t v) {
  return *reinterpret_cast<__nv_bfloat162*>(&v);
}

// One packed byte (bits 0-7 of b) -> its two nibbles as bf16 {low, high},
// the low half being the even input row, as mma's B fragment wants. Each
// nibble n goes into the mantissa of 128.0 as n ^ 8 (bf16 0x4300 | (n ^ 8)
// is 128 + (n ^ 8)); subtracting 136 leaves (n ^ 8) - 8, the signed value,
// exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t b) {
  const uint32_t t = ((b | (b << 12)) & 0x000F000Fu) ^ 0x43084308u;
  return as_u32(__hsub2(as_bf162(t), as_bf162(0x43084308u)));
}

// A-fragment registers of the 16x16 x slice at tile rows [r, r + 16),
// columns [c, c + 16), split into kSplit bf16 terms whose sum is x.
template <int XROW>
__device__ __forceinline__ void load_a(uint32_t (&a)[1][4], const unsigned char* xs, int r,
                                       int c, const __nv_bfloat16*) {
  const int lane = threadIdx.x % 32;
  const unsigned addr = smem_addr(xs + (r + lane % 16) * XROW + (c + (lane / 16) * 8) * 2);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0][0]), "=r"(a[0][1]), "=r"(a[0][2]), "=r"(a[0][3])
               : "r"(addr));
}

__device__ __forceinline__ void split3(float2 v, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v.x, v.y);
  const float rx = v.x - __low2float(h), ry = v.y - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float qx = rx - __low2float(m), qy = ry - __high2float(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(qx, qy));
}

template <int XROW>
__device__ __forceinline__ void load_a(uint32_t (&a)[3][4], const unsigned char* xs, int r,
                                       int c, const float*) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const unsigned char* r0 = xs + (r + gid) * XROW + (c + 2 * tig) * 4;
  const unsigned char* r1 = r0 + 8 * XROW;
  const float2 v[4] = {*reinterpret_cast<const float2*>(r0),
                       *reinterpret_cast<const float2*>(r1),
                       *reinterpret_cast<const float2*>(r0 + 32),
                       *reinterpret_cast<const float2*>(r1 + 32)};
#pragma unroll
  for (int i = 0; i < 4; ++i) split3(v[i], a[0][i], a[1][i], a[2][i]);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage, for K rows [k0, min(k0 + kKC, kend)) and columns [n0, n0 + kBN):
// the packed rows, the scale rows of the groups from k0 / gs on, and the x
// tile rows [m0, m0 + BM); zeros outside the tensors. vec: 16-byte
// cp.async copies (N % 16 == 0 and 16-byte aligned pointers); else plain
// loads and stores, visible after the next __syncthreads like the copies.
template <typename XT, int MT>
__device__ __forceinline__ void load_stage(unsigned char* st, const XT* x, const int8_t* w,
                                           const float* scale, int T, int K, int N, int gs,
                                           int m0, int n0, int k0, int kend, bool vec) {
  using S = Stage<XT, MT>;
  unsigned char* ws = st;
  float* ss = reinterpret_cast<float*>(st + S::kWBytes);
  unsigned char* xs = st + S::kWBytes + S::kSBytes;
  const int pr0 = k0 / 2, prend = kend / 2, g0 = k0 / gs, n_groups = K / gs;
  constexpr int kPer = 16 / static_cast<int>(sizeof(XT));  // x elements per 16 bytes
  if (vec) {
    for (int c = threadIdx.x; c < (kKC / 2) * (kBN / 16); c += kThreads) {
      const int r = c / (kBN / 16), j = (c % (kBN / 16)) * 16;
      const bool ok = pr0 + r < prend && n0 + j < N;
      cp_async16(ws + r * kWRow + j, ok ? w + static_cast<long long>(pr0 + r) * N + n0 + j : w,
                 ok);
    }
    for (int c = threadIdx.x; c < kSRows * (kBN / 4); c += kThreads) {
      const int r = c / (kBN / 4), j = (c % (kBN / 4)) * 4;
      const bool ok = g0 + r < n_groups && n0 + j < N;
      cp_async16(ss + r * kBN + j,
                 ok ? scale + static_cast<long long>(g0 + r) * N + n0 + j : scale, ok);
    }
    for (int c = threadIdx.x; c < S::BM * (kKC / kPer); c += kThreads) {
      const int r = c / (kKC / kPer), j = (c % (kKC / kPer)) * kPer;
      const bool ok = m0 + r < T && k0 + j < kend;
      cp_async16(xs + r * S::kXRow + j * static_cast<int>(sizeof(XT)),
                 ok ? x + static_cast<long long>(m0 + r) * K + k0 + j : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (kKC / 2) * kBN; e += kThreads) {
      const int r = e / kBN, j = e % kBN;
      const bool ok = pr0 + r < prend && n0 + j < N;
      ws[r * kWRow + j] = ok ? static_cast<unsigned char>(
                                   w[static_cast<long long>(pr0 + r) * N + n0 + j])
                             : 0;
    }
    for (int e = threadIdx.x; e < kSRows * kBN; e += kThreads) {
      const int r = e / kBN, j = e % kBN;
      const bool ok = g0 + r < n_groups && n0 + j < N;
      ss[r * kBN + j] = ok ? scale[static_cast<long long>(g0 + r) * N + n0 + j] : 0.f;
    }
    for (int e = threadIdx.x; e < S::BM * kKC; e += kThreads) {
      const int r = e / kKC, j = e % kKC;
      const bool ok = m0 + r < T && k0 + j < kend;
      reinterpret_cast<XT*>(xs + r * S::kXRow)[j] =
          ok ? x[static_cast<long long>(m0 + r) * K + k0 + j] : zero<XT>();
    }
  }
}

// Block (bx, by, s): output columns [128 bx, +128), rows [BM by, +BM), K
// slice s = rows [s * slice, min(K, (s + 1) * slice)), slice a multiple of
// gs. Writes dst[s][T][N] (dst is the output itself when there is one slice).
template <typename XT, int MT>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ dst, int T, int K,
                   int N, int gs, int slice, int vec) {
  using S = Stage<XT, MT>;
  constexpr int kSplit = XSplit<XT>::k;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * S::BM;
  const int kbeg = blockIdx.z * slice, kend = min(K, kbeg + slice);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wn = warp * kWarpN;  // the warp's first column in the tile
  const int n_stages = (kend - kbeg + kKC - 1) / kKC;

  float acc[MT][4][4];
  float part[MT][4][4];
  float sc[4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = part[mt][nt][j] = 0.f;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) sc[nt][0] = sc[nt][1] = 0.f;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_stages)
      load_stage<XT, MT>(smem + s * S::kBytes, x, w, scale, T, K, N, gs, m0, n0,
                         kbeg + s * kKC, kend, vec);
    cp_async_commit();
  }
  int grem = gs;          // rows left in the current group (slices start on one)
  int g = kbeg / gs;      // the current group
  for (int i = 0; i < n_stages; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage i is in; every warp is done with stage i - 1
    const int nxt = i + kStages - 1;
    if (nxt < n_stages)
      load_stage<XT, MT>(smem + (nxt % kStages) * S::kBytes, x, w, scale, T, K, N, gs, m0,
                         n0, kbeg + nxt * kKC, kend, vec);
    cp_async_commit();

    const unsigned char* ws = smem + (i % kStages) * S::kBytes;
    const float* ss = reinterpret_cast<const float*>(ws + S::kWBytes);
    const unsigned char* xs = ws + S::kWBytes + S::kSBytes;
    const int k0 = kbeg + i * kKC;
    const int g_stage = k0 / gs;
    const int rows = min(kKC, kend - k0);
    for (int kk = 0; kk < rows; kk += 16) {
      if (grem == gs) {  // a group starts: fresh partials, its scales
        // Accumulators j & 1 of tile nt sit in columns wn + 8 tig + nt (+ 4).
        const float* srow = ss + (g - g_stage) * kBN + wn + 8 * tig;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          sc[nt][0] = srow[nt];
          sc[nt][1] = srow[nt + 4];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.f;
      }
      // Packed rows kk/2 + tig and + 4 (input rows 2 tig, 2 tig + 1 and
      // + 8), four neighbouring columns: byte t feeds mma tile t.
      const uint32_t w0 =
          *reinterpret_cast<const uint32_t*>(ws + (kk / 2 + tig) * kWRow + wn + 4 * gid);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
          ws + (kk / 2 + tig + 4) * kWRow + wn + 4 * gid);
      uint32_t b[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        b[nt][0] = nibbles_bf16x2((w0 >> (8 * nt)) & 0xFFu);
        b[nt][1] = nibbles_bf16x2((w1 >> (8 * nt)) & 0xFFu);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[kSplit][4];
        load_a<S::kXRow>(a, xs, mt * 16, kk, static_cast<const XT*>(nullptr));
#pragma unroll
        for (int sp = 0; sp < kSplit; ++sp)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(part[mt][nt], a[sp], b[nt][0], b[nt][1]);
      }
      grem -= 16;
      if (grem == 0) {  // the group ends: fold its partials
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[mt][nt][j] = fmaf(part[mt][nt][j], sc[nt][j & 1], acc[mt][nt][j]);
        grem = gs;
        ++g;
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator j of mma tile nt: tile row gid (+8 for j >= 2), tile column
  // 2 tig + (j & 1), which is block column wn + 4 (2 tig + (j & 1)) + nt.
  float* out = dst + static_cast<long long>(blockIdx.z) * T * N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m0 + mt * 16 + gid + (j >= 2 ? 8 : 0);
        const int col = n0 + wn + 4 * (2 * tig + (j & 1)) + nt;
        if (row < T && col < N) out[static_cast<long long>(row) * N + col] = acc[mt][nt][j];
      }
}

// out[i] = sum over s of ws[s][i], in slice order (deterministic).
__global__ void sum_slices_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                  long long n, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * n + i];
    out[i] = s;
  }
}

template <typename XT, int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* dst, int T, int K,
                   int N, int gs, int splits, int slice, int vec, cudaStream_t stream) {
  using S = Stage<XT, MT>;
  auto kernel = int4_matmul_kernel<XT, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(S::kSmem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (T + S::BM - 1) / S::BM, splits);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, S::kSmem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(dst), T, K, N, gs, slice, vec);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_rows(int mt, const void* x, const void* w, const void* scale, void* dst,
                          int T, int K, int N, int gs, int splits, int slice, int vec,
                          cudaStream_t s) {
  if (mt == 1) return launch<XT, 1>(x, w, scale, dst, T, K, N, gs, splits, slice, vec, s);
  if (mt == 2) return launch<XT, 2>(x, w, scale, dst, T, K, N, gs, splits, slice, vec, s);
  if (mt == 4) return launch<XT, 4>(x, w, scale, dst, T, K, N, gs, splits, slice, vec, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace kgct

// x_dtype: 0 = float32, 1 = bfloat16. The wrapper has checked the shapes
// (K = 2 * rows of w_packed, K % gs == 0, gs % 16 == 0) and planned the
// launch: mt m16 tiles per block row (1, 2 or 4), `splits` K slices of
// `slice` rows (a multiple of gs), `ws` a [splits, T, N] f32 workspace when
// splits > 1. vec != 0 when N % 16 == 0 and x, w_packed, scale are 16-byte
// aligned. Returns the CUDA status of the launches.
extern "C" int kgct_int4_matmul(const void* x, const void* w_packed, const void* scale,
                                void* out, void* ws, int T, int K, int N, int gs, int x_dtype,
                                int mt, int splits, int slice, int vec, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (T == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || gs <= 0 || gs % 16 || K % gs || splits < 1 || slice % gs ||
      static_cast<long long>(splits) * slice < K || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  void* dst = splits > 1 ? ws : out;
  cudaError_t err;
  if (x_dtype == 1)
    err = dispatch_rows<__nv_bfloat16>(mt, x, w_packed, scale, dst, T, K, N, gs, splits, slice,
                                       vec, s);
  else if (x_dtype == 0)
    err = dispatch_rows<float>(mt, x, w_packed, scale, dst, T, K, N, gs, splits, slice, vec, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(T) * N;
  const int blocks = n > 1024LL * 256 ? 1024 : static_cast<int>((n + 255) / 256);
  sum_slices_kernel<<<blocks, 256, 0, s>>>(static_cast<const float*>(ws),
                                           static_cast<float*>(out), n, splits);
  return cudaGetLastError();
}

extern "C" const char* kgct_int4_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
