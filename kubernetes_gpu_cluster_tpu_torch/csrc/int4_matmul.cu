// W4A16 dequant-fused matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/int4_matmul.py
// (pallas_int4_matmul, body _int4_matmul_kernel):
//   out[T, N] f32 = x[T, K] @ dequant(w_packed [K/2, N] int8, scale [K/gs, N] f32)
// where byte i of a column holds input rows 2i (low nibble) and 2i+1 (high
// nibble), each a signed 4-bit value, and row k dequantizes as
// nibble * scale[k / gs].
//
// Bound on the H100: bytes at decode (T <= 64 rows: each packed byte feeds
// 4 * T flops, far below the ~295 flops/byte where the tensor cores would
// become the limit), operations at prefill (T = 2048).
//
// Arithmetic (both tiles). Nibbles become exact bf16 integers (-8..7, by bit
// operations on 128.0's mantissa) and feed mma.sync m16n8k16 with fp32
// accumulation. Each scale group gets its own partial sum, folded into the
// output accumulator times scale[g, n] at the group's end: the JAX
// package's tgi,gio->tgo then tgo,go->to order, every product exact, no
// dequantized weight rounded. An fp32 x enters as three bf16 terms
// (hi + mid + lo), so the same tensor-core path keeps fp32 accuracy.
//
// Schedule (both tiles): one launch per call. The work is the list of
// (output tile, scale group) units, tile-major. The grid holds exactly the
// blocks the card keeps resident (sms x blocks per SM, from the occupancy
// API through the wrapper's plan), and block b takes units
// [b U / P, (b + 1) U / P): every block, hence every SM, reads the same
// packed bytes to within one group. A block's range cuts at most its first
// and last tile; a tile wholly inside one block is stored directly. A cut
// tile's contributors each write their partial to a workspace slot and
// count themselves in a per-tile counter (one release-acquire atomic per
// block); the block that arrives last
// sums the partials in block order (so the bits do not depend on arrival
// order) and resets the counter to 0 for the next call or graph replay.
// The wrapper keeps workspace and counters per device and assumes one
// stream. Every tile leaves the block through shared memory, a few rows at
// a time, so the output, the partials and their sum move as 16-byte
// coalesced rows; at decode the next segment's first stages are already in
// flight while a finished tile is stored.
//
// Decode tile (T <= 64, and fp32 x at any T): a BM x 32W output tile (BM =
// 16, 32 or 64 rows, W warps side by side), a warp owning 32 columns as four
// 8-column mma tiles interleaved (tile t holds columns 4j + t), so one
// 32-bit shared load of four neighbouring packed bytes feeds all four; the
// nibbles are decoded in registers, once per row tile, which at decode is
// once in all. 128-row K stages stream through a cp.async ring (packed
// bytes, the scale rows the stage touches, the x tile).
//
// Prefill tile (bf16 x, T > 64): a 128 x 128 output tile per block, whole
// tiles strided over the grid in row-tile-first order (the blocks in flight
// share the weight columns and x rows they read, which stay in L2; no
// partials). Four warpgroups with their own jobs hand 64-row K stages
// through a ring of shared-memory slots by named barriers. Warpgroups 0
// and 1 produce: one thread starts the stage's TMA copies of x and the
// packed bytes (128-byte swizzle, completion on the slot's mbarrier; plain
// cp.async when the operands are not 16-byte aligned), all copy the scale
// rows, then they decode the packed bytes ONCE into a bf16 tile of exact
// integers, the B operand, MN-major and swizzled (a packed byte is decoded
// once per 128 rows of x). Warpgroups 2 and 3 consume: wgmma m64n128k16
// (sm_90a) on 64 rows each, the group fold, stores through shared memory;
// each waits on its own full barriers, so one can fold while the other's
// products run. setmaxnreg moves registers from producers to consumers. A
// group's first product replaces the partial (no zeroing). The producers
// run up to a ring's depth ahead, across tiles; their decode still bounds
// the tile (see PERF.md).
//
// A step of 16 rows must lie inside one group, so gs is a multiple of 16.
// TMA copies are later work. For the tuning sweep
// (kubernetes_gpu_cluster_tpu_torch/tools/int4_sweep.py) the ring depths
// (-DKGCT_INT4_DECODE_STAGES=n, -DKGCT_INT4_PREFILL_STAGES=n), the decode
// tile's warps (-DKGCT_INT4_DECODE_WARPS=W) and the blocks per SM its
// registers are capped for (-DKGCT_INT4_DECODE_MIN_BLOCKS=b) can be set at
// build time.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_mma.cuh"

#ifndef KGCT_INT4_DECODE_STAGES
#define KGCT_INT4_DECODE_STAGES 3
#endif
#ifndef KGCT_INT4_DECODE_WARPS
#define KGCT_INT4_DECODE_WARPS 4
#endif
#ifndef KGCT_INT4_DECODE_MIN_BLOCKS
#define KGCT_INT4_DECODE_MIN_BLOCKS 1
#endif
#ifndef KGCT_INT4_PREFILL_STAGES
#define KGCT_INT4_PREFILL_STAGES 4
#endif

namespace kgct {
namespace {

using mma::as_bf162;
using mma::as_u32;

template <typename XT> struct XSplit;
template <> struct XSplit<__nv_bfloat16> { static constexpr int k = 1; };
template <> struct XSplit<float> { static constexpr int k = 3; };

template <typename XT> __device__ __forceinline__ XT zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Shared-memory layout of one stage of KC input rows: packed rows (stride
// WROW bytes), the scale rows of the groups the stage touches (at most
// KC/16 + 1), x rows (padded by 16 bytes so ldmatrix's eight rows hit
// eight bank groups).
template <typename XT, int BM, int BN, int WROW, int KC>
struct Stage {
  static constexpr int kSRows = KC / 16 + 1;
  static constexpr int kXRow = KC * static_cast<int>(sizeof(XT)) + 16;
  static constexpr int kWBytes = (KC / 2) * WROW;
  static constexpr int kSBytes = kSRows * BN * 4;
  static constexpr int kBytes = kWBytes + kSBytes + BM * kXRow;
};

// One packed byte (bits 0-7 of b) -> its two nibbles as bf16 {low, high},
// the low half being the even input row, as mma's B fragment wants. Each
// nibble n goes into the mantissa of 128.0 as n ^ 8 (bf16 0x4300 | (n ^ 8)
// is 128 + (n ^ 8)); subtracting 136 leaves (n ^ 8) - 8, the signed value,
// exactly.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t b) {
  const uint32_t t = ((b | (b << 12)) & 0x000F000Fu) ^ 0x43084308u;
  return as_u32(__hsub2(as_bf162(t), as_bf162(0x43084308u)));
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

// A-fragment registers of the 16x16 x slice at tile rows [r, r + 16),
// columns [c, c + 16), split into kSplit bf16 terms whose sum is x.
template <int XROW>
__device__ __forceinline__ void load_a(uint32_t (&a)[1][4], const unsigned char* xs, int r,
                                       int c, const __nv_bfloat16*) {
  const int lane = threadIdx.x % 32;
  mma::ldmatrix_x4(a[0], xs + (r + lane % 16) * XROW + (c + (lane / 16) * 8) * 2);
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

// Stage, for K rows [k0, min(k0 + KC, kend)) and columns [n0, n0 + BN):
// the packed rows, the scale rows of the groups those rows touch, and the x tile rows [m0, m0 + BM); zeros outside the tensors. vec:
// 16-byte cp.async copies (N % 16 == 0 and 16-byte aligned pointers); else
// plain loads and stores, visible after the next __syncthreads like the
// copies.
template <typename XT, int BM, int BN, int WROW, int KC, int NT>
__device__ __forceinline__ void load_stage(unsigned char* st, const XT* x, const int8_t* w,
                                           const float* scale, int T, int K, int N, int gs,
                                           int m0, int n0, int k0, int kend, bool vec) {
  using S = Stage<XT, BM, BN, WROW, KC>;
  unsigned char* ws = st;
  float* ss = reinterpret_cast<float*>(st + S::kWBytes);
  unsigned char* xs = st + S::kWBytes + S::kSBytes;
  const int pr0 = k0 / 2, prend = kend / 2, g0 = k0 / gs;
  const int s_rows = (min(k0 + KC, kend) - 1) / gs - g0 + 1;
  constexpr int kPer = 16 / static_cast<int>(sizeof(XT));  // x elements per 16 bytes
  if (vec) {
    for (int c = threadIdx.x; c < (KC / 2) * (BN / 16); c += NT) {
      const int r = c / (BN / 16), j = (c % (BN / 16)) * 16;
      const bool ok = pr0 + r < prend && n0 + j < N;
      mma::cp_async16(ws + r * WROW + j,
                      ok ? w + static_cast<long long>(pr0 + r) * N + n0 + j : w, ok);
    }
    for (int c = threadIdx.x; c < s_rows * (BN / 4); c += NT) {
      const int r = c / (BN / 4), j = (c % (BN / 4)) * 4;
      const bool ok = n0 + j < N;
      mma::cp_async16(ss + r * BN + j,
                      ok ? scale + static_cast<long long>(g0 + r) * N + n0 + j : scale, ok);
    }
    for (int c = threadIdx.x; c < BM * (KC / kPer); c += NT) {
      const int r = c / (KC / kPer), j = (c % (KC / kPer)) * kPer;
      const bool ok = m0 + r < T && k0 + j < kend;
      mma::cp_async16(xs + r * S::kXRow + j * static_cast<int>(sizeof(XT)),
                      ok ? x + static_cast<long long>(m0 + r) * K + k0 + j : x, ok);
    }
  } else {
    for (int e = threadIdx.x; e < (KC / 2) * BN; e += NT) {
      const int r = e / BN, j = e % BN;
      const bool ok = pr0 + r < prend && n0 + j < N;
      ws[r * WROW + j] =
          ok ? static_cast<unsigned char>(w[static_cast<long long>(pr0 + r) * N + n0 + j]) : 0;
    }
    for (int e = threadIdx.x; e < s_rows * BN; e += NT) {
      const int r = e / BN, j = e % BN;
      ss[r * BN + j] = n0 + j < N ? scale[static_cast<long long>(g0 + r) * N + n0 + j] : 0.f;
    }
    for (int e = threadIdx.x; e < BM * KC; e += NT) {
      const int r = e / KC, j = e % KC;
      const bool ok = m0 + r < T && k0 + j < kend;
      reinterpret_cast<XT*>(xs + r * S::kXRow)[j] =
          ok ? x[static_cast<long long>(m0 + r) * K + k0 + j] : zero<XT>();
    }
  }
}

// ---- the schedule shared by both tiles ------------------------------------

struct Sched {
  long long units;  // tiles * groups
  int groups;       // K / gs
  int blocks;       // gridDim.x
  int tiles_n;      // column tiles
};

__device__ __forceinline__ long long unit_lo(const Sched& s, int b) {
  return static_cast<long long>(b) * s.units / s.blocks;
}
// The block whose range holds unit u.
__device__ __forceinline__ int block_of(const Sched& s, long long u) {
  return static_cast<int>(((u + 1) * s.blocks - 1) / s.units);
}
// Workspace slot of block b's partial of tile t: 2b for the tile its range
// starts in, 2b + 1 for the tile it ends in.
__device__ __forceinline__ long long slot_of(const Sched& s, int b, long long t) {
  return 2LL * b + (unit_lo(s, b) / s.groups != t);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Stores a row piece [r, r + 4) of a tile row: 16 bytes when N % 4 == 0,
// else element by element, nothing at columns >= N.
__device__ __forceinline__ void store4(float* __restrict__ out, long long row, int col, int N,
                                       float4 v) {
  float* dst = out + row * N + col;
  if (N % 4 == 0) {
    *reinterpret_cast<float4*>(dst) = v;
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j < N) dst[j] = a[j];
  }
}

// After a segment of tile `tile` (rows [m0, m0 + BM), columns [n0, + BN)):
// store its values straight to out when this block owns the whole tile,
// else through the workspace and the last-arriver sum described at the top.
// The values leave the registers OTR rows at a time through `ot` (OTR x
// (BN + 4) floats of shared memory): stage(r0) writes the thread's values
// of tile rows [r0, r0 + OTR) there. All global traffic moves as 16-byte
// pieces of rows.
template <int BM, int BN, int NT, int OTR, typename StageRows>
__device__ void finish_segment(const Sched& s, long long tile, int m0, int n0, float* ot,
                               StageRows stage, float* __restrict__ out, float* __restrict__ ws,
                               int* __restrict__ counters, int T, int N) {
  __shared__ int last;
  constexpr int kORow = BN + 4;
  constexpr int kC4 = BN / 4;  // 16-byte pieces per tile row
  const int first_b = block_of(s, tile * s.groups);
  const int last_b = block_of(s, tile * s.groups + s.groups - 1);
  const int rows = min(BM, T - m0);
  const bool cut = first_b != last_b;
  float* mine = ws + slot_of(s, blockIdx.x, tile) * (BM * BN);
  for (int r0 = 0; r0 < rows; r0 += OTR) {
    stage(r0);
    __syncthreads();
    for (int e = threadIdx.x; e < min(OTR, rows - r0) * kC4; e += NT) {
      const int r = e / kC4, c = (e % kC4) * 4;
      const float4 v = *reinterpret_cast<const float4*>(ot + r * kORow + c);
      if (cut)
        __stcg(reinterpret_cast<float4*>(mine + (r0 + r) * BN + c), v);
      else if (n0 + c < N)
        store4(out, m0 + r0 + r, n0 + c, N, v);
    }
    __syncthreads();  // ot is free for the next rows
  }
  if (!cut) return;
  // The barrier above orders the block's partial before thread 0's count,
  // whose release makes it visible device-wide; the acquire side of the
  // same atomic, then the barrier, order the last block's reads after every
  // contributor's partial.
  if (threadIdx.x == 0) {
    int seen;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(seen)
                 : "l"(counters + tile)
                 : "memory");
    last = seen == last_b - first_b;
    if (last) counters[tile] = 0;  // every contributor has counted: reset
  }
  __syncthreads();
  if (!last) return;
  // Each thread sums its kPer pieces over the contributors in block order
  // (deterministic), one contributor's pieces in flight at a time.
  constexpr int kPer = BM * kC4 / NT;
  static_assert(BM * kC4 % NT == 0, "whole pieces per thread");
  float4 v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int b = first_b; b <= last_b; ++b) {
    const float* src = ws + slot_of(s, b, tile) * (BM * BN);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = threadIdx.x + i * NT, r = e / kC4, c = (e % kC4) * 4;
      if (r < rows) v[i] = add4(v[i], __ldcg(reinterpret_cast<const float4*>(src + r * BN + c)));
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = threadIdx.x + i * NT, r = e / kC4, c = (e % kC4) * 4;
    if (r < rows && n0 + c < N) store4(out, m0 + r, n0 + c, N, v[i]);
  }
}

// ---- decode tile ----------------------------------------------------------

constexpr int kDNW = KGCT_INT4_DECODE_WARPS;  // warps, side by side along N
constexpr int kDThreads = 32 * kDNW;
constexpr int kDBN = 32 * kDNW;     // columns per tile: 32 per warp, four mma tiles
constexpr int kDKC = 128;           // K rows per stage
constexpr int kDStages = KGCT_INT4_DECODE_STAGES;
// Packed-row stride: 32 bytes past a multiple of 128 puts the four rows a
// warp reads for one fragment on four disjoint groups of eight banks.
constexpr int kDWRow = kDBN + 32;
static_assert(kDStages >= 2, "decode ring depth");

template <typename XT, int MT>
struct Decode {
  static constexpr int BM = 16 * MT;
  using S = Stage<XT, BM, kDBN, kDWRow, kDKC>;
  static constexpr size_t kSmem = static_cast<size_t>(kDStages) * S::kBytes;
  static_assert(16 * (kDBN + 4) * 4 <= S::kBytes, "16 output rows fit one ring slot");
};

// A block's run of units inside one tile: groups [g_first, g_end) of tile
// `tile`, whose rows start at m0 and columns at n0.
struct Segment {
  long long tile;
  int g_first, g_end, m0, n0;
};

__device__ __forceinline__ Segment segment_at(const Sched& s, long long u, long long hi,
                                              int tile_rows, int tile_cols) {
  Segment g;
  g.tile = u / s.groups;
  g.g_first = static_cast<int>(u % s.groups);
  g.g_end = hi - u < s.groups - g.g_first ? g.g_first + static_cast<int>(hi - u) : s.groups;
  g.m0 = static_cast<int>(g.tile / s.tiles_n) * tile_rows;
  g.n0 = static_cast<int>(g.tile % s.tiles_n) * tile_cols;
  return g;
}

template <typename XT, int MT>
__global__ void __launch_bounds__(kDThreads, KGCT_INT4_DECODE_MIN_BLOCKS)
int4_decode_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   float* __restrict__ wsp, int* __restrict__ counters, int T, int K, int N,
                   int gs, Sched sch, int vec) {
  using D = Decode<XT, MT>;
  using S = typename D::S;
  constexpr int kSplit = XSplit<XT>::k;
  constexpr int kORow = kDBN + 4;
  extern __shared__ __align__(16) unsigned char smem[];
  // The finished tile leaves through the ring's last slot, which the next
  // segment's first stages (already in flight by then) do not use.
  float* ot = reinterpret_cast<float*>(smem + (kDStages - 1) * S::kBytes);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wn = warp * 32;  // the warp's first column in the tile
  const long long hi = unit_lo(sch, blockIdx.x + 1);
  auto load = [&](const Segment& sg, int st) {
    load_stage<XT, D::BM, kDBN, kDWRow, kDKC, kDThreads>(
        smem + (st % kDStages) * S::kBytes, x, w, scale, T, K, N, gs, sg.m0, sg.n0,
        sg.g_first * gs + st * kDKC, sg.g_end * gs, vec);
  };
  auto prologue = [&](const Segment& sg) {
    const int n_stages = ((sg.g_end - sg.g_first) * gs + kDKC - 1) / kDKC;
    for (int st = 0; st < kDStages - 1; ++st) {
      if (st < n_stages) load(sg, st);
      mma::cp_async_commit();
    }
  };

  long long u = unit_lo(sch, blockIdx.x);
  Segment sg = segment_at(sch, u, hi, D::BM, kDBN);
  u += sg.g_end - sg.g_first;
  prologue(sg);
  while (true) {
    const int kbeg = sg.g_first * gs, kend = sg.g_end * gs;
    const int n_stages = (kend - kbeg + kDKC - 1) / kDKC;

    float acc[MT][4][4];
    float part[MT][4][4];
    float sc[8];  // the current group's scales: column wn + 8 tig + j
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[mt][nt][j] = part[mt][nt][j] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.f;

    int grem = gs;        // rows left in the current group (segments start on one)
    int g = sg.g_first;   // the current group
    for (int i = 0; i < n_stages; ++i) {
      mma::cp_async_wait<kDStages - 2>();
      __syncthreads();  // stage i is in; every warp is done with stage i - 1
      if (i + kDStages - 1 < n_stages) load(sg, i + kDStages - 1);
      mma::cp_async_commit();

      const unsigned char* ws = smem + (i % kDStages) * S::kBytes;
      const float* ss = reinterpret_cast<const float*>(ws + S::kWBytes);
      const unsigned char* xs = ws + S::kWBytes + S::kSBytes;
      const int k0 = kbeg + i * kDKC;
      const int g_stage = k0 / gs;
      const int rows = min(kDKC, kend - k0);  // a multiple of 16
      // Packed rows kk/2 + tig and + 4 (input rows 2 tig, 2 tig + 1 and
      // + 8), four neighbouring columns: byte t feeds mma tile t. Loaded one
      // step ahead of their use.
      const unsigned char* wq = ws + tig * kDWRow + wn + 4 * gid;
      uint32_t w0 = *reinterpret_cast<const uint32_t*>(wq);
      uint32_t w1 = *reinterpret_cast<const uint32_t*>(wq + 4 * kDWRow);
#pragma unroll
      for (int kk = 0; kk < kDKC; kk += 16) {
        if (kk < rows) {
          uint32_t b[4][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            b[nt][0] = nibbles_bf16x2((w0 >> (8 * nt)) & 0xFFu);
            b[nt][1] = nibbles_bf16x2((w1 >> (8 * nt)) & 0xFFu);
          }
          if (kk + 16 < kDKC) {
            w0 = *reinterpret_cast<const uint32_t*>(wq + (kk / 2 + 8) * kDWRow);
            w1 = *reinterpret_cast<const uint32_t*>(wq + (kk / 2 + 12) * kDWRow);
          }
          if (grem == gs) {  // a group starts: its scales, fresh partials
            // Accumulators j & 1 of mma tile nt sit in columns wn + 8 tig + nt (+ 4).
            const float* srow = ss + (g - g_stage) * kDBN + wn + 8 * tig;
#pragma unroll
            for (int j = 0; j < 8; ++j) sc[j] = srow[j];
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.f;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[kSplit][4];
            load_a<S::kXRow>(a, xs, mt * 16, kk, static_cast<const XT*>(nullptr));
#pragma unroll
            for (int sp = 0; sp < kSplit; ++sp)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma::mma_bf16(part[mt][nt], a[sp], b[nt][0], b[nt][1]);
          }
          grem -= 16;
          if (grem == 0) {  // the group ends: fold its partials
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  acc[mt][nt][j] =
                      fmaf(part[mt][nt][j], sc[nt + 4 * (j & 1)], acc[mt][nt][j]);
            grem = gs;
            ++g;
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the ring
    const Segment done = sg;
    const bool more = u < hi;
    if (more) {  // the next segment's first stages fly while this one is stored
      sg = segment_at(sch, u, hi, D::BM, kDBN);
      u += sg.g_end - sg.g_first;
      prologue(sg);
    }
    // Accumulator j of mma tile nt: tile row mt 16 + gid (+8 for j >= 2),
    // tile column wn + 4 (2 tig + (j & 1)) + nt; ot holds the 16 rows of one
    // mma row tile at a time.
    finish_segment<D::BM, kDBN, kDThreads, 16>(
        sch, done.tile, done.m0, done.n0, ot,
        [&](int r0) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            if (mt * 16 == r0)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  ot[(gid + (j >= 2 ? 8 : 0)) * kORow + wn + 4 * (2 * tig + (j & 1)) + nt] =
                      acc[mt][nt][j];
        },
        out, wsp, counters, T, N);
    if (!more) break;
  }
}

// ---- prefill tile (bf16 x): warpgroup products ------------------------------

// Four warpgroups: warpgroups 0 and 1 produce (copy and decode stages),
// warpgroups 2 and 3 consume (wgmma on 64 output rows each, fold, store).
// Registers move from the producers to the consumers (setmaxnreg).
constexpr int kPThreads = 512;
constexpr int kPProducer = 256;       // threads of the producer warpgroups
// 96 + 160 per thread pair fill the 64K register file; fewer producer
// registers spill its decode, fewer consumer registers spill the two
// 64-float accumulators.
constexpr int kPProducerRegs = 96;
constexpr int kPConsumerRegs = (65536 / 128 - 2 * kPProducerRegs) / 2 / 8 * 8;  // 160
constexpr int kPBM = 128;
constexpr int kPBN = 128;
constexpr int kPKC = 64;              // K rows per stage
constexpr int kPStages = KGCT_INT4_PREFILL_STAGES;
// Packed rows: 128 bytes each, 16-byte chunk c of row p stored at chunk
// c ^ (p % 8) (the tensor-memory copy's 128-byte swizzle), so the eight
// rows a store phase of the decode reads fall on different banks.
constexpr int kPWRow = kPBN;
// x and the decoded weight sit in wgmma's K-major layout with the 128-byte
// swizzle: a [rows, 64] bf16 tile has one 128-byte line per row, lines in
// 1024-byte atoms of 8 rows, and the 16-byte chunk c of row r stored at
// chunk c ^ (r % 8) of its line, so the eight rows of any chunk column fall
// on different banks.
constexpr int kAtom = 1024;  // bytes per 8 rows
static_assert(kPKC * 2 == 128, "one 128-byte swizzle line per row");
__device__ __forceinline__ int swz(int r, int k) {  // byte offset of element (r, k)
  return (r / 8) * kAtom + (r % 8) * 128 + (((k / 8) ^ (r % 8)) * 16) + (k % 8) * 2;
}
// Named barriers (0 is __syncthreads): stage slot s full, for consumer
// warpgroup c (the producer arrives, the consumers wait), slot s empty (the
// reverse), and the producer's own.
// Each consumer warpgroup has its own full barriers, so the two drift apart
// and one folds while the other's products run.
constexpr int kBarFull = 1, kBarEmpty = kBarFull + 2 * kPStages,
              kBarProducer = kBarEmpty + kPStages;
static_assert(kBarProducer < 16, "named barriers");
constexpr int kWGPair = kPProducer + 128;  // the producer and one consumer warpgroup
// Stages the producer's copies run ahead of its decoding; the ring keeps one
// more slot for the consumers.
constexpr int kPLead = kPStages - 2;
static_assert(kPLead >= 1, "prefill ring depth");

// One slot of the stage ring: packed rows, the scale rows of the groups the
// stage touches (at most kPKC/16 + 1, padded to an atom), x, decoded B.
// After the ring: the consumers' staging rows and one mbarrier per slot.
struct PStage {
  static constexpr int kWBytes = (kPKC / 2) * kPWRow;
  static constexpr int kSBytes = ((kWBytes + (kPKC / 16 + 1) * kPBN * 4 + kAtom - 1) / kAtom) *
                                     kAtom - kWBytes;
  static constexpr int kXOff = kWBytes + kSBytes;
  static constexpr int kBOff = kXOff + kPBM / 8 * kAtom;
  static constexpr int kBytes = kBOff + kPBN / 8 * kAtom;
  // Each consumer warp stages 4 output rows at a time.
  static constexpr int kORow = kPBN + 4;
  static constexpr int kOBytes = 4 * kORow * 4;
  static constexpr int kMbarOff = kPStages * kBytes + (kPThreads - kPProducer) / 32 * kOBytes;
  // + kAtom: the kernel aligns its base to an atom.
  static constexpr size_t kSmem = static_cast<size_t>(kMbarOff) + 8 * kPStages + kAtom;
  static constexpr int kXBytes = kBOff - kXOff;
  static_assert(kXOff % kAtom == 0 && kBytes % kAtom == 0, "atoms stay aligned");
};

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The scale rows g0 .. g0 + s_rows - 1 of columns [n0, n0 + kPBN), by
// producer thread t, as 16-byte copies (N % 16 == 0); zeros past N.
__device__ __forceinline__ void prefill_load_scales(float* ss, int t, const float* scale, int N,
                                                    int n0, int g0, int s_rows) {
  for (int c = t; c < s_rows * (kPBN / 4); c += kPProducer) {
    const int r = c / (kPBN / 4), j = (c % (kPBN / 4)) * 4;
    const bool ok = n0 + j < N;
    mma::cp_async16(ss + r * kPBN + j,
                    ok ? scale + static_cast<long long>(g0 + r) * N + n0 + j : scale, ok);
  }
}

// mbarriers and the tensor-memory copy (TMA): one thread arms the slot's
// barrier with the bytes to come and starts the copies; every waiting
// thread then watches the barrier's phase.
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma::smem_addr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   mma::smem_addr(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma::smem_addr(b)), "r"(parity)
        : "memory");
}
// The box of `map` at element coordinates (c0 innermost, c1) into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(mma::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(mma::smem_addr(b))
      : "memory");
}

// Stage, by producer thread t, for K rows [k0, min(k0 + kPKC, kend)) and
// columns [n0, n0 + kPBN): the packed rows, the scale rows of the groups
// those rows touch, and the x tile rows [m0, m0 + kPBM) in the swizzled
// layout; zeros outside the tensors.
__device__ __forceinline__ void prefill_load(unsigned char* st, int t, const __nv_bfloat16* x,
                                             const int8_t* w, const float* scale, int T, int K,
                                             int N, int gs, int m0, int n0, int k0, int kend,
                                             bool vec) {
  unsigned char* ws = st;
  float* ss = reinterpret_cast<float*>(st + PStage::kWBytes);
  unsigned char* xs = st + PStage::kXOff;
  const int pr0 = k0 / 2, prend = kend / 2, g0 = k0 / gs;
  const int s_rows = (min(k0 + kPKC, kend) - 1) / gs - g0 + 1;
  if (vec) {
#pragma unroll
    for (int i = 0; i < (kPKC / 2) * (kPBN / 16) / kPProducer; ++i) {
      const int c = t + i * kPProducer, r = c / (kPBN / 16), j = (c % (kPBN / 16)) * 16;
      const bool ok = pr0 + r < prend && n0 + j < N;
      mma::cp_async16(ws + r * kPWRow + (((j / 16) ^ (r % 8)) * 16),
                      ok ? w + static_cast<long long>(pr0 + r) * N + n0 + j : w, ok);
    }
    prefill_load_scales(ss, t, scale, N, n0, g0, s_rows);
    // Chunk (8 k) kc = (t / 8) % 8 of rows t % 8 + 8 (t / 64 + 2 i): eight
    // neighbouring threads fill eight rows of one atom.
    const int kc = (t / 8) % 8, kk = k0 + 8 * kc;
#pragma unroll
    for (int i = 0; i < kPBM * (kPKC / 8) / kPProducer; ++i) {
      const int r = t % 8 + 8 * (t / 64 + (kPProducer / 64) * i);
      const bool ok = m0 + r < T && kk < kend;
      mma::cp_async16(xs + swz(r, 8 * kc), ok ? x + static_cast<long long>(m0 + r) * K + kk : x,
                      ok);
    }
  } else {
    for (int e = t; e < (kPKC / 2) * kPBN; e += kPProducer) {
      const int r = e / kPBN, j = e % kPBN;
      const bool ok = pr0 + r < prend && n0 + j < N;
      ws[r * kPWRow + (((j / 16) ^ (r % 8)) * 16) + j % 16] =
          ok ? static_cast<unsigned char>(w[static_cast<long long>(pr0 + r) * N + n0 + j]) : 0;
    }
    for (int e = t; e < s_rows * kPBN; e += kPProducer) {
      const int r = e / kPBN, j = e % kPBN;
      ss[r * kPBN + j] = n0 + j < N ? scale[static_cast<long long>(g0 + r) * N + n0 + j] : 0.f;
    }
    for (int e = t; e < kPBM * kPKC; e += kPProducer) {
      const int r = e / kPKC, k = e % kPKC;
      const bool ok = m0 + r < T && k0 + k < kend;
      *reinterpret_cast<__nv_bfloat16*>(xs + swz(r, k)) =
          ok ? x[static_cast<long long>(m0 + r) * K + k0 + k] : zero<__nv_bfloat16>();
    }
  }
}

// The decoded B tile is stored MN-major (rows k, n contiguous) with the
// 128-byte swizzle: column block b = n / 64 of kPKC lines of 128 bytes,
// lines in 1024-byte atoms of 8 k, chunk c of line k at chunk c ^ (k % 8).
constexpr int kBBlock = kPKC / 8 * kAtom;  // bytes per 64-column block
__device__ __forceinline__ int swz_b(int k, int n) {  // byte offset of element (k, n)
  return (n / 64) * kBBlock + (k / 8) * kAtom + (k % 8) * 128 +
         ((((n % 64) / 8) ^ (k % 8)) * 16) + (n % 8) * 2;
}

// Two nibbles (bits 0-3 of bytes 0 and 1 of v, the rest of v zero) -> bf16
// {first, second}, exactly: each nibble n goes into the mantissa of 128.0 as
// n ^ 8, and subtracting 136 leaves the signed value.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t v, uint32_t sel) {
  const uint32_t t = __byte_perm(v, 0u, sel) ^ 0x43084308u;
  return as_u32(__hsub2(as_bf162(t), as_bf162(0x43084308u)));
}

// The packed rows of a slot -> its decoded B tile, bf16 exact integers:
// packed row p holds input rows k = 2p (low nibbles) and 2p + 1 (high
// nibbles), which become two B rows of neighbouring columns. Producer
// thread t takes packed row p = t % 8 + 8 ((t / 8) % 4) at 16 columns
// 16 (t / 32) + 64 i: one 16-byte read, four 16-byte stores, and the eight
// threads of a store phase write eight rows, so no bank is hit twice.
__device__ __forceinline__ void prefill_decode(unsigned char* st, int t) {
  const int p = t % 8 + 8 * ((t / 8) % 4);
  unsigned char* bt = st + PStage::kBOff;
  static_assert((kPKC / 2) * (kPBN / 16) == kPProducer, "one 16-byte piece per thread");
  {
    const int j = 16 * (t / 32);
    const uint4 q =
        *reinterpret_cast<const uint4*>(st + p * kPWRow + (((j / 16) ^ (p % 8)) * 16));
    const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // columns j + 4c .. j + 4c + 3
      const uint32_t l = wd[c] & 0x0F0F0F0Fu, h = (wd[c] >> 4) & 0x0F0F0F0Fu;
      lo[2 * c] = nibble_pair(l, 0x5140u);      // bytes 0, 1
      lo[2 * c + 1] = nibble_pair(l, 0x5342u);  // bytes 2, 3
      hi[2 * c] = nibble_pair(h, 0x5140u);
      hi[2 * c + 1] = nibble_pair(h, 0x5342u);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<uint4*>(bt + swz_b(2 * p, j + 8 * c)) =
          make_uint4(lo[4 * c], lo[4 * c + 1], lo[4 * c + 2], lo[4 * c + 3]);
      *reinterpret_cast<uint4*>(bt + swz_b(2 * p + 1, j + 8 * c)) =
          make_uint4(hi[4 * c], hi[4 * c + 1], hi[4 * c + 2], hi[4 * c + 3]);
    }
  }
}

// wgmma's shared-memory matrix descriptors for the 128-byte swizzle
// (layout type 1). A (x, K-major): start address, 8-row atoms kAtom bytes
// apart (the leading offset is unused by this layout); the k step s starts
// 32 s bytes into the line. B (decoded weight, MN-major): start address,
// 64-column blocks kBBlock apart (leading), atoms of 8 k kAtom apart
// (stride); the k step s starts at atom 2 s. The swizzle applies to the
// address.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, int lead, int stride) {
  const uint64_t a = mma::smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lead >> 4) << 16) |
         (static_cast<uint64_t>(stride >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_a(const void* p) { return wgmma_desc(p, 16, kAtom); }
__device__ __forceinline__ uint64_t desc_b(const void* p) {
  return wgmma_desc(p, kBBlock, kAtom);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared-memory writes of this thread (st.shared, completed cp.async) are
// ordered before later reads by wgmma (the async proxy) once a barrier
// follows.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of d between a wgmma and its wait.
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, shared, k-major) * B (16 x 128, shared, n-major), fp32; with
// accumulate == 0 the product replaces d. Register i of d holds row
// 16 (warp % 4) + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2.
__device__ __forceinline__ void wgmma_64x128(float (&d)[64], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// acc += part * scale of each column, the scales of group row `srow` (a
// row of the slot's scale rows).
__device__ __forceinline__ void fold(float (&acc)[64], const float (&part)[64],
                                     const float* srow) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float2 sc = *reinterpret_cast<const float2*>(srow + 8 * j + 2 * tig);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = fmaf(part[4 * j + e], e % 2 ? sc.y : sc.x, acc[4 * j + e]);
  }
}

// Block b computes whole output tiles b, b + P, b + 2P, ... (P = the grid),
// tile t at row tile t % tiles_m and column tile t / tiles_m: the blocks in
// flight share a few column tiles of the weight and every row tile of x,
// which stay in L2. Each tile is stored directly; no partials. The
// producer runs up to kPStages stages ahead of the consumers, across tiles.
// kWhole (gs a multiple of kPKC): every stage lies inside one group, so the
// products run with no branch around them, which keeps wgmma
// asynchronous; otherwise groups may end inside a stage.
// tma (vec, aligned operands): x and the packed rows arrive by TMA on the
// slot's mbarrier, the scale rows by cp.async; else every copy is cp.async
// (or plain loads without vec).
template <bool kWhole>
__global__ void __launch_bounds__(kPThreads, 1)
int4_prefill_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out, int T, int K,
                    int N, int gs, int tiles_n, int vec, int tma,
                    const __grid_constant__ CUtensorMap tmx,
                    const __grid_constant__ CUtensorMap tmw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // The swizzle pattern follows address bits 4-9: atoms start 1024-aligned.
  unsigned char* smem = smem_raw + ((kAtom - (mma::smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  const int tiles_m = (T + kPBM - 1) / kPBM;
  const long long tiles = static_cast<long long>(tiles_m) * tiles_n;
  const int n_stages = (K + kPKC - 1) / kPKC;
  constexpr int kAll = kPThreads;
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + PStage::kMbarOff);
  if (threadIdx.x == 0 && tma) {
    for (int s = 0; s < kPStages; ++s) mbar_init(mbar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers are set up before anyone uses them

  if (threadIdx.x < kPProducer) {  // ---- producers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kPProducerRegs));
    const int t = threadIdx.x;
    long long j = 0;  // stages produced so far by this block
    auto publish = [&](long long jj) {  // stage jj's copies are in: decode, hand over
      if (tma) mbar_wait(mbar + jj % kPStages, static_cast<int>((jj / kPStages) & 1));
      bar_sync(kBarProducer, kPProducer);
      prefill_decode(smem + (jj % kPStages) * PStage::kBytes, t);
      fence_async_smem();
      const int full = kBarFull + 2 * static_cast<int>(jj % kPStages);
      bar_arrive(full, kWGPair);
      bar_arrive(full + 1, kWGPair);
    };
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = static_cast<int>(tile % tiles_m) * kPBM;
      const int n0 = static_cast<int>(tile / tiles_m) * kPBN;
      for (int i = 0; i < n_stages; ++i, ++j) {
        const int slot = static_cast<int>(j % kPStages);
        if (j >= kPStages) bar_sync(kBarEmpty + slot, kAll);  // consumers are done with it
        unsigned char* st = smem + slot * PStage::kBytes;
        if (tma) {
          if (t == 0) {
            mbar_expect_tx(mbar + slot, PStage::kXBytes + PStage::kWBytes);
            tma_load_2d(st + PStage::kXOff, &tmx, i * kPKC, m0, mbar + slot);
            tma_load_2d(st, &tmw, n0, i * kPKC / 2, mbar + slot);
          }
          const int k0 = i * kPKC, g0 = k0 / gs;
          prefill_load_scales(reinterpret_cast<float*>(st + PStage::kWBytes), t, scale, N, n0,
                              g0, (min(k0 + kPKC, K) - 1) / gs - g0 + 1);
        } else {
          prefill_load(st, t, x, w, scale, T, K, N, gs, m0, n0, i * kPKC, K, vec);
        }
        mma::cp_async_commit();
        if (j >= kPLead) {  // the copies of stage j - kPLead are in
          mma::cp_async_wait<kPLead>();
          publish(j - kPLead);
        }
      }
    }
    mma::cp_async_wait<0>();
    for (long long jj = j > kPLead ? j - kPLead : 0; jj < j; ++jj) publish(jj);
    return;
  }

  // ---- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kPConsumerRegs));
  const int ct = threadIdx.x - kPProducer;        // 0 .. 255
  const int cw = ct / 32, lane = ct % 32, gid = lane / 4, tig = lane % 4;
  const int wg = cw / 4;                          // tile rows 64 wg ..
  const int wrow = 64 * wg + 16 * (cw % 4);       // the warp's first tile row
  float* ot = reinterpret_cast<float*>(smem + kPStages * PStage::kBytes + cw * PStage::kOBytes);
  long long j = 0;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = static_cast<int>(tile % tiles_m) * kPBM;
    const int n0 = static_cast<int>(tile / tiles_m) * kPBN;
    float acc[64];
    float part[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
    int grem = gs;  // rows left in the current group
    int g = 0;      // the current group
    for (int i = 0; i < n_stages; ++i, ++j) {
      const int slot = static_cast<int>(j % kPStages);
      const unsigned char* st = smem + slot * PStage::kBytes;
      const float* ss = reinterpret_cast<const float*>(st + PStage::kWBytes);
      const unsigned char* xs = st + PStage::kXOff + 8 * wg * kAtom;
      const unsigned char* bs = st + PStage::kBOff;
      const int k0 = i * kPKC;
      const int g_stage = k0 / gs;
      bar_sync(kBarFull + 2 * slot + wg, kWGPair);
      if (tma) mbar_wait(mbar + slot, static_cast<int>((j / kPStages) & 1));  // x by TMA
      fence_operands(part);
      wgmma_fence();
      if constexpr (kWhole) {
        // The served case: K and gs are multiples of kPKC. The products
        // go back to back (the first replaces part when the group
        // starts here), one wait, the fold at the group's end.
        const bool start = grem == gs;
#pragma unroll
        for (int s = 0; s < kPKC / 16; ++s)
          wgmma_64x128(part, desc_a(xs + 32 * s), desc_b(bs + 2 * s * kAtom), s > 0 || !start);
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(part);
        grem -= kPKC;
        if (grem == 0) {
          fold(acc, part, ss + (g - g_stage) * kPBN);
          grem = gs;
          ++g;
        }
      } else {
        const int rows = min(kPKC, K - k0);  // a multiple of 16
#pragma unroll
        for (int s = 0; s < kPKC / 16; ++s) {
          if (16 * s < rows) {
            wgmma_64x128(part, desc_a(xs + 32 * s), desc_b(bs + 2 * s * kAtom), grem != gs);
            grem -= 16;
            if (grem == 0 || 16 * (s + 1) >= rows) {  // a group or the stage ends
              wgmma_commit();
              wgmma_wait_all();
              fence_operands(part);
              if (grem == 0) {
                fold(acc, part, ss + (g - g_stage) * kPBN);
                grem = gs;
                ++g;
              }
              fence_operands(part);
              wgmma_fence();
            }
          }
        }
      }
      fence_operands(part);
      bar_arrive(kBarEmpty + slot, kAll);
    }
    // Each warp stores its 16 rows, 4 at a time through its own ot: register
    // j of acc is tile row wrow + gid + 8 ((j / 2) % 2), column
    // 8 (j / 4) + 2 tig + j % 2.
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // rows 4 q .. 4 q + 3 of the warp's 16
      const int h = q / 2;
      if (gid / 4 == q % 2)
#pragma unroll
        for (int jj = 0; jj < 16; ++jj)
          *reinterpret_cast<float2*>(ot + (gid % 4) * PStage::kORow + 8 * jj + 2 * tig) =
              make_float2(acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
      __syncwarp();
#pragma unroll
      for (int e = lane; e < 4 * (kPBN / 4); e += 32) {
        const int r = e / (kPBN / 4), c = (e % (kPBN / 4)) * 4;
        const int row = m0 + wrow + 4 * q + r;
        if (row < T && n0 + c < N)
          store4(out, row, n0 + c, N, *reinterpret_cast<const float4*>(ot + r * PStage::kORow + c));
      }
      __syncwarp();
    }
  }
}

// ---- launch ---------------------------------------------------------------

// x as the kernel's first parameter type (bf16 or fp32).
template <typename XT, typename... Rest>
const XT* x_arg(void (*)(const XT*, Rest...), const void* p) {
  return static_cast<const XT*>(p);
}

template <typename Kernel>
cudaError_t allow(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Run `f(kernel, threads, smem)` on the decode kernel instance of (x_dtype,
// mt), its shared-memory cap raised once per process.
template <typename F>
cudaError_t with_decode_kernel(int x_dtype, int mt, F f) {
#define KGCT_INT4_CASE(KERNEL, THREADS, SMEM)                 \
  {                                                           \
    static const cudaError_t attr = allow(KERNEL, SMEM);      \
    if (attr != cudaSuccess) return attr;                     \
    return f(KERNEL, THREADS, SMEM);                          \
  }
  if (x_dtype == 1) {
    if (mt == 1) KGCT_INT4_CASE((int4_decode_kernel<__nv_bfloat16, 1>), kDThreads,
                                (Decode<__nv_bfloat16, 1>::kSmem))
    if (mt == 2) KGCT_INT4_CASE((int4_decode_kernel<__nv_bfloat16, 2>), kDThreads,
                                (Decode<__nv_bfloat16, 2>::kSmem))
    if (mt == 4) KGCT_INT4_CASE((int4_decode_kernel<__nv_bfloat16, 4>), kDThreads,
                                (Decode<__nv_bfloat16, 4>::kSmem))
  } else if (x_dtype == 0) {
    if (mt == 1) KGCT_INT4_CASE((int4_decode_kernel<float, 1>), kDThreads,
                                (Decode<float, 1>::kSmem))
    if (mt == 2) KGCT_INT4_CASE((int4_decode_kernel<float, 2>), kDThreads,
                                (Decode<float, 2>::kSmem))
    if (mt == 4) KGCT_INT4_CASE((int4_decode_kernel<float, 4>), kDThreads,
                                (Decode<float, 4>::kSmem))
  }
#undef KGCT_INT4_CASE
  return cudaErrorInvalidValue;
}

using PrefillKernel = void (*)(const __nv_bfloat16*, const int8_t*, const float*, float*, int,
                               int, int, int, int, int, int, const CUtensorMap,
                               const CUtensorMap);

// The prefill kernel instance (whole: gs a multiple of the stage), its
// shared-memory cap raised once per process; null if that failed.
PrefillKernel prefill_kernel(bool whole) {
  static const bool ok = allow(int4_prefill_kernel<true>, PStage::kSmem) == cudaSuccess &&
                         allow(int4_prefill_kernel<false>, PStage::kSmem) == cudaSuccess;
  if (!ok) return nullptr;
  return whole ? int4_prefill_kernel<true> : int4_prefill_kernel<false>;
}

// A 2-D tensor map for TMA: inner dimension d0 elements (stride 1), d1 rows
// `stride` bytes apart, a box of b0 x b1 elements, the 128-byte swizzle,
// zeros outside the tensor.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t d0,
                uint64_t d1, uint64_t stride, uint32_t b0, uint32_t b1) {
  static const PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {stride};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
}  // namespace kgct

// Blocks of the (x_dtype, kind, mt) kernel one SM keeps resident (the
// occupancy API, at the kernel's shared memory); a negative CUDA status on
// error. kind: 0 = decode tile (mt 1, 2 or 4 m16 row tiles), 1 = prefill tile.
extern "C" int kgct_int4_matmul_resident(int x_dtype, int kind, int mt) {
  using namespace kgct;
  int n = 0;
  cudaError_t err;
  if (kind == 1) {
    const PrefillKernel k = x_dtype == 1 ? prefill_kernel(true) : nullptr;
    err = k == nullptr ? cudaErrorInvalidValue
                       : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kPThreads,
                                                                       PStage::kSmem);
  } else {
    err = with_decode_kernel(x_dtype, mt, [&](auto kernel, int threads, size_t smem) {
      return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    });
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Output columns per tile of the kind-0 (decode) or kind-1 (prefill) kernel.
extern "C" int kgct_int4_matmul_tile_cols(int kind) {
  return kind == 1 ? kgct::kPBN : kgct::kDBN;
}

// What every call of one (shapes, dtypes, device) key passes unchanged
// (ops/cuda/int4_matmul.py LaunchArgs).
struct Int4Launch {
  void* ws;        // at least 2 * blocks * tile_rows * tile_cols floats
  int* counters;   // at least one int per output tile, all 0, left all 0
  int T, K, N, gs;
  int x_dtype;     // 0 = float32, 1 = bfloat16
  int kind, mt;    // 0 = decode tile of mt m16 row tiles, 1 = prefill tile
  int blocks;      // the grid
};

// The wrapper has checked the shapes (K = 2 * rows of w_packed, K % gs ==
// 0, gs % 16 == 0) and planned the launch. vec when N % 16 == 0 and x,
// w_packed, scale are 16-byte aligned; out is 16-byte aligned. One launch
// (the prefill tile's tensor maps are encoded on the host first); returns
// its CUDA status.
extern "C" int kgct_int4_matmul(const void* x, const void* w_packed, const void* scale,
                                void* out, const Int4Launch* a, bool vec, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  const int T = a->T, K = a->K, N = a->N, gs = a->gs, kind = a->kind, blocks = a->blocks;
  if (T == 0 || N == 0) return cudaSuccess;
  if (K <= 0 || gs <= 0 || gs % 16 || K % gs || blocks < 1 || a->ws == nullptr ||
      a->counters == nullptr || (kind != 0 && kind != 1))
    return cudaErrorInvalidValue;
  const int rows = kind == 1 ? kPBM : 16 * a->mt;
  const int cols = kgct_int4_matmul_tile_cols(kind);
  const int tiles_n = (N + cols - 1) / cols;
  if (kind == 1) {
    const PrefillKernel kernel = a->x_dtype == 1 ? prefill_kernel(gs % kPKC == 0) : nullptr;
    if (kernel == nullptr) return cudaErrorInvalidValue;
    CUtensorMap tmx{}, tmw{};
    const bool tma =
        vec &&
        encode_map(&tmx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, T, 2ull * K, kPKC, kPBM) &&
        encode_map(&tmw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w_packed, N, K / 2, N, kPBN, kPKC / 2);
    kernel<<<blocks, kPThreads, PStage::kSmem, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w_packed),
        static_cast<const float*>(scale), static_cast<float*>(out), T, K, N, gs, tiles_n, vec,
        tma, tmx, tmw);
    return cudaGetLastError();
  }
  Sched sch;
  sch.groups = K / gs;
  sch.tiles_n = tiles_n;
  sch.units = static_cast<long long>(tiles_n) * ((T + rows - 1) / rows) * sch.groups;
  sch.blocks = blocks;
  if (blocks > sch.units) return cudaErrorInvalidValue;
  return with_decode_kernel(a->x_dtype, a->mt, [&](auto kernel, int threads, size_t smem) {
    kernel<<<blocks, threads, smem, s>>>(
        x_arg(kernel, x), static_cast<const int8_t*>(w_packed),
        static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(a->ws),
        a->counters, T, K, N, gs, sch, vec);
    return cudaGetLastError();
  });
}

extern "C" const char* kgct_int4_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
