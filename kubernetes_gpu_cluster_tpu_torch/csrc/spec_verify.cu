// Speculative-verification attention for Hopper (sm_90a): split-K over the
// paged history, every query of a row in one tensor-core tile.
//
// Replaces no TPU kernel. The JAX package computes this function in XLA
// (kubernetes_gpu_cluster_tpu/ops/attention.py::spec_verify_attention_xla);
// this is the card's version of the port's
// ops/attention.py::spec_verify_attention_plain. It exists because a
// captured verify program takes the whole [R, pps] page table (the JAX
// program's shape, keyed by the row bucket alone), and the plain version
// gathers that table's every page in fp32: 2 * pps * ps * n_kv * hd * 4
// bytes a row a layer, 64 MB for llama-3-8b at 512 columns, at every replay.
//
// What it computes: R rows of S = k + 1 query tokens ([last committed
// token, k drafts]). Every query of row b attends to the row's pooled
// history (positions 0 .. ctx[b] - 2, through its page table, the same for
// all S queries) and causally to the earlier tokens of its own slice, whose
// K/V arrive in-batch (the pool is written after the forward). A padding
// row (ctx 0) reads no page and sees only its slice. GQA, fp32 softmax.
// ctx lives on the device and is read there, so one captured launch serves
// every replay.
//
// Bound on the H100: bytes. A history token's K and V rows are read once
// for all S * g queries of their kv head: 4 * S * g * hd flops for 4 * hd
// bytes (bf16), S * g flops a byte, far below the ~295 where the tensor
// cores would become the limit. The kernel reads what paged_decode reads
// for one token a row, plus the slice.
//
// Design (bf16, the served dtype), paged_decode.cu's with more query rows.
// The grid is (splits, n_kv, R * groups). The M = S * g queries of a
// (row, kv head) are the rows of one to four 16-row mma.sync tiles; a block
// holds block_rows(M) = 16, 32 or 64 of them (groups blocks cover M > 64,
// each reading the history again). Its four warps share the work: with one
// tile every warp folds 16 keys of each 64-key stage into the tile's rows,
// with two tiles two warps per tile take 32 keys each, with four each warp
// takes its own tile and all 64 keys. K/V stages stream through a two-stage
// ring of 16-byte cp.async copies gathered through the page table, once
// per block for all its queries. The splits are chosen on the host from R,
// n_kv, groups, the SM count and the table's width, never from the
// contexts; each block cuts its row's ctx - 1 pooled tokens into at most
// gridDim.x splits of whole stages, at least min_split keys each, as
// paged_decode does, and exits when its split is past the last.
//
// The warps' states merge in shared memory into one (m, l, o[hd]) per query
// in fp32. The in-slice block (S x S, causal) is scored once per block from
// the in-batch K and folded in at the final merge, where paged_decode folds
// its current token: in the block itself when the row has one split, else
// by the last block of the (row, group, kv head) to arrive (one
// release-acquire atomic on a counter it resets), which merges the partials
// in split order, so every call gives the same bits. The wrapper allocates
// the workspace and counters; the kernel allocates nothing and never
// synchronizes with the host, so a call can be captured in a CUDA graph.
//
// fp32 inputs (the tests and debug models) keep the CUDA-core tile of
// flash_tile.cuh: one block per (row, kv head, group of up to 64 queries)
// over 32-key tiles of the history, then one tile of the slice.

#include "flash_mma.cuh"
#include "flash_tile.cuh"

namespace kgct {
namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 16;                    // rows of one mma tile
constexpr int kMaxRows = kWarps * kTileRows;     // queries a block holds, at most
constexpr int kSK = 64;                          // keys per stage
constexpr int kStages = 2;
constexpr int kMaxS = 16;                        // most queries per row

// Queries a block holds for M queries per (row, kv head): the fewest tiles
// that hold them, up to four. The wrapper mirrors it (ops/cuda/spec_verify.py).
__host__ __device__ inline int block_rows(int M) { return M <= 16 ? 16 : M <= 32 ? 32 : 64; }

__device__ __forceinline__ float bf(const __nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
struct VerifySmem {
  static constexpr int RS = 2 * HD + 16;
  static constexpr int kTile = kSK * RS;  // one K or V stage
  static constexpr size_t kRing = 2ull * kStages * kTile;
  // Once the ring has drained it holds the warps' states (o [warps][16][HD],
  // m and l [warps][16]) and the in-slice scores [64][kMaxS].
  static constexpr size_t kMerge =
      sizeof(float) * (kWarps * kTileRows * HD + 2 * kWarps * kTileRows + kMaxRows * kMaxS);
  static constexpr size_t kBytes = kMaxRows * RS + (kRing > kMerge ? kRing : kMerge);
};

// (m, l, o) <- the softmax merge of (m, l, o) and (m2, l2, o2); m is finite,
// m2 may be -inf (nothing attended). m in the log2 domain.
__device__ __forceinline__ void merge(float& m, float& l, float& o, float m2, float l2,
                                      float o2) {
  const float mn = fmaxf(m, m2);
  const float a = exp2f(m - mn), c = exp2f(m2 - mn);
  l = l * a + l2 * c;
  o = o * a + o2 * c;
  m = mn;
}

// KS: warps that share one tile's keys (4 / tiles of the block).
template <int HD, int KS>
__global__ void __launch_bounds__(kThreads, 2)
spec_verify_split_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kpool,
                         const __nv_bfloat16* __restrict__ vpool,
                         const int* __restrict__ tables, const int* __restrict__ ctx,
                         const __nv_bfloat16* __restrict__ knew,
                         const __nv_bfloat16* __restrict__ vnew,
                         __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ counters, int nh, int n_kv, int S, int groups,
                         int ps_shift, int pps, int min_split, float scale_log2) {
  using Sm = VerifySmem<HD>;
  constexpr int RS = Sm::RS;
  constexpr int kChunks = HD / 8;        // 16-byte chunks per row
  constexpr int kTiles = kWarps / KS;    // mma tiles of the block
  constexpr int kRows = kTiles * kTileRows;
  constexpr int kWK = kSK / KS;          // keys per warp per stage
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  unsigned char* qs = smem;
  unsigned char* ring = smem + kMaxRows * RS;  // stage s: K at 2s, V at 2s + 1
  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / groups, grp = blockIdx.z % groups;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int g = nh / n_kv, ps = 1 << ps_shift;
  // Query r of the block is query row0 + r of the (row, kv head): slice
  // token (row0 + r) / g, head h * g + (row0 + r) % g.
  const int row0 = grp * kRows;
  const int rows = min(kRows, S * g - row0);
  const long long tok0 = static_cast<long long>(b) * S;  // the row's first token
  const int n_tok = min(max(ctx[b] - 1, 0), pps * ps);
  const int per = ((n_tok + gridDim.x - 1) / gridDim.x + kSK - 1) / kSK * kSK;
  const int split_tokens = max(min_split, per);
  const int n_split = n_tok == 0 ? 1 : (n_tok + split_tokens - 1) / split_tokens;
  if (split >= n_split) return;
  const int t_lo = split * split_tokens, t_hi = min(t_lo + split_tokens, n_tok);
  const int n_tiles = (t_hi - t_lo + kSK - 1) / kSK;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int* table = tables + static_cast<long long>(b) * pps;

  auto q_row = [&](int r) -> long long {  // element offset of query r's row
    const int x = row0 + r;
    return ((tok0 + x / g) * nh + h * g + x % g) * HD;
  };
  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    mma::cp_async16(qs + r * RS + ch * 16, r < rows ? q + q_row(r) + ch * 8 : q, r < rows);
  }
  auto load_kv = [&](int stage, int it) {
    unsigned char* ks = ring + (2 * stage) * Sm::kTile;
    unsigned char* vs = ks + Sm::kTile;
    for (int c = tid; c < kSK * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks, t = t_lo + it * kSK + r;
      const bool ok = t < t_hi;
      long long o = 0;
      if (ok)
        o = ((static_cast<long long>(__ldg(table + (t >> ps_shift))) << ps_shift) +
             (t & (ps - 1))) * kd + h * HD + ch * 8;
      mma::cp_async16(ks + r * RS + ch * 16, kpool + o, ok);
      mma::cp_async16(vs + r * RS + ch * 16, vpool + o, ok);
    }
  };

  const int tile = warp / KS, part = warp % KS;
  const bool active = tile * kTileRows < rows;
  mma::AttnWarp<HD, kWK> w;
  w.init();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    mma::cp_async_commit();  // group 0 also holds Q
  }
  for (int it = 0; it < n_tiles; ++it) {
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1
    if (it + kStages - 1 < n_tiles) load_kv((it + kStages - 1) % kStages, it + kStages - 1);
    mma::cp_async_commit();
    if (it == 0) w.load_q(qs + tile * kTileRows * RS);
    const int k0 = t_lo + it * kSK + part * kWK;
    if (active && k0 < t_hi) {
      const unsigned char* ks = ring + (2 * (it % kStages)) * Sm::kTile + part * kWK * RS;
      const unsigned char* vs = ks + Sm::kTile;
      if (k0 + kWK <= t_hi)
        w.template attend<false>(ks, vs, scale_log2, [](bool, int) { return true; });
      else
        w.template attend<true>(ks, vs, scale_log2,
                                [&](bool, int c) { return k0 + c < t_hi; });
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // the ring is free; Q is in even when there was no tile

  // The warps' states into shared memory.
  float* wo = reinterpret_cast<float*>(ring);  // [warps][16][HD]
  float* wm = wo + kWarps * kTileRows * HD;    // [warps][16]
  float* wl = wm + kWarps * kTileRows;         // [warps][16]
  float* sc = wl + kWarps * kTileRows;         // [kMaxRows][kMaxS]
  {
    float l0 = w.l[0], l1 = w.l[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (tig == 0) {
      wm[warp * kTileRows + gid] = w.m[0];
      wm[warp * kTileRows + gid + 8] = w.m[1];
      wl[warp * kTileRows + gid] = l0;
      wl[warp * kTileRows + gid + 8] = l1;
    }
    float* o_lo = wo + (warp * kTileRows + gid) * HD;
    float* o_hi = o_lo + 8 * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(o_lo + c) = make_float2(w.o[n][0], w.o[n][1]);
      *reinterpret_cast<float2*>(o_hi + c) = make_float2(w.o[n][2], w.o[n][3]);
    }
  }
  // The in-slice scores (log2 domain): query r against the slice's token t,
  // -inf past the query's own token. One warp per (query, token).
  const long long knew_row = kd;  // elements between two tokens' K rows
  for (int p = warp; p < rows * S; p += kWarps) {
    const int r = p / S, t = p % S;
    const bool seen = t <= (row0 + r) / g;  // the same for every lane
    float dot = 0.f;
    if (seen) {
      const __nv_bfloat16* qr = reinterpret_cast<const __nv_bfloat16*>(qs + r * RS);
      const __nv_bfloat16* kr = knew + (tok0 + t) * knew_row + h * HD;
      for (int d = lane; d < HD; d += 32) dot = fmaf(bf(qr[d]), bf(kr[d]), dot);
    }
    dot = warp_sum(dot);
    if (lane == 0) sc[r * kMaxS + t] = seen ? dot * scale_log2 : -INFINITY;
  }
  __syncthreads();

  // The in-slice state (m, l, o) of element (r, d): always one token at
  // least, the query's own.
  auto slice_state = [&](int r, int d, float& m, float& l, float& o) {
    const int s = (row0 + r) / g;
    m = -INFINITY;
    for (int t = 0; t <= s; ++t) m = fmaxf(m, sc[r * kMaxS + t]);
    l = 0.f;
    o = 0.f;
    for (int t = 0; t <= s; ++t) {
      const float p = exp2f(sc[r * kMaxS + t] - m);
      l += p;
      o = fmaf(p, bf(vnew[(tok0 + t) * knew_row + h * HD + d]), o);
    }
  };

  // One partial per split: element e = (query r, dim d).
  const int n_el = rows * HD;
  const long long slots = static_cast<long long>(gridDim.x) * n_kv * gridDim.z;
  const long long bh = static_cast<long long>(blockIdx.z) * n_kv + h;
  const long long slot0 = bh * gridDim.x;  // this (row, group, kv head)'s split 0
  float* ws_o = ws;                         // [slots][kMaxRows * HD]
  float* ws_ml = ws + slots * kMaxRows * HD;  // [slots][kMaxRows][2]
  for (int e = tid; e < n_el; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const int x0 = (r / kTileRows) * KS, rr = r % kTileRows;
    float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll
    for (int x = 0; x < KS; ++x) m = fmaxf(m, wm[(x0 + x) * kTileRows + rr]);
#pragma unroll
    for (int x = 0; x < KS; ++x) {
      const float mx = wm[(x0 + x) * kTileRows + rr];
      const float a = mx == -INFINITY ? 0.f : exp2f(mx - m);
      l += a * wl[(x0 + x) * kTileRows + rr];
      o += a * wo[((x0 + x) * kTileRows + rr) * HD + d];
    }
    if (n_split == 1) {
      float fm, fl, fo;
      slice_state(r, d, fm, fl, fo);
      merge(fm, fl, fo, m, l, o);
      out[q_row(r) + d] = __float2bfloat16(fo / fl);
    } else {
      __stcg(ws_o + (slot0 + split) * (kMaxRows * HD) + e, o);
      if (d == 0) {
        __stcg(ws_ml + ((slot0 + split) * kMaxRows + r) * 2, m);
        __stcg(ws_ml + ((slot0 + split) * kMaxRows + r) * 2 + 1, l);
      }
    }
  }
  if (n_split == 1) return;

  // Every thread's partial, then the barrier, before thread 0's release;
  // the acquire side of the same atomic, then the barrier, before the last
  // block's reads of every split's partial.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int seen;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(seen)
                 : "l"(counters + bh)
                 : "memory");
    last = seen == n_split - 1;
    if (last) counters[bh] = 0;  // every split has counted: reset
  }
  __syncthreads();
  if (!last) return;
  for (int e = tid; e < n_el; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float m, l, o;
    slice_state(r, d, m, l, o);
    for (int j = 0; j < n_split; ++j) {
      const float* ml = ws_ml + ((slot0 + j) * kMaxRows + r) * 2;
      merge(m, l, o, __ldcg(ml), __ldcg(ml + 1),
            __ldcg(ws_o + (slot0 + j) * (kMaxRows * HD) + e));
    }
    out[q_row(r) + d] = __float2bfloat16(o / l);
  }
}

// ---- fp32: CUDA cores (flash_tile.cuh) --------------------------------------

constexpr int kBK = 32;
static_assert(kMaxS <= kBK, "the slice is one key tile");

template <int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
spec_verify_f32_kernel(const float* __restrict__ q, const float* __restrict__ kpool,
                       const float* __restrict__ vpool, const int* __restrict__ tables,
                       const int* __restrict__ ctx, const float* __restrict__ knew,
                       const float* __restrict__ vnew, float* __restrict__ out, int nh,
                       int n_kv, int S, int groups, int ps, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TileT = Tile<BQ, kBK, HD>;
  TileT tile(smem);
  const int h = blockIdx.y, b = blockIdx.z / groups, grp = blockIdx.z % groups;
  const int g = nh / n_kv;
  const int row0 = grp * BQ;
  const int rows = min(BQ, S * g - row0);
  const long long kd = static_cast<long long>(n_kv) * HD;
  const long long tok0 = static_cast<long long>(b) * S;
  const int n_tok = min(max(ctx[b] - 1, 0), pps * ps);
  const int* table = tables + static_cast<long long>(b) * pps;
  auto q_row = [&](int r) -> long long {
    if (r >= rows) return -1;
    const int x = row0 + r;
    return ((tok0 + x / g) * nh + h * g + x % g) * HD;
  };

  tile.init_stats();
  tile.load_q(q, scale, q_row);
  float acc[TileT::kAcc] = {};
  for (int t0 = 0; t0 < n_tok; t0 += kBK) {
    tile.load_kv(kpool, vpool, [&](int c) -> long long {
      const int t = t0 + c;
      if (t >= n_tok) return -1;
      const long long page = table[t / ps];
      return (page * ps + t % ps) * kd + static_cast<long long>(h) * HD;
    });
    tile.attend(acc, [&](int r, int c) { return r < rows && t0 + c < n_tok; });
  }
  // The slice: one tile of its S tokens, causal.
  tile.load_kv(knew, vnew, [&](int c) -> long long {
    return c < S ? (tok0 + c) * kd + static_cast<long long>(h) * HD : -1;
  });
  tile.attend(acc, [&](int r, int c) { return r < rows && c <= (row0 + r) / g; });
  tile.store(out, acc, q_row);
}

}  // namespace
}  // namespace kgct

// What every call of one (shapes, dtype, device) key passes unchanged
// (ops/cuda/spec_verify.py LaunchArgs).
struct SpecVerifyLaunch {
  float* ws;          // bf16: splits * n_kv * R * groups * 64 * (hd + 2) floats
  int* counters;      // bf16: R * groups * n_kv ints, all 0, left all 0
  int R, S, nh, n_kv, hd, ps, pps;
  int dtype;          // 0 = float32, 1 = bfloat16
  int min_split;      // fewest keys per split, a multiple of kgct_spec_verify_stage_keys()
  int splits;         // the grid's splits: the most per (row, group, kv head)
  float scale;
};

// Keys per stage of the bf16 kernel: min_split must be a multiple.
extern "C" int kgct_spec_verify_stage_keys() { return kgct::kSK; }
// Queries of one block for M queries per (row, kv head); the most S.
extern "C" int kgct_spec_verify_block_rows(int M) { return kgct::block_rows(M); }
extern "C" int kgct_spec_verify_max_s() { return kgct::kMaxS; }

namespace kgct {
namespace {

template <int HD, int KS>
cudaError_t launch_split(const SpecVerifyLaunch& a, int groups, const void* q, const void* kp,
                         const void* vp, const int* tables, const int* ctx, const void* kn,
                         const void* vn, void* out, cudaStream_t stream) {
  auto kernel = spec_verify_split_kernel<HD, KS>;
  constexpr size_t smem = VerifySmem<HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);  // once per process
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(a.splits, a.n_kv, a.R * groups), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), tables, ctx,
      static_cast<const __nv_bfloat16*>(kn), static_cast<const __nv_bfloat16*>(vn),
      static_cast<__nv_bfloat16*>(out), a.ws, a.counters, a.nh, a.n_kv, a.S, groups,
      ilog2(a.ps), a.pps, a.min_split, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_split(const SpecVerifyLaunch& a, const void* q, const void* kp,
                           const void* vp, const int* tables, const int* ctx, const void* kn,
                           const void* vn, void* out, cudaStream_t s) {
  const int M = a.S * (a.nh / a.n_kv);
  const int rows = block_rows(M);
  const int groups = (M + rows - 1) / rows;
  if (rows == 16)
    return launch_split<HD, 4>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
  if (rows == 32)
    return launch_split<HD, 2>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
  return launch_split<HD, 1>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
}

template <int HD, int BQ>
cudaError_t launch_f32(const SpecVerifyLaunch& a, int groups, const void* q, const void* kp,
                       const void* vp, const int* tables, const int* ctx, const void* kn,
                       const void* vn, void* out, cudaStream_t stream) {
  auto kernel = spec_verify_f32_kernel<HD, BQ>;
  constexpr size_t smem = Tile<BQ, kBK, HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(1, a.n_kv, a.R * groups), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), tables, ctx, static_cast<const float*>(kn),
      static_cast<const float*>(vn), static_cast<float*>(out), a.nh, a.n_kv, a.S, groups,
      a.ps, a.pps, a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_f32(const SpecVerifyLaunch& a, const void* q, const void* kp,
                         const void* vp, const int* tables, const int* ctx, const void* kn,
                         const void* vn, void* out, cudaStream_t s) {
  const int M = a.S * (a.nh / a.n_kv);
  const int rows = block_rows(M);
  const int groups = (M + rows - 1) / rows;
  if (rows == 16) return launch_f32<HD, 16>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
  if (rows == 32) return launch_f32<HD, 32>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
  return launch_f32<HD, 64>(a, groups, q, kp, vp, tables, ctx, kn, vn, out, s);
}

}  // namespace
}  // namespace kgct

// Pool pointers address ONE layer [P, ps, n_kv*hd]; q / k_new / v_new and
// out are [R*S, heads, hd]. The wrapper has checked the shapes and planned
// the splits. Returns the CUDA status of the launch.
extern "C" int kgct_spec_verify(const void* q, const void* k_pool, const void* v_pool,
                                const int* page_tables, const int* context_lens,
                                const void* k_new, const void* v_new, void* out,
                                const SpecVerifyLaunch* a, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (a->R == 0) return cudaSuccess;
  const int g = a->n_kv > 0 ? a->nh / a->n_kv : 0;
  if (g < 1 || g > kTileRows || a->nh != g * a->n_kv || a->S < 1 || a->S > kMaxS ||
      a->ps <= 0 || (a->ps & (a->ps - 1)) || a->pps < 1)
    return cudaErrorInvalidValue;
  if (a->dtype == 1) {
    if (a->min_split <= 0 || a->min_split % kSK || a->splits < 1 ||
        (a->splits > 1 && (a->ws == nullptr || a->counters == nullptr)))
      return cudaErrorInvalidValue;
    if (a->hd == 128)
      return dispatch_split<128>(*a, q, k_pool, v_pool, page_tables, context_lens, k_new,
                                 v_new, out, s);
    if (a->hd == 64)
      return dispatch_split<64>(*a, q, k_pool, v_pool, page_tables, context_lens, k_new,
                                v_new, out, s);
  } else if (a->dtype == 0) {
    if (a->hd == 128)
      return dispatch_f32<128>(*a, q, k_pool, v_pool, page_tables, context_lens, k_new,
                               v_new, out, s);
    if (a->hd == 64)
      return dispatch_f32<64>(*a, q, k_pool, v_pool, page_tables, context_lens, k_new,
                              v_new, out, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_spec_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
