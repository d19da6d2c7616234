// Paged decode attention for Hopper (sm_90a): split-K flash-decoding.
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/paged_decode.py
// (pallas_paged_decode, body _decode_kernel): one query token per sequence
// against its paged history, GQA, fp32 online softmax. The pool
// [L, P, ps, n_kv*hd] is read BEFORE this step's write, so the current
// token's K/V arrive separately and fold in once, in the final merge.
//
// Bound on the H100: bytes. Every history token's K and V row is read once
// (2 * ctx * hd * 2 B per kv head in bf16) for ~4 * g * hd flops, about 8
// flops per byte against the ~295 where the tensor cores would become the
// limit. What wins is bytes in flight on every SM.
//
// Design (bf16, the served dtype). The grid is (S, n_kv, B). The wrapper
// chooses S from what the host knows (B, n_kv, the SM count and the page
// table's width), never from the context lengths, which live on the
// device: at most two waves of the blocks the card keeps resident, so one
// long sequence still fills the card, also when it decodes among short
// ones. Each block cuts its sequence's n_tok = ctx - 1 pooled tokens into
// at most S splits of whole 64-key stages, at least min_split keys each
// (the same cut in every block, from ctx alone), and takes split
// blockIdx.x; blocks past the last split exit at once. Sizing the splits
// by the table's width instead (every split min_split keys) left most of
// the grid empty at short contexts: those blocks cost 10 us per call at
// the engine's 512-page table (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// A block holds its kv head's g <= 16 query heads as the 16 rows of an
// mma.sync tile (rows past g are zero and never stored) and streams its
// split's K/V rows, gathered through the page table, as 64-key stages
// through a three-stage ring of 16-byte cp.async copies, two stages in
// flight while one is used. Each of the four warps folds 16 keys of every
// stage into its own online softmax (flash_mma.cuh AttnWarp): the
// products are nearly free next to the bytes, and one tile serves every
// group size up to 16. The warps' states then merge in shared memory into
// one partial (m, l, o[hd]) in fp32 per split.
//
// A sequence with one split finishes in its block. With more, every block
// writes its partial to the workspace and counts itself on its (sequence,
// kv head) counter with one release-acquire atomic; the last to arrive
// folds the current token and then the partials in split order (the same
// bits on every call, whatever order the blocks ran in) and resets the
// counter to 0 for the next call or graph replay. This was chosen over a
// second combine kernel: one launch per call, and sequences with one split
// (most of a decode batch at short contexts) never touch the workspace.
// The wrapper allocates workspace and counters; the kernel allocates
// nothing and never synchronizes with the host, so calls can be captured
// in a CUDA graph.
//
// fp32 inputs (the tests and debug models) keep the CUDA-core tile of
// flash_tile.cuh: one block per (sequence, kv head) over 32-key tiles.

#include "flash_mma.cuh"
#include "flash_tile.cuh"

namespace kgct {
namespace {

// ---- bf16: split-K on tensor cores ------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;          // q rows of a block: the kv head's g heads
constexpr int kSK = 64;            // keys per stage; a split is whole stages
constexpr int kWK = kSK / kWarps;  // keys per warp per stage
constexpr int kStages = 3;

template <int HD>
struct SplitSmem {
  static constexpr int RS = mma::AttnWarp<HD, kWK>::RS;
  static constexpr int kTile = kSK * RS;  // one K or V stage
  static constexpr size_t kRing = 2ull * kStages * kTile;
  // Once the ring has drained it holds the warps' states: o [warps][16][HD],
  // m and l [warps][16], and the current token's score [16].
  static constexpr size_t kMerge =
      sizeof(float) * (kWarps * kRows * HD + 2 * kWarps * kRows + kRows);
  static constexpr size_t kBytes = kRows * RS + (kRing > kMerge ? kRing : kMerge);
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

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kpool,
                          const __nv_bfloat16* __restrict__ vpool,
                          const int* __restrict__ tables, const int* __restrict__ ctx,
                          const __nv_bfloat16* __restrict__ kcur,
                          const __nv_bfloat16* __restrict__ vcur,
                          __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                          int* __restrict__ counters, int nh, int n_kv, int ps_shift,
                          int pps, int min_split, float scale_log2) {
  using S = SplitSmem<HD>;
  constexpr int RS = S::RS;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  unsigned char* qs = smem;
  unsigned char* ring = smem + kRows * RS;  // stage s: K at 2s, V at 2s + 1
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int g = nh / n_kv, ps = 1 << ps_shift;
  // Tokens already in the pool: ctx counts the current token; a padded row
  // (ctx 0) reads no page. Never more than the table covers.
  const int n_tok = min(max(ctx[b] - 1, 0), pps * ps);
  const int per = ((n_tok + gridDim.x - 1) / gridDim.x + kSK - 1) / kSK * kSK;
  const int split_tokens = max(min_split, per);
  const int n_split = n_tok == 0 ? 1 : (n_tok + split_tokens - 1) / split_tokens;
  if (split >= n_split) return;
  const int t_lo = split * split_tokens, t_hi = min(t_lo + split_tokens, n_tok);
  const int n_tiles = (t_hi - t_lo + kSK - 1) / kSK;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int* table = tables + static_cast<long long>(b) * pps;
  const long long bh = static_cast<long long>(b) * n_kv + h;
  const __nv_bfloat16* q_b = q + (static_cast<long long>(b) * nh + h * g) * HD;

  for (int c = tid; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    mma::cp_async16(qs + r * RS + ch * 16, r < g ? q_b + r * HD + ch * 8 : q, r < g);
  }
  auto load_kv = [&](int stage, int it) {
    unsigned char* ks = ring + (2 * stage) * S::kTile;
    unsigned char* vs = ks + S::kTile;
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
    if (it == 0) w.load_q(qs);
    const int k0 = t_lo + it * kSK + warp * kWK;
    if (k0 < t_hi) {
      const unsigned char* ks = ring + (2 * (it % kStages)) * S::kTile + warp * kWK * RS;
      const unsigned char* vs = ks + S::kTile;
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
  float* wo = reinterpret_cast<float*>(ring);  // [warps][kRows][HD]
  float* wm = wo + kWarps * kRows * HD;        // [warps][kRows]
  float* wl = wm + kWarps * kRows;             // [warps][kRows]
  float* sc = wl + kWarps * kRows;             // [kRows]
  {
    float l0 = w.l[0], l1 = w.l[1];
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    if (tig == 0) {
      wm[warp * kRows + gid] = w.m[0];
      wm[warp * kRows + gid + 8] = w.m[1];
      wl[warp * kRows + gid] = l0;
      wl[warp * kRows + gid + 8] = l1;
    }
    float* o_lo = wo + (warp * kRows + gid) * HD;
    float* o_hi = o_lo + 8 * HD;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int c = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(o_lo + c) = make_float2(w.o[n][0], w.o[n][1]);
      *reinterpret_cast<float2*>(o_hi + c) = make_float2(w.o[n][2], w.o[n][3]);
    }
  }
  // The current token's score of each row (log2 domain), one warp per row.
  const __nv_bfloat16* kc = kcur + bh * HD;
  for (int r = warp; r < g; r += kWarps) {
    const __nv_bfloat16* qr = reinterpret_cast<const __nv_bfloat16*>(qs + r * RS);
    float dot = 0.f;
    for (int d = lane; d < HD; d += 32)
      dot = fmaf(__bfloat162float(qr[d]), __bfloat162float(kc[d]), dot);
    dot = warp_sum(dot);
    if (lane == 0) sc[r] = dot * scale_log2;
  }
  __syncthreads();

  // One partial per split: element e = (row r, dim d) of the g x HD output.
  const int n_el = g * HD;
  const __nv_bfloat16* vc = vcur + bh * HD;
  __nv_bfloat16* out_b = out + (static_cast<long long>(b) * nh + h * g) * HD;
  const long long slots = static_cast<long long>(gridDim.x) * n_kv * gridDim.z;
  const long long slot0 = bh * gridDim.x;  // this (sequence, kv head)'s split 0
  float* ws_o = ws;                         // [slots][g * HD]
  float* ws_ml = ws + slots * n_el;         // [slots][g][2]
  for (int e = tid; e < n_el; e += kThreads) {
    const int r = e / HD, d = e % HD;
    float m = -INFINITY, l = 0.f, o = 0.f;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) m = fmaxf(m, wm[x * kRows + r]);
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      const float mx = wm[x * kRows + r];
      const float a = mx == -INFINITY ? 0.f : exp2f(mx - m);
      l += a * wl[x * kRows + r];
      o += a * wo[(x * kRows + r) * HD + d];
    }
    if (n_split == 1) {
      float fm = sc[r], fl = 1.f, fo = __bfloat162float(vc[d]);
      merge(fm, fl, fo, m, l, o);
      out_b[e] = __float2bfloat16(fo / fl);
    } else {
      __stcg(ws_o + (slot0 + split) * n_el + e, o);
      if (d == 0) {
        __stcg(ws_ml + ((slot0 + split) * g + r) * 2, m);
        __stcg(ws_ml + ((slot0 + split) * g + r) * 2 + 1, l);
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
    float m = sc[r], l = 1.f, o = __bfloat162float(vc[d]);
    for (int j = 0; j < n_split; ++j) {
      const float* ml = ws_ml + ((slot0 + j) * g + r) * 2;
      merge(m, l, o, __ldcg(ml), __ldcg(ml + 1), __ldcg(ws_o + (slot0 + j) * n_el + e));
    }
    out_b[e] = __float2bfloat16(o / l);
  }
}

// ---- fp32: CUDA cores (flash_tile.cuh) --------------------------------------

constexpr int kBK = 32;

template <int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_f32_kernel(const float* __restrict__ q, const float* __restrict__ kpool,
                        const float* __restrict__ vpool, const int* __restrict__ tables,
                        const int* __restrict__ ctx, const float* __restrict__ kcur,
                        const float* __restrict__ vcur, float* __restrict__ out, int nh,
                        int n_kv, int ps, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TileT = Tile<G, kBK, HD>;
  TileT tile(smem);
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nh / n_kv;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int n_tok = min(max(ctx[b] - 1, 0), pps * ps);
  const int* table = tables + static_cast<long long>(b) * pps;
  const long long q_row0 = (static_cast<long long>(b) * nh + h * g) * HD;

  tile.init_stats();
  tile.load_q(q, scale, [&](int r) -> long long {
    return r < g ? q_row0 + static_cast<long long>(r) * HD : -1;
  });
  float acc[TileT::kAcc] = {};

  for (int t0 = 0; t0 < n_tok; t0 += kBK) {
    tile.load_kv(kpool, vpool, [&](int c) -> long long {
      const int t = t0 + c;
      if (t >= n_tok) return -1;
      const long long page = table[t / ps];
      return (page * ps + t % ps) * kd + static_cast<long long>(h) * HD;
    });
    tile.attend(acc, [&](int r, int c) { return r < g && t0 + c < n_tok; });
  }
  // The current token: a one-key tile, always valid.
  tile.load_kv(kcur, vcur, [&](int c) -> long long {
    return c == 0 ? (static_cast<long long>(b) * n_kv + h) * HD : -1;
  });
  tile.attend(acc, [&](int r, int c) { return r < g && c == 0; });
  tile.store(out, acc, [&](int r) -> long long {
    return r < g ? q_row0 + static_cast<long long>(r) * HD : -1;
  });
}

}  // namespace
}  // namespace kgct

// What every call of one (shapes, dtype, device) key passes unchanged
// (ops/cuda/paged_decode.py LaunchArgs).
struct PagedDecodeLaunch {
  int B, nh, n_kv, hd, ps, pps;
  int dtype;          // 0 = float32, 1 = bfloat16
  int min_split;      // fewest keys per split, a multiple of kgct_paged_decode_stage_keys()
  int splits;         // the grid's splits: the most per (sequence, kv head)
  float scale;
};

// Keys per stage of the bf16 kernel: min_split must be a multiple.
extern "C" int kgct_paged_decode_stage_keys() { return kgct::kSK; }

namespace kgct {
namespace {

template <int HD>
cudaError_t launch_split(const PagedDecodeLaunch& a, const void* q, const void* kp,
                         const void* vp, const int* tables, const int* ctx, const void* kc,
                         const void* vc, void* out, float* ws, int* counters,
                         cudaStream_t stream) {
  auto kernel = paged_decode_split_kernel<HD>;
  constexpr size_t smem = SplitSmem<HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);  // once per process
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(a.splits, a.n_kv, a.B), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), tables, ctx,
      static_cast<const __nv_bfloat16*>(kc), static_cast<const __nv_bfloat16*>(vc),
      static_cast<__nv_bfloat16*>(out), ws, counters, a.nh, a.n_kv, ilog2(a.ps),
      a.pps, a.min_split, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD, int G>
cudaError_t launch_f32(const PagedDecodeLaunch& a, const void* q, const void* kp,
                       const void* vp, const int* tables, const int* ctx, const void* kc,
                       const void* vc, void* out, cudaStream_t stream) {
  auto kernel = paged_decode_f32_kernel<HD, G>;
  constexpr size_t smem = Tile<G, kBK, HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<dim3(a.B, a.n_kv), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), tables, ctx, static_cast<const float*>(kc),
      static_cast<const float*>(vc), static_cast<float*>(out), a.nh, a.n_kv, a.ps, a.pps,
      a.scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t dispatch_f32(const PagedDecodeLaunch& a, const void* q, const void* kp,
                         const void* vp, const int* tables, const int* ctx, const void* kc,
                         const void* vc, void* out, cudaStream_t s) {
  const int g = a.nh / a.n_kv;
  if (g <= 4) return launch_f32<HD, 4>(a, q, kp, vp, tables, ctx, kc, vc, out, s);
  if (g <= 8) return launch_f32<HD, 8>(a, q, kp, vp, tables, ctx, kc, vc, out, s);
  if (g <= 16) return launch_f32<HD, 16>(a, q, kp, vp, tables, ctx, kc, vc, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace kgct

// Pool pointers address ONE layer [P, ps, n_kv*hd]. The wrapper has checked
// the shapes and planned the splits. bf16 with splits > 1 takes the call's
// workspace (splits * n_kv * B * g * (hd + 2) floats) and counters (B *
// n_kv ints, all 0, left all 0) as arguments, never from the launch record
// that every call of one key shares: two threads may launch one key at
// once, each on its own stream's set. Returns the CUDA status of the launch.
extern "C" int kgct_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const int* page_tables, const int* context_lens,
                                 const void* k_cur, const void* v_cur, void* out, float* ws,
                                 int* counters, const PagedDecodeLaunch* a, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (a->B == 0) return cudaSuccess;
  const int g = a->n_kv > 0 ? a->nh / a->n_kv : 0;
  if (g < 1 || g > kRows || a->nh != g * a->n_kv || a->ps <= 0 || (a->ps & (a->ps - 1)))
    return cudaErrorInvalidValue;
  if (a->dtype == 1) {
    if (a->min_split <= 0 || a->min_split % kSK || a->splits < 1 ||
        (a->splits > 1 && (ws == nullptr || counters == nullptr)))
      return cudaErrorInvalidValue;
    if (a->hd == 128)
      return launch_split<128>(*a, q, k_pool, v_pool, page_tables, context_lens, k_cur,
                               v_cur, out, ws, counters, s);
    if (a->hd == 64)
      return launch_split<64>(*a, q, k_pool, v_pool, page_tables, context_lens, k_cur,
                              v_cur, out, ws, counters, s);
  } else if (a->dtype == 0) {
    if (a->hd == 128)
      return dispatch_f32<128>(*a, q, k_pool, v_pool, page_tables, context_lens, k_cur,
                               v_cur, out, s);
    if (a->hd == 64)
      return dispatch_f32<64>(*a, q, k_pool, v_pool, page_tables, context_lens, k_cur,
                              v_cur, out, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
