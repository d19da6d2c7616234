// Paged decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/paged_decode.py
// (pallas_paged_decode, body _decode_kernel): one query token per sequence
// against its paged history, GQA, fp32 online softmax. The pool
// [L, P, ps, n_kv*hd] is read BEFORE this step's write, so the current
// token's K/V arrive separately and fold in last.
//
// Bound on the H100: bytes. Every history token's K and V row is read once
// (2 * ctx * hd * 2 B per kv head in bf16) for ~4 * g * hd flops, far below
// the ~295 flops/byte where the tensor cores would become the limit.
//
// What the simple design does about it: one block per (sequence, kv head)
// holds that kv head's g query heads as the tile's rows, so each K/V row is
// fetched from device memory once and used by all g heads; only the pages
// below ctx-1 are gathered (through the page table), never the padded table
// tail. The block-diagonal Q and iota selector matmuls of the TPU kernel
// were Mosaic workarounds and have no counterpart here. Split-K over pages
// (flash-decoding) for long contexts, vector loads and tensor cores are
// later work.

#include "flash_tile.cuh"

namespace kgct {
namespace {

constexpr int kBK = 32;

template <typename T, int HD, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool, const int* __restrict__ tables,
                    const int* __restrict__ ctx, const T* __restrict__ kcur,
                    const T* __restrict__ vcur, T* __restrict__ out, int nh,
                    int n_kv, int ps, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TileT = Tile<G, kBK, HD>;
  TileT tile(smem);
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nh / n_kv;
  const long long kd = static_cast<long long>(n_kv) * HD;
  // Tokens already in the pool: ctx counts the current token; a padded row
  // (ctx 0) reads no page. Never more than the table covers.
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

template <typename T, int HD, int G>
cudaError_t launch(const void* q, const void* kp, const void* vp, const int* tables,
                   const int* ctx, const void* kc, const void* vc, void* out, int B,
                   int nh, int n_kv, int ps, int pps, float scale, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, HD, G>;
  const size_t smem = Tile<G, kBK, HD>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(B, n_kv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      tables, ctx, static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<T*>(out), nh, n_kv, ps, pps, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int g, const void* q, const void* kp, const void* vp,
                       const int* tables, const int* ctx, const void* kc,
                       const void* vc, void* out, int B, int nh, int n_kv, int ps,
                       int pps, float scale, cudaStream_t stream) {
  if (g <= 4)
    return launch<T, HD, 4>(q, kp, vp, tables, ctx, kc, vc, out, B, nh, n_kv, ps,
                            pps, scale, stream);
  if (g <= 8)
    return launch<T, HD, 8>(q, kp, vp, tables, ctx, kc, vc, out, B, nh, n_kv, ps,
                            pps, scale, stream);
  if (g <= 16)
    return launch<T, HD, 16>(q, kp, vp, tables, ctx, kc, vc, out, B, nh, n_kv, ps,
                             pps, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace kgct

// dtype: 0 = float32, 1 = bfloat16. Pool pointers address ONE layer
// [P, ps, n_kv*hd]. Returns the CUDA status of the launch.
extern "C" int kgct_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 const int* page_tables, const int* context_lens,
                                 const void* k_cur, const void* v_cur, void* out,
                                 int B, int nh, int n_kv, int hd, int ps, int pps,
                                 float scale, int dtype, void* stream) {
  using namespace kgct;
  const int g = nh / n_kv;
  auto s = static_cast<cudaStream_t>(stream);
  if (B == 0) return cudaSuccess;
  if (dtype == 1 && hd == 128)
    return dispatch_g<__nv_bfloat16, 128>(g, q, k_pool, v_pool, page_tables,
                                          context_lens, k_cur, v_cur, out, B, nh,
                                          n_kv, ps, pps, scale, s);
  if (dtype == 1 && hd == 64)
    return dispatch_g<__nv_bfloat16, 64>(g, q, k_pool, v_pool, page_tables,
                                         context_lens, k_cur, v_cur, out, B, nh,
                                         n_kv, ps, pps, scale, s);
  if (dtype == 0 && hd == 128)
    return dispatch_g<float, 128>(g, q, k_pool, v_pool, page_tables, context_lens,
                                  k_cur, v_cur, out, B, nh, n_kv, ps, pps, scale, s);
  if (dtype == 0 && hd == 64)
    return dispatch_g<float, 64>(g, q, k_pool, v_pool, page_tables, context_lens,
                                 k_cur, v_cur, out, B, nh, n_kv, ps, pps, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_paged_decode_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
