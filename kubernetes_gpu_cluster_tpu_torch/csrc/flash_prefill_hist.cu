// Chunked-prefill history attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill_hist.py
// (flash_prefill_history, body _hist_kernel): one sequence's prompt chunk of
// T tokens attends fully to its hist_len tokens already committed to the
// paged pool (through its page table), then causally within the chunk.
// Tail padding is cut at n_valid = sum(seg >= 0); padding rows emit zeros.
// n_valid and hist_len are read from device memory (int32 scalars), so one
// launch captured in a CUDA graph serves every chunk a replay is given; the
// grid depends on T alone.
//
// Bound on the H100: operations once the chunk is a few hundred tokens
// (T * (hist_len + T/2) * hd * nh * 4 flops against hist_len * n_kv*hd * 4 B
// of history); bytes for short chunks over long histories.
//
// Design (bf16, the served dtype): the tensor-core tile of flash_prefill.cu
// (FlashAttention-2 on mma.sync, flash_mma.cuh AttnWarp). One block of four
// warps owns 64 query rows of one q head, 16 rows per warp, with its Q
// fragments in registers for the whole sweep. K/V arrive in 64-key bf16
// stages through a two-stage cp.async ring of 16-byte copies, and the block
// walks one list of tiles in two phases: first the history, each key's row
// gathered through table[t / ps] (one stage spans 64 / ps pages, or half a
// page at ps 128), then the chunk's own tiles from key 0 to the diagonal.
// The two tile grids stay separate because hist_len is a multiple of
// neither 64 nor ps. Only the last, partial history tile (t < hist), the
// diagonal tile and the n_valid edge are masked; keys outside are
// zero-filled by the copies. A q tile made only of padding stores zeros and
// does no work, and padding rows of a mixed tile store zeros. The heaviest
// q tiles (last in T) are launched first. The g q heads of one kv head read
// the same history again from L2: the kernel is bound by operations.
//
// fp32 inputs (the tests and debug models) keep the CUDA-core tile of
// flash_tile.cuh as their own template instance.

#include "flash_mma.cuh"
#include "flash_tile.cuh"

namespace kgct {
namespace {

constexpr int kBQ = 64;
constexpr int kBK = 64;

// ---- bf16: tensor cores -------------------------------------------------

template <int HD>
struct MmaSmem {
  static constexpr int RS = mma::AttnWarp<HD, kBK>::RS;
  static constexpr int kTile = kBK * RS;                    // one K or V tile
  static constexpr size_t kBytes = static_cast<size_t>(kBQ * RS + 4 * kTile);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_hist_mma_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ kpool,
                              const __nv_bfloat16* __restrict__ vpool,
                              const int* __restrict__ table,
                              const int* __restrict__ n_valid_ptr,
                              const int* __restrict__ hist_len_ptr,
                              __nv_bfloat16* __restrict__ out, int T, int nh, int n_kv,
                              int ps_shift, int pps, float scale_log2) {
  using S = MmaSmem<HD>;
  constexpr int RS = S::RS;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* kvs = smem + kBQ * RS;  // stage s: K at 2s, V at 2s + 1
  const int qi = gridDim.x - 1 - blockIdx.x, head = blockIdx.y;
  const int kvh = head / (nh / n_kv);
  const int q0 = qi * kBQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, gid = lane / 4;
  const int ps = 1 << ps_shift;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int n_valid = min(*n_valid_ptr, T);
  // A negative history is none: the scheduler never gives one.
  const int hist = max(0, min(*hist_len_ptr, pps * ps));

  if (q0 >= n_valid) {  // only padding: zeros, no work
    for (int c = tid; c < kBQ * kChunks; c += kThreads) {
      const int r = c / kChunks;
      if (q0 + r < T)
        reinterpret_cast<uint4*>(out + (static_cast<long long>(q0 + r) * nh + head) * HD)
            [c % kChunks] = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  for (int c = tid; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, ch = c % kChunks;
    const bool ok = q0 + r < T;
    mma::cp_async16(qs + r * RS + ch * 16,
                    ok ? q + (static_cast<long long>(q0 + r) * nh + head) * HD + ch * 8 : q, ok);
  }
  // Tiles [0, n_hist): the history; [n_hist, n_tiles): the chunk up to the
  // diagonal of this q tile's last valid row.
  const int n_hist = (hist + kBK - 1) / kBK;
  const int n_tiles = n_hist + min(q0 + kBQ - 1, n_valid - 1) / kBK + 1;
  auto load_kv = [&](int stage, int it) {
    unsigned char* ks = kvs + (2 * stage) * S::kTile;
    unsigned char* vs = ks + S::kTile;
    const bool from_pool = it < n_hist;
    const int t0 = (from_pool ? it : it - n_hist) * kBK;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks, t = t0 + r;
      const __nv_bfloat16 *kb = k, *vb = v;
      long long o = 0;
      bool ok;
      if (from_pool) {
        ok = t < hist;
        kb = kpool;
        vb = vpool;
        if (ok)
          o = ((static_cast<long long>(__ldg(table + (t >> ps_shift))) << ps_shift) +
               (t & (ps - 1))) * kd;
      } else {
        ok = t < n_valid;
        o = static_cast<long long>(t) * kd;
      }
      o = ok ? o + kvh * HD + ch * 8 : 0;
      mma::cp_async16(ks + r * RS + ch * 16, kb + o, ok);
      mma::cp_async16(vs + r * RS + ch * 16, vb + o, ok);
    }
  };

  load_kv(0, 0);
  mma::cp_async_commit();  // group 0: Q and the first K/V tile

  const int row_lo = q0 + warp * 16 + gid, row_hi = row_lo + 8;

  mma::AttnWarp<HD, kBK> w;
  w.init();
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with the stage loaded next
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // tile it (and Q) is in
    if (it == 0) w.load_q(qs + warp * 16 * RS);
    const unsigned char* ks = kvs + (2 * (it & 1)) * S::kTile;
    const unsigned char* vs = ks + S::kTile;
    if (it < n_hist) {
      const int k0 = it * kBK;
      if (k0 + kBK <= hist)
        w.template attend<false>(ks, vs, scale_log2, [](bool, int) { return true; });
      else
        w.template attend<true>(ks, vs, scale_log2,
                                [&](bool, int c) { return k0 + c < hist; });
    } else {
      const int k0 = (it - n_hist) * kBK;
      if (k0 + kBK - 1 <= q0 && k0 + kBK <= n_valid) {
        w.template attend<false>(ks, vs, scale_log2, [](bool, int) { return true; });
      } else {
        w.template attend<true>(ks, vs, scale_log2, [&](bool hi, int c) {
          const int t = k0 + c;
          return t <= (hi ? row_hi : row_lo) && t < n_valid;
        });
      }
    }
  }
  // Padding rows of a tile that holds valid rows too: zeros.
  if (row_lo >= n_valid) w.l[0] = 0.f;
  if (row_hi >= n_valid) w.l[1] = 0.f;
  w.store(row_lo < T ? out + (static_cast<long long>(row_lo) * nh + head) * HD : nullptr,
          row_hi < T ? out + (static_cast<long long>(row_hi) * nh + head) * HD : nullptr);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const void* kp,
                       const void* vp, const int* table, const int* n_valid,
                       const int* hist_len, void* out, int T, int nh, int n_kv, int ps,
                       int pps, float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_hist_mma_kernel<HD>;
  const size_t smem = MmaSmem<HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);  // once per process
  if (attr != cudaSuccess) return attr;
  const int nq = (T + kBQ - 1) / kBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), table, n_valid, hist_len,
      static_cast<__nv_bfloat16*>(out), T, nh, n_kv, ilog2(ps), pps,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores (flash_tile.cuh) ----------------------------------

constexpr int kFBQ = 32;
constexpr int kFBK = 32;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_hist_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ kpool,
                              const float* __restrict__ vpool, const int* __restrict__ table,
                              const int* __restrict__ n_valid_ptr,
                              const int* __restrict__ hist_len_ptr, float* __restrict__ out,
                              int T_total, int nh, int n_kv, int ps, int pps, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TileT = Tile<kFBQ, kFBK, HD>;
  TileT tile(smem);
  const int qi = blockIdx.x, head = blockIdx.y;
  const int kvh = head / (nh / n_kv);
  const int q0 = qi * kFBQ;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int n_valid = min(*n_valid_ptr, T_total);
  const int hist = max(0, min(*hist_len_ptr, pps * ps));
  auto q_row = [&](int r) -> long long {
    const int t = q0 + r;
    return t < T_total ? (static_cast<long long>(t) * nh + head) * HD : -1;
  };

  tile.init_stats();
  float acc[TileT::kAcc] = {};
  if (q0 < n_valid) {
    tile.load_q(q, scale, [&](int r) -> long long {
      return q0 + r < n_valid ? q_row(r) : -1;
    });
    // Phase 1: the committed history, every valid row attends.
    for (int t0 = 0; t0 < hist; t0 += kFBK) {
      tile.load_kv(kpool, vpool, [&](int c) -> long long {
        const int t = t0 + c;
        if (t >= hist) return -1;
        const long long page = table[t / ps];
        return (page * ps + t % ps) * kd + static_cast<long long>(kvh) * HD;
      });
      tile.attend(acc, [&](int r, int c) {
        return q0 + r < n_valid && t0 + c < hist;
      });
    }
    // Phase 2: causal within the chunk, cut at n_valid.
    const int kb_hi = min(q0 + kFBQ - 1, n_valid - 1) / kFBK;
    for (int kb = 0; kb <= kb_hi; ++kb) {
      const int k0 = kb * kFBK;
      tile.load_kv(k, v, [&](int c) -> long long {
        const int t = k0 + c;
        return t < n_valid ? (static_cast<long long>(t) * n_kv + kvh) * HD : -1;
      });
      tile.attend(acc, [&](int r, int c) {
        const int row = q0 + r, col = k0 + c;
        return row < n_valid && col <= row && col < n_valid;
      });
    }
  } else {
    __syncthreads();  // init_stats visible to store
  }
  tile.store(out, acc, q_row);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* kp,
                       const void* vp, const int* table, const int* n_valid,
                       const int* hist_len, void* out, int T_total, int nh, int n_kv,
                       int ps, int pps, float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_hist_f32_kernel<HD>;
  const size_t smem = Tile<kFBQ, kFBK, HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int nq = (T_total + kFBQ - 1) / kFBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(kp), static_cast<const float*>(vp), table, n_valid, hist_len,
      static_cast<float*>(out), T_total, nh, n_kv, ps, pps, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kgct

// What every call of one (shapes, dtype, device) key passes unchanged
// (ops/cuda/flash_prefill_hist.py LaunchArgs).
struct HistLaunch {
  int T, nh, n_kv, hd, ps, pps;
  int dtype;  // 0 = float32, 1 = bfloat16
  float scale;
};

// Pool pointers address ONE layer [P, ps, n_kv*hd]; n_valid and hist_len
// are device int32 scalars (a negative hist_len reads as 0). The wrapper
// has checked the shapes. Returns the CUDA status of the launch.
extern "C" int kgct_flash_prefill_hist(const void* q, const void* k, const void* v,
                                       const void* k_pool, const void* v_pool,
                                       const int* page_table, const int* n_valid,
                                       const int* hist_len, void* out, const HistLaunch* a,
                                       void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  const int T = a->T, nh = a->nh, n_kv = a->n_kv, ps = a->ps, pps = a->pps;
  if (T == 0) return cudaSuccess;
  if (n_kv <= 0 || nh % n_kv || ps <= 0 || (ps & (ps - 1)))
    return cudaErrorInvalidValue;
  if (a->dtype == 1 && a->hd == 128)
    return launch_mma<128>(q, k, v, k_pool, v_pool, page_table, n_valid, hist_len, out, T, nh,
                           n_kv, ps, pps, a->scale, s);
  if (a->dtype == 1 && a->hd == 64)
    return launch_mma<64>(q, k, v, k_pool, v_pool, page_table, n_valid, hist_len, out, T, nh,
                          n_kv, ps, pps, a->scale, s);
  if (a->dtype == 0 && a->hd == 128)
    return launch_f32<128>(q, k, v, k_pool, v_pool, page_table, n_valid, hist_len, out, T, nh,
                           n_kv, ps, pps, a->scale, s);
  if (a->dtype == 0 && a->hd == 64)
    return launch_f32<64>(q, k, v, k_pool, v_pool, page_table, n_valid, hist_len, out, T, nh,
                          n_kv, ps, pps, a->scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_flash_prefill_hist_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
