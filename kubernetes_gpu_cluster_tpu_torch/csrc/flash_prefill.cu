// Ragged (segment-causal) flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill.py
// (flash_ragged_prefill, body _prefill_kernel): T flattened prompt tokens
// with segment ids, attention causal within each segment, GQA. Segments are
// contiguous runs of one id, so the mask is
//     attend(q, k) <=> seg[q] == seg[k] && k <= q && seg[q] >= 0
// and padding rows (seg -1) emit zeros.
//
// Bound on the H100: bytes at the serving shape (4 segments of 512: 8.6
// GFLOP of causal work against 21 MB of q/k/v/out), operations for long
// segments (the flops grow with n^2 per segment, the bytes with n).
//
// Design (bf16, the served dtype): FlashAttention-2 on mma.sync m16n8k16.
// One block of four warps owns 64 query rows of one q head, 16 rows per
// warp, with its Q fragments in registers for the whole sweep; the
// scores, the online softmax and P stay in registers (flash_mma.cuh). K/V
// arrive in 64-key bf16 tiles through a two-stage cp.async ring of 16-byte
// copies (rows past T zero-filled), so the next tile's bytes are in flight
// while this one is multiplied. The block walks only the key tiles its rows
// can attend, from kb_min (the tile holding the segment start of the q
// tile's first row, computed by the wrapper exactly as the TPU kernel's
// window start) to the diagonal; a tile strictly below the diagonal whose
// first key and the q tile's last row share a segment needs no mask. A q
// tile made only of padding skips all work. The heaviest q tiles (last in
// T) are launched first.
//
// fp32 inputs (the tests and debug models) keep the fp32 CUDA-core tile of
// flash_tile.cuh as their own template instance, chosen by dtype, at the
// same 64 x 64 tile sizes, so kb_min is the same for both.

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
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg,
                         const int* __restrict__ kb_min, __nv_bfloat16* __restrict__ out,
                         int T, int nh, int n_kv, float scale_log2) {
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

  const int my_seg = tid < kBQ && q0 + tid < T ? seg[q0 + tid] : -1;
  if (!__syncthreads_or(my_seg >= 0)) {  // only padding: zeros, no work
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
  auto load_kv = [&](int stage, int kb) {
    unsigned char* ks = kvs + (2 * stage) * S::kTile;
    unsigned char* vs = ks + S::kTile;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, ch = c % kChunks, t = kb * kBK + r;
      const bool ok = t < T;
      const long long o = (static_cast<long long>(t) * n_kv + kvh) * HD + ch * 8;
      mma::cp_async16(ks + r * RS + ch * 16, ok ? k + o : k, ok);
      mma::cp_async16(vs + r * RS + ch * 16, ok ? v + o : v, ok);
    }
  };

  const int kb_lo = kb_min[qi];
  const int kb_hi = min(q0 + kBQ - 1, T - 1) / kBK;
  const int n_tiles = kb_hi - kb_lo + 1;
  load_kv(0, kb_lo);
  mma::cp_async_commit();  // group 0: Q and the first K/V tile

  const int row_lo = q0 + warp * 16 + gid, row_hi = row_lo + 8;
  const int seg_lo = row_lo < T ? seg[row_lo] : -1;
  const int seg_hi = row_hi < T ? seg[row_hi] : -1;
  const int seg_last = q0 + kBQ - 1 < T ? seg[q0 + kBQ - 1] : -2;

  mma::AttnWarp<HD, kBK> w;
  w.init();
  for (int it = 0; it < n_tiles; ++it) {
    __syncthreads();  // every warp is done with the stage loaded next
    if (it + 1 < n_tiles) load_kv((it + 1) & 1, kb_lo + it + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();
    __syncthreads();  // tile it (and Q) is in
    if (it == 0) w.load_q(qs + warp * 16 * RS);
    const int k0 = (kb_lo + it) * kBK;
    const unsigned char* ks = kvs + (2 * (it & 1)) * S::kTile;
    const unsigned char* vs = ks + S::kTile;
    const int seg_k0 = seg[k0];
    if (k0 + kBK - 1 <= q0 && seg_k0 >= 0 && seg_k0 == seg_last) {
      w.template attend<false>(ks, vs, scale_log2, [](bool, int) { return true; });
    } else {
      w.template attend<true>(ks, vs, scale_log2, [&](bool hi, int c) {
        const int t = k0 + c, row = hi ? row_hi : row_lo, sq = hi ? seg_hi : seg_lo;
        return t < T && t <= row && sq >= 0 && __ldg(seg + t) == sq;
      });
    }
  }
  w.store(row_lo < T ? out + (static_cast<long long>(row_lo) * nh + head) * HD : nullptr,
          row_hi < T ? out + (static_cast<long long>(row_hi) * nh + head) * HD : nullptr);
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* seg,
                       const int* kb_min, void* out, int T, int nh, int n_kv, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_prefill_mma_kernel<HD>;
  const size_t smem = MmaSmem<HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);  // once per process
  if (attr != cudaSuccess) return attr;
  const int nq = (T + kBQ - 1) / kBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, kb_min, static_cast<__nv_bfloat16*>(out), T,
      nh, n_kv, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// ---- fp32: CUDA cores (flash_tile.cuh) ----------------------------------

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const int* __restrict__ seg,
                         const int* __restrict__ kb_min, float* __restrict__ out, int T_total,
                         int nh, int n_kv, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int qseg[kBQ];
  __shared__ int kseg[kBK];
  using TileT = Tile<kBQ, kBK, HD>;
  TileT tile(smem);
  const int qi = blockIdx.x, head = blockIdx.y;
  const int kvh = head / (nh / n_kv);
  const int q0 = qi * kBQ;
  auto q_row = [&](int r) -> long long {
    const int t = q0 + r;
    return t < T_total ? (static_cast<long long>(t) * nh + head) * HD : -1;
  };

  for (int r = threadIdx.x; r < kBQ; r += kThreads)
    qseg[r] = q0 + r < T_total ? seg[q0 + r] : -1;
  tile.init_stats();
  __syncthreads();
  bool any_row = false;
  for (int r = 0; r < kBQ; ++r) any_row |= qseg[r] >= 0;
  float acc[TileT::kAcc] = {};
  if (any_row) {
    tile.load_q(q, scale, [&](int r) -> long long {
      return qseg[r] >= 0 ? q_row(r) : -1;
    });
    const int kb_hi = min(q0 + kBQ - 1, T_total - 1) / kBK;
    for (int kb = kb_min[qi]; kb <= kb_hi; ++kb) {
      const int k0 = kb * kBK;
      for (int c = threadIdx.x; c < kBK; c += kThreads)
        kseg[c] = k0 + c < T_total ? seg[k0 + c] : -2;
      tile.load_kv(k, v, [&](int c) -> long long {
        const int t = k0 + c;
        return t < T_total ? (static_cast<long long>(t) * n_kv + kvh) * HD : -1;
      });
      tile.attend(acc, [&](int r, int c) {
        return qseg[r] >= 0 && qseg[r] == kseg[c] && k0 + c <= q0 + r;
      });
    }
  }
  // Rows that attended nothing (padding) have l == 0 and store zeros.
  tile.store(out, acc, q_row);
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const int* seg,
                       const int* kb_min, void* out, int T, int nh, int n_kv, float scale,
                       cudaStream_t stream) {
  auto kernel = flash_prefill_f32_kernel<HD>;
  const size_t smem = Tile<kBQ, kBK, HD>::kBytes;
  static const cudaError_t attr = allow_smem(kernel, smem);
  if (attr != cudaSuccess) return attr;
  const int nq = (T + kBQ - 1) / kBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, kb_min, static_cast<float*>(out), T, nh, n_kv, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kgct

// Tile sizes the wrapper must compute kb_min with.
extern "C" int kgct_flash_prefill_block_q() { return kgct::kBQ; }
extern "C" int kgct_flash_prefill_block_k() { return kgct::kBK; }

// dtype: 0 = float32, 1 = bfloat16. kb_min: [ceil(T/BQ)] first K tile of
// each q tile. Returns the CUDA status of the launch.
extern "C" int kgct_flash_prefill(const void* q, const void* k, const void* v,
                                  const int* seg_ids, const int* kb_min, void* out,
                                  int T_total, int nh, int n_kv, int hd, float scale,
                                  int dtype, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (T_total == 0) return cudaSuccess;
  if (dtype == 1 && hd == 128)
    return launch_mma<128>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv, scale, s);
  if (dtype == 1 && hd == 64)
    return launch_mma<64>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv, scale, s);
  if (dtype == 0 && hd == 128)
    return launch_f32<128>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv, scale, s);
  if (dtype == 0 && hd == 64)
    return launch_f32<64>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_flash_prefill_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
