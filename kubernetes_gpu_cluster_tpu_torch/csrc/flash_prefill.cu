// Ragged (segment-causal) flash prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill.py
// (flash_ragged_prefill, body _prefill_kernel): T flattened prompt tokens
// with segment ids, attention causal within each segment, GQA. Segments are
// contiguous and ascending, so the mask is
//     attend(q, k) <=> seg[q] == seg[k] && k <= q && seg[q] >= 0
// and padding rows (seg -1) emit zeros.
//
// Bound on the H100: operations at serving prefill sizes. A segment of n
// tokens costs ~2 * n^2 * hd * nh flops for n * hd * (nh + 2 n_kv) * 2 B of
// q/k/v, so past a few hundred tokens per segment the arithmetic, not the
// bytes, sets the floor.
//
// What the simple design does about it: one block per (q tile, q head)
// never materializes the [T, T] score matrix (O(T) memory, the point of
// flash attention), and it walks only the K tiles its rows can attend: from
// kb_min (the tile containing the segment start of the q tile's first row,
// computed by the wrapper exactly as the TPU kernel's window start) to the
// causal end. Blocks of other segments are never read. The arithmetic runs
// on fp32 CUDA cores; wgmma tensor-core tiles are later work.

#include "flash_tile.cuh"

namespace kgct {
namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg,
                     const int* __restrict__ kb_min, T* __restrict__ out,
                     int T_total, int nh, int n_kv, float scale) {
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg,
                   const int* kb_min, void* out, int T_total, int nh, int n_kv,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, HD>;
  const size_t smem = Tile<kBQ, kBK, HD>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (T_total + kBQ - 1) / kBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      seg, kb_min, static_cast<T*>(out), T_total, nh, n_kv, scale);
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
    return launch<__nv_bfloat16, 128>(q, k, v, seg_ids, kb_min, out, T_total, nh,
                                      n_kv, scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, seg_ids, kb_min, out, T_total, nh,
                                     n_kv, scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv,
                              scale, s);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, seg_ids, kb_min, out, T_total, nh, n_kv,
                             scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_flash_prefill_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
