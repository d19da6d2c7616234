// Chunked-prefill history attention for Hopper (sm_90a).
//
// Replaces the TPU kernel
// kubernetes_gpu_cluster_tpu/ops/pallas/flash_prefill_hist.py
// (flash_prefill_history, body _hist_kernel): one sequence's prompt chunk of
// T tokens attends fully to its hist_len tokens already committed to the
// paged pool (through its page table), then causally within the chunk.
// Tail padding is cut at n_valid = sum(seg >= 0); padding rows emit zeros.
//
// Bound on the H100: operations once the chunk is a few hundred tokens
// (T * (hist_len + T/2) * hd * nh * 4 flops against hist_len * n_kv*hd * 4 B
// of history); bytes for short chunks over long histories.
//
// What the simple design does about it: one block per (q tile, q head)
// streams the history in two phases through one fp32 online softmax —
// phase 1 gathers only the ceil(hist_len/ps) valid pages' rows (masking
// col < hist_len), phase 2 walks the chunk's K tiles up to the causal end
// (masking col <= row && col < n_valid). Tiles made only of padding rows
// skip both phases. The iota selector matmuls and host-side lane
// flattening of the TPU kernel were Mosaic workarounds and have no place
// here; tensor-core tiles are later work.

#include "flash_tile.cuh"

namespace kgct {
namespace {

constexpr int kBQ = 32;
constexpr int kBK = 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_hist_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ kpool,
                          const T* __restrict__ vpool, const int* __restrict__ table,
                          const int* __restrict__ n_valid_ptr, T* __restrict__ out,
                          int T_total, int nh, int n_kv, int ps, int pps,
                          int hist_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  using TileT = Tile<kBQ, kBK, HD>;
  TileT tile(smem);
  const int qi = blockIdx.x, head = blockIdx.y;
  const int kvh = head / (nh / n_kv);
  const int q0 = qi * kBQ;
  const long long kd = static_cast<long long>(n_kv) * HD;
  const int n_valid = min(*n_valid_ptr, T_total);
  const int hist = min(hist_len, pps * ps);
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
    for (int t0 = 0; t0 < hist; t0 += kBK) {
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
    const int kb_hi = min(q0 + kBQ - 1, n_valid - 1) / kBK;
    for (int kb = 0; kb <= kb_hi; ++kb) {
      const int k0 = kb * kBK;
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

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* kp,
                   const void* vp, const int* table, const int* n_valid, void* out,
                   int T_total, int nh, int n_kv, int ps, int pps, int hist_len,
                   float scale, cudaStream_t stream) {
  auto kernel = flash_prefill_hist_kernel<T, HD>;
  const size_t smem = Tile<kBQ, kBK, HD>::kBytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nq = (T_total + kBQ - 1) / kBQ;
  kernel<<<dim3(nq, nh), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(kp), static_cast<const T*>(vp), table, n_valid,
      static_cast<T*>(out), T_total, nh, n_kv, ps, pps, hist_len, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace kgct

// dtype: 0 = float32, 1 = bfloat16. Pool pointers address ONE layer
// [P, ps, n_kv*hd]; n_valid is a device int32 scalar. Returns the CUDA
// status of the launch.
extern "C" int kgct_flash_prefill_hist(const void* q, const void* k, const void* v,
                                       const void* k_pool, const void* v_pool,
                                       const int* page_table, const int* n_valid,
                                       void* out, int T_total, int nh, int n_kv,
                                       int hd, int ps, int pps, int hist_len,
                                       float scale, int dtype, void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (T_total == 0) return cudaSuccess;
  if (dtype == 1 && hd == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, k_pool, v_pool, page_table, n_valid,
                                      out, T_total, nh, n_kv, ps, pps, hist_len,
                                      scale, s);
  if (dtype == 1 && hd == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, k_pool, v_pool, page_table, n_valid,
                                     out, T_total, nh, n_kv, ps, pps, hist_len,
                                     scale, s);
  if (dtype == 0 && hd == 128)
    return launch<float, 128>(q, k, v, k_pool, v_pool, page_table, n_valid, out,
                              T_total, nh, n_kv, ps, pps, hist_len, scale, s);
  if (dtype == 0 && hd == 64)
    return launch<float, 64>(q, k, v, k_pool, v_pool, page_table, n_valid, out,
                             T_total, nh, n_kv, ps, pps, hist_len, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_flash_prefill_hist_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
