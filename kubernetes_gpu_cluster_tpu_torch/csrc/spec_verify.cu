// Speculative-verification attention for Hopper (sm_90a): TMA page boxes
// into an mbarrier ring, fed by a producer warp, and every query of a
// (row, kv head) in one 64-row wgmma tile.
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
// Design (bf16, the served dtype). The work is a list of units: segment
// (row b, kv head h, query group grp) has ceil(n_tok / 64) history stages
// of 64 pooled keys and one slice stage, segments in (b, h, grp) order.
// The grid holds exactly the blocks the card keeps resident (one an SM,
// the wrapper's plan from the SM count and the occupancy API), and block
// c of the first P = min(grid, U) takes units [c U / P, (c + 1) U / P) of
// the U in all: every block reads the same bytes to within one stage, so
// a row of 2048 keys among rows of 512 leaves no tail. Every warp computes
// U and its block's first unit from ctx on the device, in a warp scan
// over the rows.
//
// A block is one producer warp and one consumer warpgroup (160 threads,
// up to 255 registers a thread; setmaxnreg needs whole warpgroups and
// would buy nothing here). The producer reads the row's page-table
// entries 32 at a time and loads each stage's K and V as TMA boxes into a
// ring of 7 stages (14 at hd 64; 224 KB, one block an SM): one box per
// page (or per 64-key piece of a larger page) and 64-column half, the
// 128-byte swizzle, completion counted on the slot's full mbarrier. TMA
// has no gather, so a stage of 64 keys at ps 16 and hd 128 is 16 boxes;
// the copies cost the producer one instruction each and the consumers
// nothing. The tensor map covers the whole stacked pool [L * P * ps,
// n_kv * hd]; the layer enters as a row offset. A map holds its pool's
// address, so the launch encodes the K and V maps from the pool pointers
// of each call (a captured launch keeps the pair it was given). The slice stage (S
// rows of this step's K and V) comes by cp.async. V rows no copy fills
// (past the stage's last page, past the slice) may hold anything; the
// producer zeroes them, since P is 0 there but 0 * NaN is not.
//
// The consumers hold the segment's M = S * g <= 64 queries as the 64 rows
// of one wgmma tile (registers, the m16n8k16 A layout; rows past M are 0);
// groups of 64 take M > 64 as further segments. Per stage: S = Q K^T as
// m64n64k16 products over hd, the fp32 online softmax in registers (keys
// past the history masked, branch-free: one warp a scheduler runs it, so
// every instruction's latency shows), P rounded to bf16 in registers as
// the A operand of O += P V (m64n{hd}k16, V read MN-major from the ring),
// then an arrive on the slot's empty mbarrier. The slice stage is the
// segment's last unit: scored and folded, with its causal mask, only by
// the block that holds it.
//
// A segment wholly inside one block is written from registers. A cut one
// (at most a block's first and last) leaves a partial (m, l, o) per block
// in the workspace, slot 2c for block c's first segment and 2c + 1 for its
// last. At its end each block counts itself on its cut segments' counters
// (one release-acquire atomic each), and the last to arrive merges the
// partials in block order (the same bits on every call), writes the output
// and resets the counter to 0. The wrapper allocates the workspace and
// counters; the kernel allocates nothing and never synchronizes with the
// host, so a call can be captured in a CUDA graph.
//
// What this design does about the first design's four limits (0.1385
// ms against a 0.0523 bound at R 32 x S 5 on the H100, PERF.md): (1) a
// two-stage cp.async ring, one stage in flight -> seven stages (224 KB),
// six in flight while one is used; (2) every thread computing a
// page-table address and a copy per 16 bytes -> one producer warp and
// one TMA box per page half; (3) M = 20 queries folded through two
// 16-row mma.sync tiles (the second with 4 live rows) -> every query in
// one 64-row wgmma tile, one pass per stage; (4) the in-slice block
// scored in every split block -> once per segment; and the rows' split
// in whole-row blocks -> an equal cut of units over the grid. On the H100
// the loads alone run at 82% of the bytes bound and the consumers keep up
// but for the ring's fill and drain (tools/verify_sweep.py; PERF.md).
//
// fp32 inputs (the tests and debug models) keep the CUDA-core tile of
// flash_tile.cuh: one block per (row, kv head, group of up to 64 queries)
// over 32-key tiles of the history, then one tile of the slice.

#include "flash_mma.cuh"
#include "flash_tile.cuh"
#include "hopper.cuh"

namespace kgct {
namespace {

using namespace sm90;

constexpr int kMaxS = 16;      // most queries per row
constexpr int kMaxGroup = 16;  // most query heads per kv head

// ---- bf16: TMA ring, producer warp, wgmma -----------------------------------

constexpr int kTile = 64;                      // query rows of the wgmma tile
constexpr int kSK = 64;                        // keys per stage
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kVThreads = kConsumers + 32;     // and the producer warp
constexpr int kRingBytes = 224 * 1024;        // K and V stages of one block, one block an SM
constexpr int kLine = 128;                     // bytes of one swizzled row: 64 bf16
constexpr int kAtom = 1024;                    // 8 lines: the swizzle's period
constexpr int kBarConsumers = 1;               // named barrier of the warpgroup

// Rows of one TMA box: a page, or a stage's 64-key piece of a larger page.
__host__ __device__ constexpr int box_rows(int ps) { return ps < kSK ? ps : kSK; }
// Boxes of K (and as many of V) a whole stage of keys takes: one per page
// piece and 64-column half of the head.
__host__ __device__ constexpr int stage_boxes(int ps, int hd) {
  return kSK / box_rows(ps) * (hd / 64);
}
// Ring slots: 7 stages at hd 128, 14 at hd 64.
__host__ __device__ constexpr int ring_stages(int hd) { return kRingBytes / (4 * kSK * hd); }
// The first pool row of `layer` in the map over the stacked pool.
__host__ __device__ constexpr long long layer_row(int layer, int P, int ps) {
  return static_cast<long long>(layer) * P * ps;
}
// Query groups of a (row, kv head): 64-row tiles over its M queries.
__host__ __device__ constexpr int tile_groups(int M) { return (M + kTile - 1) / kTile; }
// Units of one segment over n_tok pooled keys: its stages and the slice.
__host__ __device__ constexpr int seg_units(int n_tok) { return (n_tok + kSK - 1) / kSK + 1; }

template <int HD>
struct VSmem {
  static constexpr int kStages = ring_stages(HD);
  static constexpr int kHalf = kSK * kLine;        // a stage's 64-column half of K or V
  static constexpr int kKV = HD / 64 * kHalf;      // a stage's K (or V)
  static constexpr int kStage = 2 * kKV;           // K, then V
  static constexpr int kBarOff = kStages * kStage;  // full[kStages], empty[kStages]
  // + kAtom: the kernel aligns its base to an atom.
  static constexpr size_t kBytes = static_cast<size_t>(kBarOff) + 16 * kStages + kAtom;
  static_assert(kStages >= 3, "ring depth");
};

// d (+)= A (64 x 16: each warp's 16 rows as the m16n8k16 A fragment, in
// registers) * B (16 x 64, shared memory at descriptor db), fp32; with
// accumulate == 0 the product replaces d. TB: 0 when B is K-major (its 64
// rows hold k contiguously), 1 when MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// d (+)= A (64 x 16: each warp's 16 rows as the m16n8k16 A fragment, in
// registers) * B (16 x 128, shared memory at descriptor db), fp32; with
// accumulate == 0 the product replaces d. TB: 0 when B is K-major (its 128
// rows hold k contiguously), 1 when MN-major.
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TB));
}

// 2^x, one instruction (flushes results below 2^-126 to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The call's units, the same walk in every warp: rows in order, each row's
// n_kv * groups segments of seg_units(n_tok) units.
struct Call {
  const int* ctx;
  int R, segs, cap;  // rows, segments a row, pooled keys a table covers
};
__device__ __forceinline__ int pooled(const Call& c, int b) {
  return min(max(__ldg(c.ctx + b) - 1, 0), c.cap);
}
struct Walk {
  int b, seg, i;     // row, segment of the row (h * groups + grp), unit of the segment
  int n_tok, units;  // row b's pooled keys and units a segment
  long long start;   // the segment's first unit
  __device__ __forceinline__ void advance(const Call& c) {
    if (++i < units) return;
    i = 0;
    start += units;
    if (++seg < c.segs) return;
    seg = 0;
    if (++b < c.R) {
      n_tok = pooled(c, b);
      units = seg_units(n_tok);
    }
  }
};
// Every lane: the call's units U.
__device__ long long total_units(const Call& c) {
  const int lane = threadIdx.x % 32;
  long long U = 0;
  for (int b0 = 0; b0 < c.R; b0 += 32) {
    const int b = b0 + lane;
    U += __reduce_add_sync(0xffffffffu,
                           b < c.R ? static_cast<unsigned>(c.segs * seg_units(pooled(c, b))) : 0u);
  }
  return U;
}
// Every lane: the walk at unit u < U.
__device__ Walk locate(const Call& c, long long u) {
  const int lane = threadIdx.x % 32;
  long long base = 0;
  for (int b0 = 0;; b0 += 32) {
    const int b = b0 + lane;
    const int nt = b < c.R ? pooled(c, b) : 0;
    const int ru = b < c.R ? c.segs * seg_units(nt) : 0;
    int incl = ru;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, b < c.R && base + incl > u);
    if (hit) {
      const int L = __ffs(hit) - 1;
      Walk w;
      w.b = b0 + L;
      w.n_tok = __shfl_sync(0xffffffffu, nt, L);
      w.units = seg_units(w.n_tok);
      const long long row0 =
          base + __shfl_sync(0xffffffffu, incl, L) - __shfl_sync(0xffffffffu, ru, L);
      w.seg = static_cast<int>((u - row0) / w.units);
      w.i = static_cast<int>((u - row0) % w.units);
      w.start = row0 + static_cast<long long>(w.seg) * w.units;
      return w;
    }
    base += __shfl_sync(0xffffffffu, incl, 31);
  }
}
// A segment cut at a block's edge: its first unit and units, row, segment
// of the row, and whether this block was the last of its contributors.
struct Cut {
  long long start;
  int units, b, seg, last;
};
// Block c's first unit of U over P blocks, and the block that holds unit u.
__device__ __forceinline__ long long unit_lo(long long U, int P, int c) { return U * c / P; }
__device__ __forceinline__ int block_of(long long U, int P, long long u) {
  return static_cast<int>(((u + 1) * P - 1) / U);
}

template <int HD>
__global__ void __launch_bounds__(kVThreads, 1)
spec_verify_kernel(const __nv_bfloat16* __restrict__ q, const int* __restrict__ tables,
                   const int* __restrict__ ctx, const __nv_bfloat16* __restrict__ knew,
                   const __nv_bfloat16* __restrict__ vnew, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ ws, int* __restrict__ counters, int R, int S, int nh,
                   int n_kv, int groups, int ps_shift, int pps, int row0, float scale_log2,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap) {
  using Sm = VSmem<HD>;
  constexpr int kStages = Sm::kStages;
  constexpr int kHalves = HD / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Cut cuts[2];  // the consumers' cut segments, thread 0's records
  // The swizzle follows address bits 4-9: the ring starts 1024-aligned.
  unsigned char* ring =
      smem_raw + ((kAtom - (mma::smem_addr(smem_raw) & (kAtom - 1))) & (kAtom - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + Sm::kBarOff);
  uint64_t* empty = full + kStages;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ps = 1 << ps_shift, g = nh / n_kv, M = S * g;
  const Call call{ctx, R, n_kv * groups, pps * ps};
  const long long U = total_units(call);
  // Blocks past U take nothing; the others at least one unit each.
  const int P = static_cast<int>(min(static_cast<long long>(gridDim.x), U)), blk = blockIdx.x;
  if (blk >= P) return;  // the same in every thread
  const long long lo = unit_lo(U, P, blk), hi = unit_lo(U, P, blk + 1);
  // The workspace: each slot's o [kTile][HD], then each slot's (m, l) [kTile][2].
  const long long ws_ml = 2ll * gridDim.x * kTile * HD;
  const int n_units = static_cast<int>(hi - lo);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are set up before anyone uses them
  Walk w = locate(call, lo);

  // V rows [from, kSK) of a stage that no copy fills may hold anything (a
  // slot's first use, an earlier stage); P is 0 there, but 0 * NaN is not,
  // so the producer zeroes them before it arms the slot. K's are masked.
  auto zero_v_rows = [](unsigned char* vs, int from, int lane) {
    for (int c = lane; c < (kSK - from) * (HD / 8); c += 32) {
      const int r = from + c / (HD / 8), ch = c % (HD / 8);
      *reinterpret_cast<uint4*>(vs + (ch / 8) * Sm::kHalf + r * kLine + (ch % 8) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_async_smem();
  };

  if (warp == kConsumerWarps) {  // ---- the producer warp
    const int br = box_rows(ps);
    int win = 0, tab = 0, tab_seg = -1;  // table entries win .. win + 31 of row w.b, one a lane
    for (int j = 0; j < n_units; ++j, w.advance(call)) {
      const int slot = j % kStages;
      if (j >= kStages) mbar_wait(empty + slot, (j / kStages - 1) & 1);
      unsigned char* ks = ring + slot * Sm::kStage;
      const int h = w.seg / groups;
      if (w.i + 1 < w.units) {  // pooled keys [k0, k0 + valid) of row w.b
        const int k0 = w.i * kSK, valid = min(kSK, w.n_tok - k0);
        const int pieces = (valid + br - 1) / br;
        const int p0 = k0 >> ps_shift, p1 = (k0 + valid - 1) >> ps_shift;
        const int seg_id = w.b * call.segs + w.seg;
        if (seg_id != tab_seg || p0 < win || p1 >= win + 32) {
          tab_seg = seg_id;
          win = p0;
          tab = win + lane < pps ? __ldg(tables + static_cast<long long>(w.b) * pps + win + lane)
                                 : 0;
        }
        const int nbox = pieces * kHalves * 2;
        zero_v_rows(ks + Sm::kKV, pieces * br, lane);
        if (lane == 0) mbar_expect_tx(full + slot, nbox * br * kLine);
        __syncwarp();
        // Lane -> (piece x, K or V, half): box rows key .. key + br - 1.
        const int x = lane / (2 * kHalves), kv = (lane / kHalves) & 1, half = lane % kHalves;
        const int key = k0 + x * br;
        const int page = __shfl_sync(0xffffffffu, tab, ((key >> ps_shift) - win) & 31);
        if (lane < nbox)
          tma_load_2d(ks + kv * Sm::kKV + half * Sm::kHalf + x * br * kLine, kv ? &vmap : &kmap,
                      h * HD + half * 64, row0 + (page << ps_shift) + (key & (ps - 1)),
                      full + slot);
      } else {  // the slice: this step's S keys and values of head h
        constexpr int kCh = HD / 8;  // 16-byte chunks a row
        const long long tok0 = static_cast<long long>(w.b) * S;
        for (int c = lane; c < 2 * S * kCh; c += 32) {
          const int kv = c / (S * kCh), t = (c / kCh) % S, ch = c % kCh;
          mma::cp_async16(ks + kv * Sm::kKV + (ch / 8) * Sm::kHalf + t * kLine +
                              (((ch % 8) ^ (t % 8)) * 16),
                          (kv ? vnew : knew) + ((tok0 + t) * n_kv + h) * HD + ch * 8, true);
        }
        mma::cp_async_commit();
        zero_v_rows(ks + Sm::kKV, S, lane);
        mma::cp_async_wait<0>();
        fence_async_smem();
        __syncwarp();
        if (lane == 0) mbar_arrive(full + slot);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows 16 warp + gid and + 8 of the tile
  const int gid = lane / 4, tig = lane % 4;
  constexpr int kO = HD / 2, kS = kSK / 2;  // accumulators a thread: 64 x HD, 64 x kSK
  float o[kO], s[kS], m[2], l[2];
  uint32_t qa[HD / 16][4];  // Q, the A fragments of S = Q K^T
  uint32_t pa[kSK / 16][4];  // P, bf16, the A fragments of O += P V
  long long qoff[2];  // element offset of each row's query (and output) row
  int srow[2];        // each row's slice token
  bool qok[2];        // the row holds a query
  int n_cut = 0;      // segments cut at this block's edges, counted in at its end
#pragma unroll
  for (int i = 0; i < kO; ++i) o[i] = 0.f;
  for (int j = 0; j < n_units; ++j, w.advance(call)) {
    const int slot = j % kStages;
    const int h = w.seg / groups, grp = w.seg % groups;
    // A segment starts: its queries, a fresh state (its first P V replaces
    // o).
    const bool fresh = j == 0 || w.i == 0;
    if (fresh) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = grp * kTile + 16 * warp + gid + 8 * e;
        qok[e] = x < M;
        srow[e] = x / g;
        qoff[e] = ((static_cast<long long>(w.b) * S + x / g) * nh + h * g + x % g) * HD;
        m[e] = -INFINITY;
        l[e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = r & 1, col = 16 * kk + 2 * tig + 8 * (r >> 1);
          qa[kk][r] =
              qok[e] ? __ldg(reinterpret_cast<const unsigned*>(q + qoff[e] + col)) : 0u;
        }
    }
    mbar_wait(full + slot, (j / kStages) & 1);
    const bool slice = w.i + 1 == w.units;
    const unsigned char* ks = ring + slot * Sm::kStage;
    // Scores: K is K-major in the ring, its 64-column halves kHalf apart;
    // the k step kk starts 32 bytes into a line.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<0>(s, qa[kk], wgmma_desc(ks + (kk / 4) * Sm::kHalf + (kk % 4) * 32, 16, kAtom),
                  kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    // Register i holds row 8 ((i / 2) % 2) of the thread's two, key
    // 8 (i / 4) + 2 tig + i % 2. Online softmax in the log2 domain. Keys
    // [0, lim) of each row count: the stage's pooled keys, or the slice's
    // tokens up to the row's own. One warp a scheduler runs this, so it
    // stays branch-free: every instruction's latency shows.
    const int valid = slice ? S : min(kSK, w.n_tok - w.i * kSK);
    int lim[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) lim[e] = slice ? min(srow[e] + 1, S) : valid;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      const int c = 8 * (i / 4) + 2 * tig + (i & 1), e = (i >> 1) & 1;
      s[i] = c < lim[e] ? s[i] * scale_log2 : -INFINITY;
      mx[e] = fmaxf(mx[e], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
      mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
      alpha[e] = ex2(m[e] - mx[e]);  // every row has a key: mx is finite
      m[e] = mx[e];
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      s[i] = ex2(s[i] - m[(i >> 1) & 1]);
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int kk = 0; kk < kSK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[kk][r] = mma::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] *= alpha[(i >> 1) & 1];
    // O += P V: V is MN-major in the ring, 64-column halves kHalf apart
    // (leading), 8-key atoms kAtom apart (stride); the k step kk starts at
    // atom 2 kk. Waited for here: products left running into the next
    // stage's scores made ptxas serialize every wgmma, and ran slower.
    const unsigned char* vs = ks + Sm::kKV;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSK / 16; ++kk)
      wgmma_rs<1>(o, pa[kk], wgmma_desc(vs + kk * 2 * kAtom, Sm::kHalf, kAtom),
                  kk > 0 || !fresh);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
#pragma unroll
    for (int kk = 0; kk < kSK / 16; ++kk) fence_operands(pa[kk]);  // live until the wait
    if (lane == 0) mbar_arrive(empty + slot);
    if (!slice && j + 1 < n_units) continue;

    // ---- the segment ends in this block
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
      l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    }
    if (w.start >= lo && w.start + w.units <= hi) {  // whole here: out = o / l
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!qok[e]) continue;
        const float inv = 1.f / l[e];
#pragma unroll
        for (int jn = 0; jn < HD / 8; ++jn)
          *reinterpret_cast<__nv_bfloat162*>(out + qoff[e] + 8 * jn + 2 * tig) =
              __floats2bfloat162_rn(o[4 * jn + 2 * e] * inv, o[4 * jn + 2 * e + 1] * inv);
      }
      continue;
    }
    // Cut: this block's partial into its slot (2 blk for its first
    // segment, 2 blk + 1 for its last), counted in at the block's end.
    const int sl = 2 * blk + (lo >= w.start ? 0 : 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (!qok[e]) continue;
      const int r = 16 * warp + gid + 8 * e;
      float* po = ws + (static_cast<long long>(sl) * kTile + r) * HD;
#pragma unroll
      for (int jn = 0; jn < HD / 8; ++jn)
        __stcg(reinterpret_cast<float2*>(po + 8 * jn + 2 * tig),
               make_float2(o[4 * jn + 2 * e], o[4 * jn + 2 * e + 1]));
      if (tig == 0)
        __stcg(reinterpret_cast<float2*>(ws + ws_ml + (static_cast<long long>(sl) * kTile + r) * 2),
               make_float2(m[e], l[e]));
    }
    if (tid == 0) cuts[n_cut] = Cut{w.start, w.units, w.b, w.seg, 0};
    ++n_cut;
  }
  if (n_cut == 0) return;

  // Every thread's partials, then the barrier, before thread 0's releases;
  // the acquire side of the same atomics, then the barrier, before a merge
  // reads every contributor's partial. A contributor's range holds units,
  // so blocks b_first .. b_last each left one partial.
  __threadfence();
  bar_sync(kBarConsumers, kConsumers);
  if (tid == 0)
    for (int k = 0; k < n_cut; ++k) {
      const Cut& c = cuts[k];
      const long long seg_id = static_cast<long long>(c.b) * call.segs + c.seg;
      const int n = block_of(U, P, c.start + c.units - 1) - block_of(U, P, c.start) + 1;
      int seen;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(seen)
                   : "l"(counters + seg_id)
                   : "memory");
      cuts[k].last = seen == n - 1;
      if (seen == n - 1) counters[seg_id] = 0;  // every contributor has counted: reset
    }
  bar_sync(kBarConsumers, kConsumers);
  for (int k = 0; k < n_cut; ++k) {
    const Cut c = cuts[k];
    if (!c.last) continue;
    // The last to arrive merges the partials in block order (the same bits
    // every call): partial row r of block b_first is in its slot 2 b_first
    // + 1 when its range starts before the segment, every other in 2 b.
    const int h = c.seg / groups, grp = c.seg % groups;
    const int b_first = block_of(U, P, c.start), b_last = block_of(U, P, c.start + c.units - 1);
    const int first_odd = unit_lo(U, P, b_first) < c.start;
    const int n4 = min(kTile, M - grp * kTile) * (HD / 4);
    const long long tok0 = static_cast<long long>(c.b) * S;
    constexpr int kBatch = 8;  // elements of 4 a thread in flight
    for (int e0 = tid; e0 < n4; e0 += kBatch * kConsumers) {
      float mm[kBatch], ll[kBatch];
      float4 oo[kBatch];
#pragma unroll
      for (int k2 = 0; k2 < kBatch; ++k2) {
        mm[k2] = -INFINITY;
        ll[k2] = 0.f;
        oo[k2] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int b = b_first; b <= b_last; ++b) {
        const long long row0 = (2ll * b + (b == b_first ? first_odd : 0)) * kTile;
        float2 ml[kBatch];
        float4 o2[kBatch];
#pragma unroll
        for (int k2 = 0; k2 < kBatch; ++k2) {  // every load of this partial, then the math
          const int e4 = e0 + k2 * kConsumers;
          if (e4 >= n4) continue;
          const long long r = row0 + e4 / (HD / 4);
          ml[k2] = __ldcg(reinterpret_cast<const float2*>(ws + ws_ml + r * 2));
          o2[k2] = __ldcg(reinterpret_cast<const float4*>(ws + r * HD + (e4 % (HD / 4)) * 4));
        }
#pragma unroll
        for (int k2 = 0; k2 < kBatch; ++k2) {
          if (e0 + k2 * kConsumers >= n4) continue;
          const float mn = fmaxf(mm[k2], ml[k2].x);  // ml.x is finite: a partial has a key
          const float a = ex2(mm[k2] - mn), bb = ex2(ml[k2].x - mn);
          ll[k2] = ll[k2] * a + ml[k2].y * bb;
          oo[k2] = make_float4(oo[k2].x * a + o2[k2].x * bb, oo[k2].y * a + o2[k2].y * bb,
                               oo[k2].z * a + o2[k2].z * bb, oo[k2].w * a + o2[k2].w * bb);
          mm[k2] = mn;
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < kBatch; ++k2) {
        const int e4 = e0 + k2 * kConsumers;
        if (e4 >= n4) continue;
        const int x = grp * kTile + e4 / (HD / 4), d = (e4 % (HD / 4)) * 4;
        const float inv = 1.f / ll[k2];
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            out + ((tok0 + x / g) * nh + h * g + x % g) * HD + d);
        dst[0] = __floats2bfloat162_rn(oo[k2].x * inv, oo[k2].y * inv);
        dst[1] = __floats2bfloat162_rn(oo[k2].z * inv, oo[k2].w * inv);
      }
    }
  }
}

// ---- fp32: CUDA cores (flash_tile.cuh) --------------------------------------

// Queries an fp32 block holds for M queries per (row, kv head): 16, 32 or
// 64. The wrapper mirrors it (ops/cuda/spec_verify.py).
__host__ __device__ inline int block_rows(int M) { return M <= 16 ? 16 : M <= 32 ? 32 : 64; }

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
  int R, S, nh, n_kv, hd, ps, pps;
  int pages;          // P: pages of one layer of the pool
  int layers;         // L of a stacked pool, 1 for a one-layer pool
  int dtype;          // 0 = float32, 1 = bfloat16
  int blocks;         // bf16: the grid, the blocks the card keeps resident
  float scale;
};

// The wrapper's host mirrors check these at load (ops/cuda/spec_verify.py).
extern "C" int kgct_spec_verify_stage_keys() { return kgct::kSK; }
extern "C" int kgct_spec_verify_tile_rows() { return kgct::kTile; }
extern "C" int kgct_spec_verify_max_s() { return kgct::kMaxS; }
extern "C" int kgct_spec_verify_stages(int hd) { return kgct::ring_stages(hd); }
extern "C" int kgct_spec_verify_box_rows(int ps) { return kgct::box_rows(ps); }
extern "C" int kgct_spec_verify_stage_boxes(int ps, int hd) { return kgct::stage_boxes(ps, hd); }
extern "C" long long kgct_spec_verify_layer_row(int layer, int P, int ps) {
  return kgct::layer_row(layer, P, ps);
}
extern "C" int kgct_spec_verify_tile_groups(int M) { return kgct::tile_groups(M); }
extern "C" int kgct_spec_verify_seg_units(int n_tok) { return kgct::seg_units(n_tok); }
// Queries of one fp32 block for M queries per (row, kv head).
extern "C" int kgct_spec_verify_block_rows(int M) { return kgct::block_rows(M); }

namespace kgct {
namespace {

using VerifyKernel = void (*)(const __nv_bfloat16*, const int*, const int*, const __nv_bfloat16*,
                              const __nv_bfloat16*, __nv_bfloat16*, float*, int*, int, int, int,
                              int, int, int, int, int, float, const CUtensorMap,
                              const CUtensorMap);

// The bf16 kernel of head dim hd, its shared-memory cap raised once per
// process; null if that failed or hd is not served.
VerifyKernel verify_kernel(int hd, size_t* smem) {
  static const bool ok =
      allow_smem(spec_verify_kernel<128>, VSmem<128>::kBytes) == cudaSuccess &&
      allow_smem(spec_verify_kernel<64>, VSmem<64>::kBytes) == cudaSuccess;
  if (!ok) return nullptr;
  if (hd == 128) {
    *smem = VSmem<128>::kBytes;
    return spec_verify_kernel<128>;
  }
  if (hd == 64) {
    *smem = VSmem<64>::kBytes;
    return spec_verify_kernel<64>;
  }
  return nullptr;
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

// Blocks of the bf16 kernel of head dim hd one SM keeps resident (the
// occupancy API at its shared memory); a negative CUDA status on error.
extern "C" int kgct_spec_verify_resident(int hd) {
  size_t smem = 0;
  const kgct::VerifyKernel k = kgct::verify_kernel(hd, &smem);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, kgct::kVThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Pool pointers address the whole pool [(L,) P, ps, n_kv*hd], `layer` its
// layer (0 for a one-layer pool); q / k_new / v_new and out are [R*S,
// heads, hd]. bf16 reads the pool through a K and a V tensor map encoded
// here from the pool pointers: each over the stacked pool's layers * P *
// ps rows of n_kv * hd elements, a box of 64 columns by box_rows(ps) rows.
// The wrapper has checked the shapes and planned the grid. bf16 takes the
// call's workspace (2 * blocks * 64 * (hd + 2) floats) and counters (R *
// groups * n_kv ints, all 0, left all 0) as arguments, never from the
// launch record that every call of one key shares. Returns the CUDA
// status of the launch.
extern "C" int kgct_spec_verify(const void* q, const void* k_pool, const void* v_pool,
                                const int* page_tables, const int* context_lens,
                                const void* k_new, const void* v_new, void* out, float* ws,
                                int* counters, const SpecVerifyLaunch* a, int layer,
                                void* stream) {
  using namespace kgct;
  auto s = static_cast<cudaStream_t>(stream);
  if (a->R == 0) return cudaSuccess;
  const int g = a->n_kv > 0 ? a->nh / a->n_kv : 0;
  if (g < 1 || g > kMaxGroup || a->nh != g * a->n_kv || a->S < 1 || a->S > kMaxS ||
      a->ps <= 0 || (a->ps & (a->ps - 1)) || a->pps < 1 || layer < 0)
    return cudaErrorInvalidValue;
  if (a->dtype == 1) {
    size_t smem = 0;
    const VerifyKernel kernel = verify_kernel(a->hd, &smem);
    if (kernel == nullptr || a->blocks < 1 || a->layers < 1 || ws == nullptr ||
        counters == nullptr)
      return cudaErrorInvalidValue;
    const int kd = a->n_kv * a->hd;
    const uint64_t rows = uint64_t(a->layers) * a->pages * a->ps;
    CUtensorMap m[2];
    for (int i = 0; i < 2; ++i)
      if (!sm90::encode_map(&m[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, i ? v_pool : k_pool, kd,
                            rows, 2ull * kd, 64, box_rows(a->ps)))
        return cudaErrorInvalidValue;
    kernel<<<a->blocks, kVThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), page_tables, context_lens,
        static_cast<const __nv_bfloat16*>(k_new), static_cast<const __nv_bfloat16*>(v_new),
        static_cast<__nv_bfloat16*>(out), ws, counters, a->R, a->S, a->nh, a->n_kv,
        tile_groups(a->S * g), ilog2(a->ps), a->pps,
        static_cast<int>(layer_row(layer, a->pages, a->ps)), a->scale * 1.4426950408889634f,
        m[0], m[1]);
    return cudaGetLastError();
  }
  if (a->dtype == 0) {
    const long long off = layer_row(layer, a->pages, a->ps) * a->n_kv * a->hd;
    const float* kp = static_cast<const float*>(k_pool) + off;
    const float* vp = static_cast<const float*>(v_pool) + off;
    if (a->hd == 128)
      return dispatch_f32<128>(*a, q, kp, vp, page_tables, context_lens, k_new, v_new, out, s);
    if (a->hd == 64)
      return dispatch_f32<64>(*a, q, kp, vp, page_tables, context_lens, k_new, v_new, out, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* kgct_spec_verify_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
