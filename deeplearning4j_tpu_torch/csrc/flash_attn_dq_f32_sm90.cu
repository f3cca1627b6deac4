// flash_attn_dq_f32_sm90.cu — FlashAttention-2 backward dq for float32
// inputs with head dim D <= 64 on Hopper's tensor cores (sm_90a), every
// product accurate to float32 by a split into TF32 parts. float32 with
// D > 64 keeps the CUDA-core kernel of flash_attn_bwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_dq_kernel`
// (pallas_call in `_flash_bwd`) for float32 — which on the TPU takes
// Mosaic's multi-pass float32 MXU path — with the contract of
// `dl4j_flash_attn_dq`: q, k, v, dO (BH, T, D) row-major; the forward's lse
// and Δ = rowsum(dO·O) (BH, Tq) in float32; the key mask, the
// START-aligned causal mask and the dropout keep hash (flash_common.cuh
// `keep_element`) of the forward; dq (BH, Tq, D) in float32. With
// P = exp(S·scale - lse), dP = dO·Vᵀ after dropout and dS = P⊙(dP - Δ):
// dq = scale · dS·K.
//
// Numerics: never single-pass TF32. Each operand is split as hi =
// tf32(v), lo = tf32(v - hi) (sm90.cuh `tf32_split`) and each product is
// lo·hi + hi·lo + hi·hi, the small passes first. dS stays float32 (no
// 16-bit rounding: the TPU's `_mm` keeps float32 × float32 in float32)
// and is split in registers; the scale multiplies the float32 sum once.
// The check is the float32 one (1e-4 + 1e-5·|plain|), which one TF32 pass
// breaks.
//
// What bounds it on the H100: 6·D operations per visible (query, key)
// pair, three TF32 passes each (494.7 TFLOP/s dense TF32, so 165 TFLOP/s
// of float32 products): 9.7 GFLOP at BH 96 × T 512, D 64, against one read
// of q, k, v, dO and one write of dq (~63 MB): the tensor cores are the
// limit there; at BERT's T 128 with ragged keys the bytes are.
//
// Design (flash_attn_dq_sm90.cu's skeleton, with the float32 forward's
// split):
//  * TF32 wgmma reads shared-memory operands K-major only. S = Q·Kᵀ and
//    dP = dO·Vᵀ contract over D, along which all four are contiguous;
//    dQ += dS·K contracts over keys, along which K is not. So the kernel
//    reads K's transposed tile Kᵀ (D × 32 keys), keys permuted 0, 2, 4, 6,
//    1, 3, 5, 7 within each group of 8: dS's accumulator registers are
//    then the TF32 A fragment without a shuffle (sm90.cuh `tf32_a_col`).
//    Kᵀ is written in shared memory from the landed K tile
//    (flash_f32.cuh `split_rows`), as its parts are: a first design wrote
//    it (BH, D, Tp) with a pre-pass kernel and loaded it by TMA, which
//    cost more at BERT's T 128 (PERF.md).
//  * One block owns 128 query rows of one batch·head: two consumer
//    warpgroups of 64 rows and a producer warpgroup (setmaxnreg 40 / 232).
//    Grid (⌈Tq/128⌉, BH).
//  * Shared memory (227 KB): Q and dO in two parts each take 128 KB; a
//    stage of 32 keys holds K, V and Kᵀ in two parts (48 KB), two stages.
//    The producer's first warp loads Q and dO once and streams K and V
//    tiles with TMA (3-D tensor maps: rows past T and columns past D read
//    as zeros) into the hi parts, completed on a `full` mbarrier; its
//    other three warps split each landed tile in place (lo beside, Kᵀ's
//    parts after), fence.proxy.async and arrive on a `ready` one; the
//    consumers release the stage on an `empty` one. So the split of the
//    next tile runs while the consumers compute this one, and the two
//    warpgroups need no barrier between them (a design where the
//    consumers split each tile themselves, behind a barrier of both, was
//    slower: PERF.md).
//  * Per tile: S and dP (64 rows × 32 keys) from shared memory, three
//    passes each; the scale, masks, P, the keep hash and dS on the
//    accumulator registers (lse_i and Δ_i per row, held in registers; the
//    key mask per column); dS split in registers and handed over as the A
//    operand of dS·K against Kᵀ's parts, summed from zero each tile and
//    added to dq's float32 sum on the CUDA cores: one accumulator through
//    every tile lost about a unit of the sum per wgmma addition in the
//    tensor cores, as the float32 matmul's did (PERF.md).
//  * Key tiles whose 32 keys are all masked are skipped, by producer and
//    consumers alike (a warp vote on the mask), when every row of the
//    block sees an unmasked key (with the causal mask: one at or below the
//    block's first row): their p is then exactly 0 (flash_f32.cuh
//    `can_skip_masked`). BERT's ragged rows (16…128 keys) skip ~40%.
//  * Causal: the block's key loop ends at its last query row, and a
//    warpgroup stops at its own. Keys past Tk weigh 0. A row whose keys
//    are all masked gets the finite values of the -1e30 fill, as the plain
//    version.
//  * Every dq element is written once, by one thread: no atomics, and the
//    gradient is the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "sm90.cuh"

namespace {

using flash::keep_element;
using flash::kMasked;
using flash_f32::split_chunks;
using sm90::WgmmaTf32;

constexpr int kRows = 128;                  // query rows a block (2 WGs)
constexpr int kKeys = 32;                   // keys a tile: one span of Kᵀ
constexpr int kStages = 2;
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kSplitters = 96;              // producer threads that split
constexpr int kProducerRegs = 40;           // 128 x 40 + 256 x 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kSpan = 32;                   // float32 values a 128-byte row
constexpr int DP = 64;                      // the head dim, padded
constexpr int kSpansD = DP / kSpan;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte boundary: Q_hi, dO_hi (where TMA lands Q
// and dO), Q_lo, dO_lo; then the stages, each K_hi, V_hi (where TMA lands
// the tiles), Kᵀ_hi, K_lo, V_lo, Kᵀ_lo.
constexpr uint32_t kQSpan = kRows * 128;            // 16 KB
constexpr uint32_t kQ = kSpansD * kQSpan;           // Q or dO, one part
constexpr uint32_t kPart = kSpansD * kKeys * 128;   // a K or V tile, one part
static_assert(kPart == (kKeys / kSpan) * DP * 128, "a Kᵀ tile is as large");
constexpr uint32_t kStage = 6 * kPart;
constexpr uint32_t kSmem = 4 * kQ + kStages * kStage + 1024;

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_f32_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const float* __restrict__ mask,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ seed, float* __restrict__ dq,
                  int tq, int tk, int d, float scale, int causal, float rate,
                  float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic view of `base`
  const uint32_t sq = base;            // Q_hi
  const uint32_t sdo = base + kQ;      // dO_hi
  const uint32_t sql = base + 2 * kQ;  // Q_lo
  const uint32_t sdol = base + 3 * kQ; // dO_lo
  const uint32_t sring = base + 4 * kQ;
  const uint32_t bar_q = sm90::smem_u32(&bars[0]);
  auto full = [&](int s) { return sm90::smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[1 + kStages + s]); };
  auto ready = [&](int s) {
    return sm90::smem_u32(&bars[1 + 2 * kStages + s]);
  };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
      sm90::mbar_init(ready(s), kSplitters);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // causal: no row of this block sees keys past its last row
  const int q_last = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;
  const int lane = tid % 32;
  const float* mrow = mask ? mask + (size_t)bh * tk : nullptr;
  // every warp walks the tiles and votes on which it skips (kKeys = 32);
  // causal: only if every row of the block sees an unmasked key, that is
  // one at or below its first row
  const bool skip_masked = flash_f32::can_skip_masked(
      mrow, causal ? min(tk, q0 + 1) : tk, lane);
  auto tile_on = [&](int j) {
    return !skip_masked || flash_f32::keys_on(mrow, j * kKeys, tk, lane);
  };

  if (tid >= kConsumers) {  // the producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid < kConsumers + 32) {  // its first warp: one thread issues TMA
      const bool leader = tid == kConsumers;
      if (leader) {
        sm90::mbar_arrive_expect_tx(bar_q, 2 * kQ);
        for (int sp = 0; sp < kSpansD; ++sp) {
          sm90::tma_load_3d(sq + sp * kQSpan, &tm_q, bar_q, sp * kSpan, q0,
                            bh);
          sm90::tma_load_3d(sdo + sp * kQSpan, &tm_do, bar_q, sp * kSpan,
                            q0, bh);
        }
      }
      for (int j = 0, it = 0; j < n_tiles; ++j) {
        if (!tile_on(j)) continue;
        const int s = it % kStages;
        if (it >= kStages) sm90::mbar_wait(empty(s), (it / kStages - 1) & 1);
        if (leader) {
          sm90::mbar_arrive_expect_tx(full(s), 2 * kPart);
          const uint32_t st = sring + s * kStage;
          for (int sp = 0; sp < kSpansD; ++sp) {
            sm90::tma_load_3d(st + sp * kKeys * 128, &tm_k, full(s),
                              sp * kSpan, j * kKeys, bh);
            sm90::tma_load_3d(st + kPart + sp * kKeys * 128, &tm_v, full(s),
                              sp * kSpan, j * kKeys, bh);
          }
        }
        ++it;
      }
    } else {  // the other three split each landed tile into its parts
      const int sw = tid / 32 - kConsumers / 32 - 1;
      for (int j = 0, it = 0; j < n_tiles; ++j) {
        if (!tile_on(j)) continue;
        const int s = it % kStages;
        sm90::mbar_wait(full(s), (it / kStages) & 1);
        ++it;
        // K in place, K_lo, Kᵀ_hi and Kᵀ_lo; V in place and V_lo
        uint8_t* const gst = gbase + (sring + s * kStage - base);
        constexpr int kWarps = kSplitters / 32;
        flash_f32::split_rows<DP, true, true>(gst, gst, gst + 3 * kPart,
                                              gst + 2 * kPart,
                                              gst + 5 * kPart, sw, kWarps,
                                              lane);
        flash_f32::split_rows<DP, true, false>(gst + kPart, gst + kPart,
                                               gst + 4 * kPart, nullptr,
                                               nullptr, (sw + 1) % kWarps,
                                               kWarps, lane);
        sm90::fence_proxy_async();  // the parts are wgmma operands now
        sm90::mbar_arrive(ready(s));
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 .. row0 + 63
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int row0 = q0 + wg * 64;
  int n_wg = 0;  // tiles this warpgroup computes (the rest it releases)
  if (row0 < tq) {
    const int last = min(row0 + 64, tq) - 1;
    n_wg = ((causal ? min(tk, last + 1) : tk) + kKeys - 1) / kKeys;
  }
  const int rows[2] = {row0 + sm90::acc_row(0, warp, lane),
                       row0 + sm90::acc_row(2, warp, lane)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = rows[h] < tq;
    lse_r[h] = in ? lse[(size_t)bh * tq + rows[h]] : 0.f;
    delta_r[h] = in ? delta[(size_t)bh * tq + rows[h]] : 0.f;
  }
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;

  // ---- split this warpgroup's 64 rows of Q and dO in place: the hi part
  // over the landed values, the lo part 2·kQ beyond
  sm90::mbar_wait(bar_q, 0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {  // Q, dO
    for (int sp = 0; sp < kSpansD; ++sp) {
      uint8_t* const part = gbase + t * kQ + sp * kQSpan + wg * 64 * 128;
      split_chunks(part, 2 * kQ, 512, tid % 128, 128);
    }
  }
  sm90::fence_proxy_async();  // the parts are wgmma operands now
  sm90::named_barrier(1 + wg, 128);

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  for (int j = 0, it = 0; j < n_tiles; ++j) {
    if (!tile_on(j)) continue;
    const int s = it % kStages;
    sm90::mbar_wait(ready(s), (it / kStages) & 1);  // landed and split
    ++it;
    const uint32_t st = sring + s * kStage;
    if (j < n_wg) {
      // ---- S = Q·Kᵀ and dP = dO·Vᵀ (64 rows x 32 keys): lo·hi, hi·lo,
      // hi·hi
      float sc[kKeys / 2], dp[kKeys / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t qa = pass == 0 ? sql : sq;
        const uint32_t da = pass == 0 ? sdol : sdo;
        const uint32_t kb = st + (pass == 1 ? 3 * kPart : 0);
        const uint32_t vb = kb + kPart;
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk) {
          const uint32_t a =
              (kk / 4) * kQSpan + wg * 64 * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
          WgmmaTf32<kKeys>::ss(sc, sm90::desc_sw128(qa + a, 16, 1024),
                               sm90::desc_sw128(kb + b, 16, 1024),
                               pass > 0 || kk > 0);
          WgmmaTf32<kKeys>::ss(dp, sm90::desc_sw128(da + a, 16, 1024),
                               sm90::desc_sw128(vb + b, 16, 1024),
                               pass > 0 || kk > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // ---- dS = P⊙(dP - Δ), split (a row is a query, a column a key)
      const int k0 = j * kKeys;
      uint32_t dsh[kKeys / 2], dsl[kKeys / 2];
#pragma unroll
      for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + sm90::acc_col(4 * n + e, lane);
          const bool in = col < tk;
          const bool on = in && (mrow == nullptr || mrow[col] > 0.5f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n + 2 * h + e;
            const bool seen = in && rows[h] < tq && (!causal || col <= rows[h]);
            const float x = on ? sc[i] * scale : kMasked;
            const float p = seen ? exp2f((x - lse_r[h]) * kLog2e) : 0.f;
            float dpv = dp[i];
            if (DROP)
              dpv = keep_element(seed_v, bh, rows[h], col, rate)
                        ? dpv * inv_keep
                        : 0.f;
            sm90::tf32_split(p * (dpv - delta_r[h]), dsh[i], dsl[i]);
          }
        }
      }

      // ---- dq += this tile's dS·K, summed from zero: dS from registers
      // (columns 0, 2, 4, 6, 1, 3, 5, 7 of each 8-key group, as Kᵀ holds
      // the keys), Kᵀ K-major
      flash_f32::add_split_product<DP, kKeys>(acc, dsh, dsl, st + 2 * kPart,
                                              st + 5 * kPart);
    }
    sm90::mbar_arrive(empty(s));
  }

  if (n_wg == 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= tq) continue;
    float* dq_row = dq + ((size_t)bh * tq + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d)
        *reinterpret_cast<float2*>(dq_row + col) =
            make_float2(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

struct Args {
  const float *q, *k, *v, *mask, *dout, *lse, *delta;
  const int* seed;
  float* dq;
  int bh, tq, tk, d;
  float scale;
  int causal;
  float rate, inv_keep;
};

template <bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!sm90::make_map(&mq, a.q, 0, a.bh, a.tq, a.d, kRows) ||
      !sm90::make_map(&mdo, a.dout, 0, a.bh, a.tq, a.d, kRows) ||
      !sm90::make_map(&mk, a.k, 0, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mv, a.v, 0, a.bh, a.tk, a.d, kKeys))
    return -2;
  auto kernel = flash_dq_f32_sm90<DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      mq, mdo, mk, mv, a.mask, a.lse, a.delta, a.seed, a.dq, a.tq, a.tk,
      a.d, a.scale, a.causal, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dl4j_flash_attn_dq's contract and signature for float32 (dtype 0) with
// D % 8 == 0 and D <= 64; q, k, v and dout 16-byte aligned. Returns
// cudaGetLastError() of the launch, -1 for another dtype or an unsupported
// head dim, -2 when a tensor map cannot be encoded. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_flash_attn_dq_f32_sm90(
    const float* q, const float* k, const float* v, const float* mask,
    const float* dout, const float* lse, const float* delta, const int* seed,
    float* dq, int bh, int tq, int tk, int d, float scale, int causal,
    float rate, float inv_keep, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0) return 0;
  if (dtype != 0 || d <= 0 || d % 8 != 0 || d > DP) return -1;
  if (tk <= 0)  // no keys: dq is 0 (no tensor map has a zero extent)
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, (size_t)bh * tq * d * sizeof(float), s));
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dq,
               bh, tq, tk, d,    scale, causal, rate,  inv_keep};
  return rate > 0.f ? launch<true>(a, s) : launch<false>(a, s);
}
