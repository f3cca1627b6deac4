// flash_attn_dq_sm90.cu — FlashAttention-2 backward dq on Hopper's tensor
// cores for bfloat16 and float16 inputs with head dim D <= 128 (sm_90a),
// float32 accumulation. The float32 inputs and 16-bit inputs with D > 128
// keep the CUDA-core kernel of flash_attn_bwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_dq_kernel`
// (pallas_call in `_flash_bwd`), as flash_attn_bwd.cu's dq kernel does,
// with the same contract (`dl4j_flash_attn_dq`): q, k, v, dO (BH, T, D)
// row-major; the forward's lse and Δ = rowsum(dO·O) (BH, Tq) in float32;
// the key mask, causal mask and dropout of the forward; dq in the input
// type. With P = exp(S·scale - lse), dP = dO·Vᵀ after dropout and
// dS = P⊙(dP - Δ):  dq = scale · dS·K.
//
// Numerics: S and dP accumulate exact 16-bit products in float32; dS is
// rounded, unscaled, to the input type before dS·K, as the TPU kernel's
// `_mm` rounds ds (`_mm_nn(ds, kblk)`); the scale multiplies the float32
// sum once, as `acc * scale` does there; dq is rounded once on the write.
//
// What bounds it on the H100: 6·D operations per visible (query, key)
// pair — 9.7 GFLOP at BH 96 × T 512, D 64 — against one read of q, k, v,
// dO and one write of dq: the tensor cores (989 TFLOP/s bf16) are the
// limit.
//
// Design (flash_attn_dkv_sm90.cu with the roles swapped):
//  * One block owns 128 query rows of one batch·head: two consumer
//    warpgroups of 64 rows and one producer warpgroup, which hands its
//    registers to the consumers (setmaxnreg) and issues the loads from one
//    thread. Grid (⌈Tq/128⌉, BH).
//  * Q and dO are loaded once by TMA. K and V tiles of 64 keys stream
//    through a two-stage ring (3-D tensor maps: rows past T and columns
//    past D read as zeros), `full` / `empty` mbarriers per stage.
//  * Per tile, three wgmma chains: S = Q·Kᵀ and dP = dO·Vᵀ with both
//    operands in shared memory (K-major over D), then dQ += dS·K with dS
//    as the register A operand and K read MN-major from its swizzled
//    buffer through the transpose bit, as the forward reads V.
//  * Registers: S and dP take 32 floats a thread each, dQ D/2 (32 or 64).
//    A producer warp alone would leave ptxas 168 registers a thread for a
//    288-thread block (it allocates whole warpgroups), the limit that
//    spilled dk/dv at D 128; the producer warpgroup's 24 / 240 split gives
//    the consumers room at D 128 as well. ptxas reports 168 registers at
//    entry for every instantiation (D 64 and 128, with and without
//    dropout) and no spills.
//  * lse_i and Δ_i are per row and held in registers once; the key mask is
//    per column and read per tile (the transpose of dk/dv). The keep hash
//    is called as keep_element(seed, bh, query, key) in the untransposed
//    fragment, as in the forward.
//  * Causal: the block's key loop ends at its last query row, and a
//    warpgroup stops at its own; pairs past the diagonal are never
//    visited. Keys past Tk weigh 0. A row whose keys are all masked gets
//    the finite values of the -1e30 fill, as the plain version.
//  * Every dq element is written once, by one thread: no atomics, and the
//    gradient is the same bits on every run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "flash_common.cuh"
#include "sm90.cuh"

namespace {

using flash::keep_element;
using flash::kMasked;
using sm90::Wgmma;

constexpr int kRows = 128;                  // query rows per block (2 WGs)
constexpr int kKeys = 64;                   // keys per K/V tile
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread: 128 x 24 + 256 x 240 <= the SM's 65536
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSlab = 64;                   // 16-bit columns per slab
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int kSlabs = DP / kSlab;
  static constexpr uint32_t kQ = kSlabs * kRows * 128;    // Q (or dO)
  static constexpr uint32_t kKV = kSlabs * kKeys * 128;   // one K or V tile
  static constexpr uint32_t kSmem = 2 * kQ + 4 * kKV + 1024;
};

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
              const __grid_constant__ CUtensorMap tm_k,
              const __grid_constant__ CUtensorMap tm_v,
              const __grid_constant__ CUtensorMap tm_do,
              const float* __restrict__ mask, const float* __restrict__ lse,
              const float* __restrict__ delta, const int* __restrict__ seed,
              T* __restrict__ dq, int tq, int tk, int d, float scale,
              int causal, float rate, float inv_keep) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sdo = sq + L::kQ;
  const uint32_t sk = sdo + L::kQ;
  const uint32_t sv = sk + 2 * L::kKV;
  const uint32_t bar_q = sm90::smem_u32(&bars[0]);
  auto full = [&](int s) { return sm90::smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[3 + s]); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // causal: no row of this block sees keys past its last row
  const int q_last = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(bar_q, 2 * L::kQ);
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        const uint32_t off = sl * kRows * 128;
        sm90::tma_load_3d(sq + off, &tm_q, bar_q, sl * kSlab, q0, bh);
        sm90::tma_load_3d(sdo + off, &tm_do, bar_q, sl * kSlab, q0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) sm90::mbar_wait(empty(s), ((j >> 1) - 1) & 1);
        sm90::mbar_arrive_expect_tx(full(s), 2 * L::kKV);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          const uint32_t off = s * L::kKV + sl * kKeys * 128;
          sm90::tma_load_3d(sk + off, &tm_k, full(s), sl * kSlab, j * kKeys,
                            bh);
          sm90::tma_load_3d(sv + off, &tm_v, full(s), sl * kSlab, j * kKeys,
                            bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows row0 .. row0 + 63
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int row0 = q0 + wg * 64;
  int n_wg = 0;  // tiles this warpgroup computes (the rest it only releases)
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
  const float* mrow = mask ? mask + (size_t)bh * tk : nullptr;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;

  sm90::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    sm90::mbar_wait(full(s), (j >> 1) & 1);
    if (j < n_wg) {
      const uint32_t tk_s = sk + s * L::kKV;
      const uint32_t tv_s = sv + s * L::kKV;
      // ---- S = Q·Kᵀ and dP = dO·Vᵀ (64 rows x 64 keys)
      float sc[32], dp[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = (kk / 4) * kRows * 128 + wg * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t b = (kk / 4) * kKeys * 128 + (kk % 4) * 32;
        Wgmma<64, T>::template ss<0>(sc, sm90::desc_sw128(sq + a, 16, 1024),
                                     sm90::desc_sw128(tk_s + b, 16, 1024),
                                     kk > 0);
        Wgmma<64, T>::template ss<0>(dp, sm90::desc_sw128(sdo + a, 16, 1024),
                                     sm90::desc_sw128(tv_s + b, 16, 1024),
                                     kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // ---- dS = P⊙(dP - Δ) into sc (a row is a query, a column a key)
      const int k0 = j * kKeys;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
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
            sc[i] = p * (dpv - delta_r[h]);
          }
        }
      }

      // ---- dQ += dS·K: dS from registers, K MN-major through the
      // transpose bit
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t dsa[4];
        sm90::acc_to_a<T>(sc, kk, dsa);
        Wgmma<DP, T>::template rs<1>(
            acc, dsa, sm90::desc_sw128(tk_s + kk * 16 * 128, kKeys * 128,
                                       1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc);
    }
    sm90::mbar_arrive(empty(s));
  }

  if (n_wg == 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= tq) continue;
    T* dq_row = dq + ((size_t)bh * tq + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d)
        *reinterpret_cast<uint32_t*>(dq_row + col) =
            sm90::pack2<T>(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta, *seed;
  void* dq;
  int bh, tq, tk, d;
  float scale;
  int causal;
  float rate, inv_keep;
  int dtype;
};

template <typename T, int DP, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::make_map(&mq, a.q, a.dtype, a.bh, a.tq, a.d, kRows) ||
      !sm90::make_map(&mk, a.k, a.dtype, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mv, a.v, a.dtype, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mdo, a.dout, a.dtype, a.bh, a.tq, a.d, kRows))
    return -2;
  auto kernel = flash_dq_sm90<T, DP, DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seed), static_cast<T*>(a.dq), a.tq, a.tk, a.d,
      a.scale, a.causal, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int dispatch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 0 || a.d % 8 != 0 || a.d > 128) return -1;
  return a.d <= 64 ? launch<T, 64, DROP>(a, s) : launch<T, 128, DROP>(a, s);
}

template <typename T>
int dispatch_drop(const Args& a, cudaStream_t s) {
  return a.rate > 0.f ? dispatch_d<T, true>(a, s) : dispatch_d<T, false>(a, s);
}

}  // namespace

// dl4j_flash_attn_dq's contract for dtype 1 = bfloat16 and 2 = float16
// with D % 8 == 0 and D <= 128; q, k, v and dout 16-byte aligned. Returns
// cudaGetLastError() of the launch, -1 for an unsupported dtype or head
// dim, -2 when a tensor map cannot be encoded. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_flash_attn_dq_sm90(const void* q, const void* k,
                                       const void* v, const void* mask,
                                       const void* dout, const void* lse,
                                       const void* delta, const void* seed,
                                       void* dq, int bh, int tq, int tk, int d,
                                       float scale, int causal, float rate,
                                       float inv_keep, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0) return 0;
  if (dtype != 1 && dtype != 2) return -1;
  if (tk <= 0)  // no keys: dq is 0 (no tensor map has a zero extent)
    return static_cast<int>(
        cudaMemsetAsync(dq, 0, (size_t)bh * tq * d * 2, s));
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dq,
               bh, tq, tk, d,    scale, causal, rate,  inv_keep, dtype};
  if (dtype == 1) return dispatch_drop<__nv_bfloat16>(a, s);
  if (dtype == 2) return dispatch_drop<__half>(a, s);
  return -1;
}
