// flash_attn_dkv_sm90.cu — FlashAttention-2 backward dk and dv on Hopper's
// tensor cores for bfloat16 and float16 inputs with head dim D <= 128
// (sm_90a), float32 accumulation. dq, the float32 inputs and 16-bit inputs
// with D > 128 keep the CUDA-core kernels of flash_attn_bwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_dkv_kernel`
// (pallas_call in `_flash_bwd`), as flash_attn_bwd.cu's dk/dv kernel does,
// with the same contract (`dl4j_flash_attn_dkv`): q, k, v, dO (BH, T, D)
// row-major; the forward's lse and Δ = rowsum(dO·O) (BH, Tq) in float32;
// the key mask, causal mask and dropout of the forward; dk and dv in the
// input type. With P = exp(S - lse), P̃ = P after dropout, dP = dO·Vᵀ after
// dropout and dS = P⊙(dP - Δ)·scale:  dv = P̃ᵀ·dO,  dk = dSᵀ·Q.
//
// Numerics: Sᵀ and dPᵀ accumulate exact 16-bit products in float32; P̃ᵀ
// and dSᵀ (the scale folded in) are rounded to the input type before the
// two products that take them, as the TPU kernel's `_mm` rounds p_drop and
// ds; dk and dv stay float32 in registers and are written once.
//
// What bounds it on the H100: 8·D operations per visible (query, key)
// pair — 12.9 GFLOP at BH 96 × T 512, D 64 — against one read of q, k, v,
// dO: the tensor cores (989 TFLOP/s bf16) are the limit.
//
// Design:
//  * One block owns 128 key rows of one batch·head: two consumer
//    warpgroups of 64 keys and one producer warpgroup, which hands its
//    registers to the consumers (setmaxnreg) and issues the loads from one
//    thread. Grid (⌈Tk/128⌉, BH).
//  * K and V are loaded once by TMA. Q and dO tiles of BQ queries (64 for
//    D <= 64, 32 for D <= 128, which keeps the four accumulators in
//    registers) stream through a two-stage ring (3-D tensor maps: rows past
//    T and columns past D read as zeros), `full` / `empty` mbarriers per
//    stage. lse, Δ and the key mask are read from device memory per column.
//  * Per tile, four wgmma chains: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ with both
//    operands in shared memory (K-major), then dV += P̃ᵀ·dO and
//    dK += dSᵀ·Q with P̃ᵀ and dSᵀ as the register A operand and dO and Q
//    read MN-major from the same swizzled buffers through the transpose
//    bit. In the transposed fragment a row is a key and a column a query;
//    the keep hash is still called as keep_element(seed, bh, query, key).
//  * Causal: a key block starts at the first query tile that can see it,
//    and a warpgroup skips the tiles below its own first key.
//  * Every output is written once, by one thread: no atomics, and the
//    gradients are the same bits on every run.

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

constexpr int kKeys = 128;                  // key rows per block (2 WGs)
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
// registers a thread: the producer warpgroup gives its share to the
// consumers (128 x 24 + 256 x 240 <= the SM's 65536), whose four
// accumulators need them at D = 128
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kSlab = 64;                  // 16-bit columns per slab
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int kSlabs = DP / kSlab;
  static constexpr int BQ = DP <= 64 ? 64 : 32;               // streamed rows
  static constexpr uint32_t kKV = kSlabs * kKeys * 128;       // K (or V)
  static constexpr uint32_t kTile = kSlabs * BQ * 128;        // a Q (dO) tile
  static constexpr uint32_t kSmem = 2 * kKV + 4 * kTile + 1024;
};

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_do,
               const float* __restrict__ mask, const float* __restrict__ lse,
               const float* __restrict__ delta, const int* __restrict__ seed,
               T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int d,
               float scale, int causal, float rate, float inv_keep) {
  using L = Layout<DP>;
  constexpr int BQ = L::BQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = base;
  const uint32_t sv = sk + L::kKV;
  const uint32_t sq = sv + L::kKV;
  const uint32_t sdo = sq + 2 * L::kTile;
  const uint32_t bar_kv = sm90::smem_u32(&bars[0]);
  auto full = [&](int s) { return sm90::smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[3 + s]); };

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // causal: query i sees key j iff j <= i, so no query below this block's
  // first key contributes (k0 is a multiple of BQ)
  const int i_begin = causal ? k0 : 0;
  const int n_tiles = i_begin < tq ? (tq - i_begin + BQ - 1) / BQ : 0;

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
      for (int sl = 0; sl < L::kSlabs; ++sl) {
        const uint32_t off = sl * kKeys * 128;
        sm90::tma_load_3d(sk + off, &tm_k, bar_kv, sl * kSlab, k0, bh);
        sm90::tma_load_3d(sv + off, &tm_v, bar_kv, sl * kSlab, k0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j & 1;
        if (j >= 2) sm90::mbar_wait(empty(s), ((j >> 1) - 1) & 1);
        sm90::mbar_arrive_expect_tx(full(s), 2 * L::kTile);
        for (int sl = 0; sl < L::kSlabs; ++sl) {
          const uint32_t off = s * L::kTile + sl * BQ * 128;
          const int i0 = i_begin + j * BQ;
          sm90::tma_load_3d(sq + off, &tm_q, full(s), sl * kSlab, i0, bh);
          sm90::tma_load_3d(sdo + off, &tm_do, full(s), sl * kSlab, i0, bh);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys kw0 .. kw0 + 63
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int kw0 = k0 + wg * 64;
  // the first tile this warpgroup computes (causal: the one holding query
  // kw0); a warpgroup past Tk computes none
  const int j_first = kw0 >= tk ? n_tiles : (causal ? (kw0 - i_begin) / BQ : 0);
  const int keys[2] = {kw0 + sm90::acc_row(0, warp, lane),
                       kw0 + sm90::acc_row(2, warp, lane)};
  bool key_on[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_on[h] = keys[h] < tk &&
                (mask == nullptr || mask[(size_t)bh * tk + keys[h]] > 0.5f);
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;
  const float* lse_b = lse + (size_t)bh * tq;
  const float* delta_b = delta + (size_t)bh * tq;

  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  sm90::mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    sm90::mbar_wait(full(s), (j >> 1) & 1);
    if (j >= j_first) {
      const uint32_t tq_s = sq + s * L::kTile;
      const uint32_t tdo_s = sdo + s * L::kTile;
      // ---- Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (64 keys x BQ queries)
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = (kk / 4) * kKeys * 128 + wg * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
        Wgmma<BQ, T>::template ss<0>(st, sm90::desc_sw128(sk + a, 16, 1024),
                                     sm90::desc_sw128(tq_s + b, 16, 1024),
                                     kk > 0);
        Wgmma<BQ, T>::template ss<0>(dpt, sm90::desc_sw128(sv + a, 16, 1024),
                                     sm90::desc_sw128(tdo_s + b, 16, 1024),
                                     kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // ---- P̃ᵀ into st, dSᵀ into dpt (a row is a key, a column a query)
      const int i0 = i_begin + j * BQ;
#pragma unroll
      for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = i0 + sm90::acc_col(4 * n + e, lane);
          const bool q_in = qi < tq;
          const float lse_q = q_in ? lse_b[qi] : 0.f;
          const float delta_q = q_in ? delta_b[qi] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n + 2 * h + e;
            const bool seen = q_in && (!causal || qi >= keys[h]);
            const float sc = key_on[h] ? st[i] * scale : kMasked;
            const float p = seen ? exp2f((sc - lse_q) * kLog2e) : 0.f;
            float pt = p, dp = dpt[i];
            if (DROP) {
              if (keep_element(seed_v, bh, qi, keys[h], rate)) {
                pt *= inv_keep;
                dp *= inv_keep;
              } else {
                pt = 0.f;
                dp = 0.f;
              }
            }
            st[i] = pt;
            dpt[i] = p * (dp - delta_q) * scale;
          }
        }
      }

      // ---- dV += P̃ᵀ·dO and dK += dSᵀ·Q: A from registers, B MN-major
      sm90::fence_regs(acc_dk);
      sm90::fence_regs(acc_dv);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        sm90::acc_to_a<T>(st, kk, pa);
        sm90::acc_to_a<T>(dpt, kk, dsa);
        const uint32_t b = kk * 16 * 128;
        Wgmma<DP, T>::template rs<1>(
            acc_dv, pa, sm90::desc_sw128(tdo_s + b, BQ * 128, 1024));
        Wgmma<DP, T>::template rs<1>(
            acc_dk, dsa, sm90::desc_sw128(tq_s + b, BQ * 128, 1024));
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(acc_dk);
      sm90::fence_regs(acc_dv);
    }
    sm90::mbar_arrive(empty(s));
  }

  if (kw0 >= tk) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = keys[h];
    if (r >= tk) continue;
    T* dk_row = dk + ((size_t)bh * tk + r) * d;
    T* dv_row = dv + ((size_t)bh * tk + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d) {
        *reinterpret_cast<uint32_t*>(dk_row + col) =
            sm90::pack2<T>(acc_dk[i], acc_dk[i + 1]);
        *reinterpret_cast<uint32_t*>(dv_row + col) =
            sm90::pack2<T>(acc_dv[i], acc_dv[i + 1]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta, *seed;
  void *dk, *dv;
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
  if (!sm90::make_map(&mq, a.q, a.dtype, a.bh, a.tq, a.d, L::BQ) ||
      !sm90::make_map(&mk, a.k, a.dtype, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mv, a.v, a.dtype, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mdo, a.dout, a.dtype, a.bh, a.tq, a.d, L::BQ))
    return -2;
  auto kernel = flash_dkv_sm90<T, DP, DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tk + kKeys - 1) / kKeys, a.bh);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      mq, mk, mv, mdo, static_cast<const float*>(a.mask),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seed), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.tq, a.tk, a.d, a.scale, a.causal, a.rate,
      a.inv_keep);
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

// dl4j_flash_attn_dkv's contract for dtype 1 = bfloat16 and 2 = float16
// with D % 8 == 0 and D <= 128; q, k, v and dout 16-byte aligned. Returns
// cudaGetLastError() of the launch, -1 for an unsupported dtype or head
// dim, -2 when a tensor map cannot be encoded. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_flash_attn_dkv_sm90(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        const void* dout, const void* lse,
                                        const void* delta, const void* seed,
                                        void* dk, void* dv, int bh, int tq,
                                        int tk, int d, float scale, int causal,
                                        float rate, float inv_keep, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tk <= 0) return 0;
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dk,   dv,
               bh, tq, tk, d,    scale, causal, rate,  inv_keep, dtype};
  if (dtype == 1) return dispatch_drop<__nv_bfloat16>(a, s);
  if (dtype == 2) return dispatch_drop<__half>(a, s);
  return -1;
}
