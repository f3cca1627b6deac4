// flash_attn_fwd_f32_sm90.cu — FlashAttention-2 forward for float32 inputs
// with head dim D <= 128 on Hopper's tensor cores (sm_90a), every product
// accurate to float32 by a split into TF32 parts. float32 with D > 128
// keeps the CUDA-core kernel of flash_attn_fwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_attn_kernel`
// (pallas_call in `_flash_fwd`) for float32 — which on the TPU takes
// Mosaic's multi-pass float32 MXU path — with the contract of
// `dl4j_flash_attn_fwd`: q, k, v (BH, T, D) row-major; an optional key mask
// (BH, Tk) of 0/1 floats (masked scores are -1e30, as on the TPU); an
// optional START-aligned causal mask (key j visible to query i iff j <= i);
// optional attention dropout in the kernel with the TPU's keep hash
// (flash_common.cuh `keep_element`), applied after the denominator update,
// kept entries scaled by 1/(1-rate); out (BH, Tq, D) and lse (BH, Tq) in
// float32. A row whose keys are all masked gets the -1e30 fill's mean of V,
// as the plain version.
//
// Numerics: never single-pass TF32. Each product operand is split as
// hi = tf32(v), lo = tf32(v - hi) (sm90.cuh `tf32_split`), and
// S = Q_lo·K_hi + Q_hi·K_lo + Q_hi·K_hi and O += P_lo·V_hi + P_hi·V_lo +
// P_hi·V_hi, the small passes first: the terms left out are ~2^-22 of each
// |product|. P stays float32 (no 16-bit rounding: the float32 contract),
// and the checks are the float32 ones (1e-4), which one TF32 pass breaks
// ~13×.
//
// What bounds it on the H100: at BERT's shapes (BH 96 × T 512, D 64) the
// work is 6.4 GFLOP of float32 products, three TF32 passes each (494.7
// TFLOP/s dense TF32, so 165 TFLOP/s of float32 products), against ~50 MB
// of float32 q, k, v and out: the tensor cores, not the memory, are the
// limit; the exp and the dropout hash of every score run on the CUDA cores.
//
// Design (the skeleton of flash_attn_fwd_sm90.cu):
//  * TF32 wgmma reads shared-memory operands K-major only. S = Q·Kᵀ
//    contracts over D, along which Q and K are contiguous; O += P·V
//    contracts over keys, along which V is not. So a pre-pass kernel
//    (`transpose_v`, launched by the same call) writes Vᵀ (BH, D, Tp), Tp
//    = Tk rounded up to 8 (zeros past Tk), and TMA reads q, k and Vᵀ as
//    they are. Each landed K and Vᵀ tile is split in shared memory by the
//    consumers: hi over the landed values, lo beside them, then
//    fence.proxy.async and a barrier of both warpgroups. (A first design
//    split K and Vᵀ in the pre-pass, which wrote both parts of both and
//    so moved about three times the bytes of K and V; at BERT's T 128 a
//    head has one query block, and no tile is read twice.)
//  * P comes from the S accumulator as the register A operand of P·V. The
//    accumulator gives a thread columns 2c, 2c + 1 of each 8-key group and
//    the TF32 A fragment wants c, c + 4 (sm90.cuh `tf32_a_col`), so vt
//    holds each group's keys in the order 0, 2, 4, 6, 1, 3, 5, 7: the
//    permutation costs no shuffle.
//  * One block owns 128 query rows of one batch·head: two consumer
//    warpgroups of 64 rows and a producer warpgroup that hands its
//    registers to them (setmaxnreg 24 / 240: with a producer warp alone the
//    block is capped at 168 registers a thread, and P's two parts, S and O
//    spilled at D 64). Grid (⌈Tq/128⌉, BH). The producer loads Q once (the consumers split it in place: Q_hi over Q,
//    Q_lo beside it, then fence.proxy.async and a warpgroup barrier) and
//    streams K_hi, K_lo, V_hi and V_lo tiles into a shared-memory ring
//    with TMA (3-D tensor maps: rows past T and columns past D read as
//    zeros, never another head's rows), each stage completed on a `full`
//    mbarrier and released by the 256 consumer threads on an `empty` one.
//  * Shared memory (227 KB): Q's two parts take 2 x 128 x D x 4 bytes and
//    a stage (K's and Vᵀ's parts) 4 x keys x D x 4: D 64 runs 64-key tiles
//    in two stages (64 + 2 x 64 KB), D 128 32-key tiles in one stage (128 +
//    64 KB).
//  * The scale, the masks, the online max and sum, the rescale and the
//    keep hash run on the accumulator registers as in the 16-bit kernel.
//  * Every output is written once, by one thread: no atomics.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "flash_common.cuh"
#include "flash_f32.cuh"
#include "sm90.cuh"

namespace {

using flash::keep_element;
using flash::kMasked;
using flash_f32::group_key;
using flash_f32::split_chunks;
using sm90::WgmmaTf32;

constexpr int kRows = 128;                  // query rows a block (2 WGs)
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;           // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kSpan = 32;                  // float32 values a 128-byte row
constexpr float kLog2e = 1.4426950408889634f;

// DP: the head dim padded to 64 or 128; KEYS keys a tile; STAGES in the ring
template <int DP>
struct Layout {
  static constexpr int KEYS = DP == 64 ? 64 : 32;
  static constexpr int STAGES = DP == 64 ? 2 : 1;
  static constexpr int kSpansD = DP / kSpan;                 // Q's, K's
  static constexpr uint32_t kQSpan = kRows * 128;            // 16 KB
  static constexpr uint32_t kQ = kSpansD * kQSpan;           // one part
  static constexpr uint32_t kK = kSpansD * KEYS * 128;       // one part
  static constexpr uint32_t kV = (KEYS / kSpan) * DP * 128;  // one part
  static constexpr uint32_t kStage = 2 * kK + 2 * kV;
  static constexpr uint32_t kSmem = 2 * kQ + STAGES * kStage + 1024;
};

// The pre-pass: vt (BH, D, Tp) = Vᵀ, keys permuted within groups of 8 and
// zeros past Tk. A block takes 32 keys of one batch·head through shared
// memory: rows of V read and rows of Vᵀ written along consecutive
// addresses.
__global__ void __launch_bounds__(256)
transpose_v(const float* __restrict__ v, float* __restrict__ vt, int tk,
            int d, int tp) {
  __shared__ float tile[32][129];  // 32 keys x D <= 128, +1 against conflicts
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * 32;
  const float* vh = v + (size_t)bh * tk * d;
  for (int e = threadIdx.x; e < 32 * d; e += blockDim.x) {
    const int key = e / d, col = e % d;
    tile[key][col] =
        k0 + key < tk ? __ldg(vh + (size_t)(k0 + key) * d + col) : 0.f;
  }
  __syncthreads();
  float* vth = vt + (size_t)bh * d * tp;
  for (int e = threadIdx.x; e < 32 * d; e += blockDim.x) {
    const int row = e / 32, p = e % 32;
    if (k0 + p < tp) vth[(size_t)row * tp + k0 + p] = tile[group_key(p)][row];
  }
}

template <int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ mask, float* __restrict__ out,
                   float* __restrict__ lse, int tq, int tk, int d,
                   float scale, int causal, const int* __restrict__ seed,
                   float rate, float inv_keep) {
  using L = Layout<DP>;
  constexpr int KEYS = L::KEYS;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic view of `base`
  const uint32_t sq = base;           // Q_hi (TMA lands Q here)
  const uint32_t sql = sq + L::kQ;    // Q_lo
  const uint32_t sring = sql + L::kQ;
  const uint32_t bar_q = sm90::smem_u32(&bars[0]);
  auto full = [&](int s) { return sm90::smem_u32(&bars[1 + s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[1 + STAGES + s]); };

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // causal: no row of this block sees keys past its last row
  const int q_last = min(q0 + kRows, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const int n_tiles = (k_end + KEYS - 1) / KEYS;

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(bar_q, L::kQ);
      for (int sp = 0; sp < L::kSpansD; ++sp)
        sm90::tma_load_3d(sq + sp * L::kQSpan, &tm_q, bar_q, sp * kSpan, q0,
                          bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) sm90::mbar_wait(empty(s), (j / STAGES - 1) & 1);
        // K and Vᵀ land in their hi parts; the consumers split them
        sm90::mbar_arrive_expect_tx(full(s), L::kK + L::kV);
        const uint32_t st = sring + s * L::kStage;
        for (int sp = 0; sp < L::kSpansD; ++sp)
          sm90::tma_load_3d(st + sp * KEYS * 128, &tm_k, full(s), sp * kSpan,
                            j * KEYS, bh);
        for (int sp = 0; sp < KEYS / kSpan; ++sp)
          sm90::tma_load_3d(st + 2 * L::kK + sp * DP * 128, &tm_v, full(s),
                            j * KEYS + sp * kSpan, 0, bh);
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
    n_wg = ((causal ? min(tk, last + 1) : tk) + KEYS - 1) / KEYS;
  }
  const int rows[2] = {row0 + sm90::acc_row(0, warp, lane),
                       row0 + sm90::acc_row(2, warp, lane)};
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;
  const float* mrow = mask ? mask + (size_t)bh * tk : nullptr;

  // ---- split this warpgroup's 64 rows of Q in place: Q_hi over Q, Q_lo
  // at the same offsets in the second part (the swizzle moves whole
  // 16-byte chunks, so the split is elementwise on the bytes)
  sm90::mbar_wait(bar_q, 0);
  for (int sp = 0; sp < L::kSpansD; ++sp)  // this warpgroup's 64 rows, 8 KB
    split_chunks(gbase + sp * L::kQSpan + wg * 64 * 128, L::kQ, 512,
                 tid % 128, 128);
  sm90::fence_proxy_async();  // the parts are wgmma operands now
  sm90::named_barrier(1 + wg, 128);

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    sm90::mbar_wait(full(s), (j / STAGES) & 1);
    const uint32_t st = sring + s * L::kStage;
    // both warpgroups split the landed K and Vᵀ tiles: each reads all of
    // them, so both wait for all of the split
    uint8_t* const gst = gbase + (st - base);
    split_chunks(gst, L::kK, L::kK / 16, tid, kConsumers);
    split_chunks(gst + 2 * L::kK, L::kV, L::kV / 16, tid, kConsumers);
    sm90::fence_proxy_async();
    sm90::named_barrier(3, kConsumers);
    if (j < n_wg) {
      // ---- S = Q·Kᵀ (64 rows x KEYS keys): Q_lo·K_hi, Q_hi·K_lo, Q_hi·K_hi
      float sc[KEYS / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t qa = pass == 0 ? sql : sq;
        const uint32_t kb = st + (pass == 1 ? L::kK : 0);
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk) {
          const uint32_t a = qa + (kk / 4) * L::kQSpan + wg * 64 * 128 +
                             (kk % 4) * 32;
          const uint32_t b = kb + (kk / 4) * KEYS * 128 + (kk % 4) * 32;
          WgmmaTf32<KEYS>::ss(sc, sm90::desc_sw128(a, 16, 1024),
                              sm90::desc_sw128(b, 16, 1024),
                              pass > 0 || kk > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);

      // ---- scale and masks; the tile's row max
      const int k0 = j * KEYS;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < KEYS / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + sm90::acc_col(4 * n + e, lane);
          const bool in = col < tk;
          const bool on = in && (mrow == nullptr || mrow[col] > 0.5f);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * n + 2 * h + e;
            float x = sc[i] * scale;
            if (!on) x = kMasked;
            if (!in || (causal && col > rows[h])) x = -CUDART_INF_F;
            sc[i] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      // ---- online softmax: rescale, exponentiate, drop, split
      float alpha[2], mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        mu[h] = mx[h] == -CUDART_INF_F ? 0.f : mx[h];
        alpha[h] = exp2f((m[h] - mu[h]) * kLog2e);
        m[h] = mx[h];
        l[h] *= alpha[h];
      }
      uint32_t ph[KEYS / 2], pl[KEYS / 2];
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = exp2f((sc[i] - mu[h]) * kLog2e);
        // the denominator takes the un-dropped p; dropout hits the
        // normalized probabilities, as on the TPU
        l[h] += p;
        if (DROP) {
          const int col = k0 + sm90::acc_col(i, lane);
          p = keep_element(seed_v, bh, rows[h], col, rate) ? p * inv_keep
                                                           : 0.f;
        }
        sm90::tf32_split(p, ph[i], pl[i]);
      }
      sm90::fence_regs(o);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90::fence_regs(o);

      // ---- O += P·V: P from registers (columns 0, 2, 4, 6, 1, 3, 5, 7 of
      // each 8-key group, as vt holds the keys), Vᵀ K-major in shared memory
      sm90::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t vb = st + 2 * L::kK + (pass == 1 ? L::kV : 0);
#pragma unroll
        for (int kk = 0; kk < KEYS / 8; ++kk) {
          uint32_t a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {  // register r reads value 4kk + π(r)
            const int i = 4 * kk + (r & 1) * 2 + (r >> 1);
            a[r] = pass == 0 ? pl[i] : ph[i];
          }
          const uint32_t b = vb + (kk / 4) * DP * 128 + (kk % 4) * 32;
          WgmmaTf32<DP>::rs(o, a, sm90::desc_sw128(b, 16, 1024), 1);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(o);
    }
    sm90::mbar_arrive(empty(s));
  }

  if (n_wg == 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= tq) continue;
    const float ls = fmaxf(l[h], 1e-30f);
    float* orow = out + ((size_t)bh * tq + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d)
        *reinterpret_cast<float2*>(orow + col) =
            make_float2(o[i] / ls, o[i + 1] / ls);
    }
    if ((lane & 3) == 0) lse[(size_t)bh * tq + r] = m[h] + logf(ls);
  }
}

struct Args {
  const float *q, *k, *v, *mask;
  float *vt, *out, *lse;
  int bh, tq, tk, d;
  float scale;
  int causal;
  const int* seed;
  float rate, inv_keep;
};

template <int DP, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<DP>;
  const int tp = (a.tk + 7) / 8 * 8;
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map(&mq, a.q, 0, a.bh, a.tq, a.d, kRows)) return -2;
  if (a.tk > 0) {
    transpose_v<<<dim3((tp + 31) / 32, a.bh), 256, 0, stream>>>(
        a.v, a.vt, a.tk, a.d, tp);
    if (!sm90::make_map(&mk, a.k, 0, a.bh, a.tk, a.d, L::KEYS) ||
        !sm90::make_map(&mv, a.vt, 0, a.bh, a.d, tp, DP))
      return -2;
  } else {  // no keys: the kernel loads no tile (a map has no zero extent)
    std::memset(&mk, 0, sizeof(mk));
    std::memset(&mv, 0, sizeof(mv));
  }
  auto kernel = flash_fwd_f32_sm90<DP, DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      mq, mk, mv, a.mask, a.out, a.lse, a.tq, a.tk, a.d, a.scale, a.causal,
      a.seed, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <bool DROP>
int dispatch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 0 || a.d % 8 != 0 || a.d > 128) return -1;
  return a.d <= 64 ? launch<64, DROP>(a, s) : launch<128, DROP>(a, s);
}

}  // namespace

// dl4j_flash_attn_fwd's contract for float32 with D % 8 == 0 and D <= 128;
// q and k 16-byte aligned. vt (BH·D·Tp floats, Tp = Tk rounded up to 8,
// 16-byte aligned) is the caller's scratch for Vᵀ. Returns
// cudaGetLastError() of the launches, -1 for an unsupported head dim, -2
// when a tensor map cannot be encoded. Launches on `stream`; allocates
// nothing.
extern "C" int dl4j_flash_attn_fwd_f32_sm90(
    const float* q, const float* k, const float* v, const float* mask,
    float* vt, float* out, float* lse, int bh, int tq, int tk, int d,
    float scale, int causal, const int* seed, float rate, float inv_keep,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0) return 0;
  if (tk < 0) return -1;
  const Args a{q,  k,  v, mask,  vt,     out,  lse,  bh,      tq,
               tk, d, scale, causal, seed, rate, inv_keep};
  return a.rate > 0.f ? dispatch_d<true>(a, s) : dispatch_d<false>(a, s);
}
