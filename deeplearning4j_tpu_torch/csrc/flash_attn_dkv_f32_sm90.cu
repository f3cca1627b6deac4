// flash_attn_dkv_f32_sm90.cu — FlashAttention-2 backward dk and dv for
// float32 inputs with head dim D <= 64 on Hopper's tensor cores (sm_90a),
// every product accurate to float32 by a split into TF32 parts. float32
// with D > 64 keeps the CUDA-core kernel of flash_attn_bwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_dkv_kernel`
// (pallas_call in `_flash_bwd`) for float32 — which on the TPU takes
// Mosaic's multi-pass float32 MXU path — with the contract of
// `dl4j_flash_attn_dkv`: q, k, v, dO (BH, T, D) row-major; the forward's
// lse and Δ = rowsum(dO·O) (BH, Tq) in float32; the key mask, the
// START-aligned causal mask and the dropout keep hash (flash_common.cuh
// `keep_element`) of the forward; dk and dv (BH, Tk, D) in float32. With
// P = exp(S·scale - lse), P̃ = P after dropout, dP = dO·Vᵀ after dropout and
// dS = P⊙(dP - Δ):  dv = P̃ᵀ·dO,  dk = scale · dSᵀ·Q.
//
// Numerics: never single-pass TF32. Each operand is split as hi =
// tf32(v), lo = tf32(v - hi) (sm90.cuh `tf32_split`) and each product is
// lo·hi + hi·lo + hi·hi, the small passes first. P̃ᵀ and dSᵀ stay float32
// (no 16-bit rounding: the TPU's `_mm` keeps float32 × float32 in float32)
// and are split in registers; the scale multiplies dk's float32 sum once.
// The check is the float32 one (1e-4 + 1e-5·|plain|), which one TF32 pass
// breaks.
//
// What bounds it on the H100: 8·D operations per visible (query, key)
// pair, three TF32 passes each (494.7 TFLOP/s dense TF32, so 165 TFLOP/s
// of float32 products): 12.9 GFLOP at BH 96 × T 512, D 64, against one
// read of q, k, v, dO and one write of dk, dv (~75 MB): the tensor cores
// are the limit there; at BERT's T 128 with ragged keys the bytes are.
//
// Design (flash_attn_dkv_sm90.cu's skeleton, with the float32 forward's
// split):
//  * TF32 wgmma reads shared-memory operands K-major only. Sᵀ = K·Qᵀ and
//    dPᵀ = V·dOᵀ contract over D, along which all four are contiguous;
//    dV += P̃ᵀ·dO and dK += dSᵀ·Q contract over queries, along which dO
//    and Q are not (the 16-bit kernel reads them MN-major through the
//    transpose bit, which TF32 lacks). So the kernel reads their
//    transposed tiles Qᵀ and dOᵀ (D × 32 queries), queries permuted 0, 2,
//    4, 6, 1, 3, 5, 7 within each group of 8: P̃ᵀ's and dSᵀ's accumulator
//    registers are then the TF32 A fragment without a shuffle (sm90.cuh
//    `tf32_a_col`). Qᵀ and dOᵀ are written in shared memory from the
//    landed Q and dO tiles (flash_f32.cuh `split_rows`), as their parts
//    are: a first design wrote them (BH, D, Tp) with two pre-pass kernels
//    and loaded them by TMA, which was slower (PERF.md).
//  * One block owns 128 key rows of one batch·head: two consumer
//    warpgroups of 64 keys and a producer warpgroup that hands its
//    registers to them (setmaxnreg 24 / 240). Grid (⌈Tk/128⌉, BH).
//  * Shared memory (227 KB): K and V in two parts each take 128 KB, loaded
//    once and split in place by the warpgroup that owns the rows. A tile of
//    32 queries holds Q, dO, Qᵀ and dOᵀ in two parts, 64 KB: two such
//    stages do not fit. So the producer streams the raw Q and dO tiles
//    with TMA (3-D tensor maps: rows past T and columns past D read as
//    zeros) into one landing buffer (16 KB), completed on a `full`
//    mbarrier; the consumers split it into the working buffer's parts,
//    transposed copies included, and release it on an `empty` one, and TMA
//    brings the next tile while they compute this one. Two barriers of
//    both warpgroups a tile: before the split (the last tile's products
//    are done) and after it (fence.proxy.async: the parts are visible to
//    the tensor cores).
//  * Per tile: Sᵀ and dPᵀ (64 keys × 32 queries) from shared memory, three
//    passes each; in the transposed fragment a row is a key and a column a
//    query, so the key mask is per row and lse, Δ and the keep hash are
//    read per column — called as keep_element(seed, bh, query, key). P̃ᵀ
//    and dSᵀ are split in registers and handed over as the A operands of
//    P̃ᵀ·dO and dSᵀ·Q against dOᵀ's and Qᵀ's parts, each tile's summed from
//    zero and added to dk's and dv's float32 sums on the CUDA cores: one
//    accumulator through every tile lost about a unit of the sum per wgmma
//    addition in the tensor cores (PERF.md), several times the CPU
//    transcription's error at T 512 causal.
//  * A warpgroup whose 64 keys are all masked computes nothing and writes
//    zeros when every query row that sees them also sees an unmasked key
//    (with the causal mask: one below the warpgroup's first key): their p
//    is then exactly 0 (flash_f32.cuh `can_skip_masked`). With BERT's
//    ragged rows (16…128 keys) the second warpgroup skips in ~40% of the
//    heads.
//  * Causal: a key block starts at the first query tile that can see it,
//    and a warpgroup skips the tiles below its own first key.
//  * Every output is written once, by one thread: no atomics, and the
//    gradients are the same bits on every run.

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

constexpr int kKeys = 128;                  // key rows a block (2 WGs)
constexpr int BQ = 32;                      // queries a tile: a span of Qᵀ
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;           // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr int kSpan = 32;                   // float32 values a 128-byte row
constexpr int DP = 64;                      // the head dim, padded
constexpr int kSpansD = DP / kSpan;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory from a 1024-byte boundary: K_hi, V_hi (where TMA lands K
// and V), K_lo, V_lo; the working tile's hi parts Q, dO, Qᵀ, dOᵀ, then its
// lo parts in the same order; the landing buffer: Q and dO, raw.
constexpr uint32_t kKVSpan = kKeys * 128;          // 16 KB
constexpr uint32_t kKV = kSpansD * kKVSpan;        // K or V, one part
constexpr uint32_t kPart = kSpansD * BQ * 128;     // a Q or dO tile, one part
static_assert(kPart == (BQ / kSpan) * DP * 128, "a Qᵀ tile is as large");
constexpr uint32_t kTile = 4 * kPart;              // Q, dO, Qᵀ, dOᵀ
constexpr uint32_t kSmem = 4 * kKV + 2 * kTile + 2 * kPart + 1024;

template <bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_f32_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const float* __restrict__ mask,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seed, float* __restrict__ dk,
                   float* __restrict__ dv, int tq, int tk, int d, float scale,
                   int causal, float rate, float inv_keep) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[3];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);  // generic view of `base`
  const uint32_t sk = base;            // K_hi
  const uint32_t sv = base + kKV;      // V_hi
  const uint32_t skl = base + 2 * kKV; // K_lo
  const uint32_t svl = base + 3 * kKV; // V_lo
  const uint32_t swork = base + 4 * kKV;     // hi parts; lo at + kTile
  const uint32_t sland = swork + 2 * kTile;  // the raw Q and dO tiles
  const uint32_t bar_kv = sm90::smem_u32(&bars[0]);
  const uint32_t full = sm90::smem_u32(&bars[1]);
  const uint32_t empty = sm90::smem_u32(&bars[2]);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kKeys;
  const int tid = threadIdx.x;
  if (tid == 0) {
    sm90::mbar_init(bar_kv, 1);
    sm90::mbar_init(full, 1);
    sm90::mbar_init(empty, kConsumers);
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
      sm90::mbar_arrive_expect_tx(bar_kv, 2 * kKV);
      for (int sp = 0; sp < kSpansD; ++sp) {
        sm90::tma_load_3d(sk + sp * kKVSpan, &tm_k, bar_kv, sp * kSpan, k0,
                          bh);
        sm90::tma_load_3d(sv + sp * kKVSpan, &tm_v, bar_kv, sp * kSpan, k0,
                          bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        if (j >= 1) sm90::mbar_wait(empty, (j - 1) & 1);
        sm90::mbar_arrive_expect_tx(full, 2 * kPart);
        const int i0 = i_begin + j * BQ;
        for (int sp = 0; sp < kSpansD; ++sp) {
          sm90::tma_load_3d(sland + sp * BQ * 128, &tm_q, full, sp * kSpan,
                            i0, bh);
          sm90::tma_load_3d(sland + kPart + sp * BQ * 128, &tm_do, full,
                            sp * kSpan, i0, bh);
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
  // kw0); a warpgroup past Tk, or whose keys are all masked where that
  // makes their p 0, computes none (its dk and dv are 0)
  const float* mrow = mask ? mask + (size_t)bh * tk : nullptr;
  const bool masked_out = flash_f32::can_skip_masked(
                              mrow, causal ? min(tk, kw0) : tk, lane) &&
                          !flash_f32::keys_on(mrow, kw0, tk, lane) &&
                          !flash_f32::keys_on(mrow, kw0 + 32, tk, lane);
  const int j_first = kw0 >= tk || masked_out
                          ? n_tiles
                          : (causal ? (kw0 - i_begin) / BQ : 0);
  const int keys[2] = {kw0 + sm90::acc_row(0, warp, lane),
                       kw0 + sm90::acc_row(2, warp, lane)};
  bool key_on[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_on[h] = keys[h] < tk && (mrow == nullptr || mrow[keys[h]] > 0.5f);
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;
  const float* lse_b = lse + (size_t)bh * tq;
  const float* delta_b = delta + (size_t)bh * tq;

  // ---- split this warpgroup's 64 rows of K and V in place: the hi part
  // over the landed values, the lo part 2·kKV beyond
  sm90::mbar_wait(bar_kv, 0);
#pragma unroll
  for (int t = 0; t < 2; ++t) {  // K, V
    for (int sp = 0; sp < kSpansD; ++sp) {
      uint8_t* const part = gbase + t * kKV + sp * kKVSpan + wg * 64 * 128;
      split_chunks(part, 2 * kKV, 512, tid % 128, 128);
    }
  }
  sm90::fence_proxy_async();  // the parts are wgmma operands now
  sm90::named_barrier(1 + wg, 128);

  float acc_dk[DP / 2], acc_dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  uint8_t* const gwork = gbase + (swork - base);
  uint8_t* const gland = gbase + (sland - base);
  for (int j = 0; j < n_tiles; ++j) {
    sm90::mbar_wait(full, j & 1);
    // both warpgroups read the whole working tile: the last tile's
    // products must be done before the split overwrites it
    if (j > 0) sm90::named_barrier(3, kConsumers);
    for (int t = 0; t < 2; ++t) {  // Q, dO: hi, lo, and their transposes'
      uint8_t* const w = gwork + t * kPart;
      flash_f32::split_rows<DP, true, true>(
          gland + t * kPart, w, w + kTile, w + 2 * kPart,
          w + kTile + 2 * kPart, tid / 32, kConsumers / 32, lane);
    }
    sm90::mbar_arrive(empty);  // TMA may bring the next tile
    sm90::fence_proxy_async();
    sm90::named_barrier(3, kConsumers);
    if (j >= j_first) {
      // ---- Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (64 keys x 32 queries): lo·hi,
      // hi·lo, hi·hi
      float st[BQ / 2], dpt[BQ / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int pass = 0; pass < 3; ++pass) {
        const uint32_t ka = pass == 0 ? skl : sk;
        const uint32_t va = pass == 0 ? svl : sv;
        const uint32_t qb = swork + (pass == 1 ? kTile : 0);
        const uint32_t db = qb + kPart;
#pragma unroll
        for (int kk = 0; kk < DP / 8; ++kk) {
          const uint32_t a =
              (kk / 4) * kKVSpan + wg * 64 * 128 + (kk % 4) * 32;
          const uint32_t b = (kk / 4) * BQ * 128 + (kk % 4) * 32;
          WgmmaTf32<BQ>::ss(st, sm90::desc_sw128(ka + a, 16, 1024),
                            sm90::desc_sw128(qb + b, 16, 1024),
                            pass > 0 || kk > 0);
          WgmmaTf32<BQ>::ss(dpt, sm90::desc_sw128(va + a, 16, 1024),
                            sm90::desc_sw128(db + b, 16, 1024),
                            pass > 0 || kk > 0);
        }
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

      // ---- P̃ᵀ and dSᵀ = P⊙(dP - Δ), split (a row is a key, a column a
      // query)
      const int i0 = i_begin + j * BQ;
      uint32_t ph[BQ / 2], pl[BQ / 2], dsh[BQ / 2], dsl[BQ / 2];
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
            sm90::tf32_split(pt, ph[i], pl[i]);
            sm90::tf32_split(p * (dp - delta_q), dsh[i], dsl[i]);
          }
        }
      }

      // ---- dv += this tile's P̃ᵀ·dO and dk += its dSᵀ·Q, each summed from
      // zero (one at a time: two tile sums at once spilled): A from
      // registers (columns 0, 2, 4, 6, 1, 3, 5, 7 of each 8-query group, as
      // dOᵀ and Qᵀ hold the queries), dOᵀ and Qᵀ K-major
      flash_f32::add_split_product<DP, BQ>(acc_dv, ph, pl, swork + 3 * kPart,
                                           swork + kTile + 3 * kPart);
      flash_f32::add_split_product<DP, BQ>(acc_dk, dsh, dsl,
                                           swork + 2 * kPart,
                                           swork + kTile + 2 * kPart);
    }
  }

  if (kw0 >= tk) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = keys[h];
    if (r >= tk) continue;
    float* dk_row = dk + ((size_t)bh * tk + r) * d;
    float* dv_row = dv + ((size_t)bh * tk + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d) {
        *reinterpret_cast<float2*>(dk_row + col) =
            make_float2(acc_dk[i] * scale, acc_dk[i + 1] * scale);
        *reinterpret_cast<float2*>(dv_row + col) =
            make_float2(acc_dv[i], acc_dv[i + 1]);
      }
    }
  }
}

struct Args {
  const float *q, *k, *v, *mask, *dout, *lse, *delta;
  const int* seed;
  float *dk, *dv;
  int bh, tq, tk, d;
  float scale;
  int causal;
  float rate, inv_keep;
};

template <bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mdo, mk, mv;
  if (!sm90::make_map(&mq, a.q, 0, a.bh, a.tq, a.d, BQ) ||
      !sm90::make_map(&mdo, a.dout, 0, a.bh, a.tq, a.d, BQ) ||
      !sm90::make_map(&mk, a.k, 0, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mv, a.v, 0, a.bh, a.tk, a.d, kKeys))
    return -2;
  auto kernel = flash_dkv_f32_sm90<DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tk + kKeys - 1) / kKeys, a.bh);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      mq, mdo, mk, mv, a.mask, a.lse, a.delta, a.seed, a.dk, a.dv,
      a.tq, a.tk, a.d, a.scale, a.causal, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dl4j_flash_attn_dkv's contract and signature for float32 (dtype 0) with
// D % 8 == 0 and D <= 64; q, k, v and dout 16-byte aligned. Returns
// cudaGetLastError() of the launch, -1 for another dtype or an unsupported
// head dim, -2 when a tensor map cannot be encoded. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_flash_attn_dkv_f32_sm90(
    const float* q, const float* k, const float* v, const float* mask,
    const float* dout, const float* lse, const float* delta, const int* seed,
    float* dk, float* dv, int bh, int tq, int tk, int d, float scale,
    int causal, float rate, float inv_keep, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tk <= 0) return 0;
  if (dtype != 0 || d <= 0 || d % 8 != 0 || d > DP) return -1;
  if (tq <= 0) {  // no queries: dk and dv are 0 (no zero-extent map)
    const size_t bytes = (size_t)bh * tk * d * sizeof(float);
    cudaMemsetAsync(dk, 0, bytes, s);
    return static_cast<int>(cudaMemsetAsync(dv, 0, bytes, s));
  }
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dk,
               dv, bh, tq, tk,   d,     scale,  causal, rate, inv_keep};
  return rate > 0.f ? launch<true>(a, s) : launch<false>(a, s);
}
