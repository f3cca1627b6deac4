// flash_attn_fwd_sm90.cu — FlashAttention-2 forward on Hopper's tensor cores
// for bfloat16 and float16 inputs with head dim D <= 128 (sm_90a), float32
// accumulation. The float32 inputs and 16-bit inputs with D > 128 keep the
// CUDA-core kernel of flash_attn_fwd.cu.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_attn_kernel`
// (pallas_call in `_flash_fwd`), as flash_attn_fwd.cu does, with the same
// contract (`dl4j_flash_attn_fwd`): q, k, v (BH, T, D) row-major; an optional
// key mask (BH, Tk) of 0/1 floats (masked scores are -1e30, as on the TPU);
// an optional START-aligned causal mask (key j visible to query i iff
// j <= i); optional attention dropout in the kernel with the TPU's keep hash
// (flash_common.cuh `keep_element`), applied after the denominator update;
// out (BH, Tq, D) in the input type and lse (BH, Tq) in float32.
//
// Numerics: S = Q·Kᵀ accumulates exact 16-bit products in float32; P (after
// dropout, unnormalized) is rounded to the input type before O += P·V, as
// the TPU kernel's `_mm` rounds p before p @ v. O stays float32 in registers
// and is scaled by 1/l once at the end.
//
// What bounds it on the H100: at BERT's shapes (BH 96 × T 512, D 64) the
// work is 6.4 GFLOP against ~25 MB, ~250 operations a byte, so the tensor
// cores' 989 TFLOP/s (bf16), not the memory, are the limit; the exp and the
// dropout hash of every score run on the CUDA cores beside them.
//
// Design:
//  * One block owns 128 query rows of one batch·head: two consumer
//    warpgroups of 64 rows and one producer warp. Grid (⌈Tq/128⌉, BH).
//  * The producer loads Q once and streams K and V tiles of 64 keys into a
//    two-stage shared-memory ring with TMA (3-D tensor maps over (D, T, BH):
//    rows past T and columns past D read as zeros, never another head's
//    rows), each stage completed on a `full` mbarrier and released by the
//    256 consumer threads on an `empty` one.
//  * S = Q·Kᵀ is one wgmma m64n64k16 chain with both operands in
//    128-byte-swizzled shared memory. The scale, the masks, the online max
//    and sum and the rescale run on the accumulator registers; a row lives
//    in the 4 threads of a quad, so its max takes two shuffles (the sum is
//    reduced once, at the end).
//  * O += P·V takes P from registers as wgmma's A operand (the accumulator
//    layout of S is the A-fragment layout) and V from shared memory through
//    the transpose bit (V is MN-major for this product). No P or S reaches
//    shared or device memory.
//  * Keys >= Tk and causal keys past the row get -inf (weight exactly 0);
//    whole tiles past the block's last row are not loaded, and a
//    warpgroup skips the tiles past its own last row. A row whose keys are
//    all masked gets the -1e30 fill's mean of V, as the plain version.
//  * Every output is written once, by one thread: no atomics.

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

constexpr int kRows = 128;         // query rows per block (2 warpgroups)
constexpr int kKeys = 64;          // keys per K/V tile
constexpr int kConsumers = 256;    // consumer threads
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kSlab = 64;          // 16-bit columns per 128-byte slab
constexpr float kLog2e = 1.4426950408889634f;

template <int DP>
struct Layout {
  static constexpr int kSlabs = DP / kSlab;
  static constexpr uint32_t kQ = kSlabs * kRows * 128;    // Q, both WGs
  static constexpr uint32_t kKV = kSlabs * kKeys * 128;   // one K or V tile
  static constexpr uint32_t kSmem = kQ + 4 * kKV + 1024;  // + alignment
};

template <typename T, int DP, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const float* __restrict__ mask, T* __restrict__ out,
               float* __restrict__ lse, int tq, int tk, int d, float scale,
               int causal, const int* __restrict__ seed, float rate,
               float inv_keep) {
  using L = Layout<DP>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[5];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = sq + L::kQ;
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

  if (tid >= kConsumers) {  // the producer warp: one thread issues TMA
    if (tid == kConsumers) {
      sm90::mbar_arrive_expect_tx(bar_q, L::kQ);
      for (int sl = 0; sl < L::kSlabs; ++sl)
        sm90::tma_load_3d(sq + sl * kRows * 128, &tm_q, bar_q, sl * kSlab,
                          q0, bh);
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
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;
  const float* mrow = mask ? mask + (size_t)bh * tk : nullptr;

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running row max
  float l[2] = {0.f, 0.f};  // this thread's share of the running sum

  sm90::mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    sm90::mbar_wait(full(s), (j >> 1) & 1);
    if (j < n_wg) {
      // ---- S = Q·Kᵀ (64 rows x 64 keys)
      float sc[32];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t a = sq + (kk / 4) * kRows * 128 + wg * 64 * 128 +
                           (kk % 4) * 32;
        const uint32_t b = sk + s * L::kKV + (kk / 4) * kKeys * 128 +
                           (kk % 4) * 32;
        Wgmma<64, T>::template ss<0>(sc, sm90::desc_sw128(a, 16, 1024),
                                     sm90::desc_sw128(b, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);

      // ---- scale and masks; the tile's row max
      const int k0 = j * kKeys;
      float mx[2] = {m[0], m[1]};
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
            float x = sc[i] * scale;
            if (!on) x = kMasked;
            if (!in || (causal && col > rows[h])) x = -CUDART_INF_F;
            sc[i] = x;
            mx[h] = fmaxf(mx[h], x);
          }
        }
      }
      // ---- online softmax: rescale, exponentiate, drop
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
#pragma unroll
      for (int i = 0; i < 32; ++i) {
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
        sc[i] = p;
      }
      sm90::fence_regs(o);
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      sm90::fence_regs(o);

      // ---- O += P·V: P from registers, V MN-major through the transpose
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t pa[4];
        sm90::acc_to_a<T>(sc, kk, pa);
        const uint32_t b = sv + s * L::kKV + kk * 16 * 128;
        Wgmma<DP, T>::template rs<1>(
            o, pa, sm90::desc_sw128(b, kKeys * 128, 1024));
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
    T* orow = out + ((size_t)bh * tq + r) * d;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int i = 4 * n + 2 * h;
      const int col = sm90::acc_col(i, lane);
      if (col < d) {
        const uint32_t v = sm90::pack2<T>(o[i] / ls, o[i + 1] / ls);
        *reinterpret_cast<uint32_t*>(orow + col) = v;
      }
    }
    if ((lane & 3) == 0) lse[(size_t)bh * tq + r] = m[h] + logf(ls);
  }
}

struct Args {
  const void *q, *k, *v, *mask;
  void *out, *lse;
  int bh, tq, tk, d;
  float scale;
  int causal;
  const int* seed;
  float rate, inv_keep;
  int dtype;
};

template <typename T, int DP, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  using L = Layout<DP>;
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map(&mq, a.q, a.dtype, a.bh, a.tq, a.d, kRows) ||
      !sm90::make_map(&mk, a.k, a.dtype, a.bh, a.tk, a.d, kKeys) ||
      !sm90::make_map(&mv, a.v, a.dtype, a.bh, a.tk, a.d, kKeys))
    return -2;
  auto kernel = flash_fwd_sm90<T, DP, DROP>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((a.tq + kRows - 1) / kRows, a.bh);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(
      mq, mk, mv, static_cast<const float*>(a.mask), static_cast<T*>(a.out),
      static_cast<float*>(a.lse), a.tq, a.tk, a.d, a.scale, a.causal, a.seed,
      a.rate, a.inv_keep);
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

// dl4j_flash_attn_fwd's contract for dtype 1 = bfloat16 and 2 = float16
// with D % 8 == 0 and D <= 128; q, k and v 16-byte aligned. Returns
// cudaGetLastError() of the launch, -1 for an unsupported dtype or head
// dim, -2 when a tensor map cannot be encoded. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_flash_attn_fwd_sm90(const void* q, const void* k,
                                        const void* v, const void* mask,
                                        void* out, void* lse, int bh, int tq,
                                        int tk, int d, float scale, int causal,
                                        const void* seed, float rate,
                                        float inv_keep, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0) return 0;
  const Args a{q,     k,   v,      mask,  out,
               lse,   bh,  tq,     tk,    d,
               scale, causal, static_cast<const int*>(seed), rate, inv_keep,
               dtype};
  if (dtype == 1) return dispatch_drop<__nv_bfloat16>(a, s);
  if (dtype == 2) return dispatch_drop<__half>(a, s);
  return -1;
}
