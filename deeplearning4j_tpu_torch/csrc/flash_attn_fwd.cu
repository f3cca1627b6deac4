// flash_attn_fwd.cu — blockwise (FlashAttention-2) attention forward on the
// CUDA cores (sm_90a), float32 accumulation: float32 and 16-bit inputs with
// 128 < D <= 256 (D % 8 == 0). With D <= 128, 16-bit inputs run the
// tensor-core kernel of flash_attn_fwd_sm90.cu and float32 inputs that of
// flash_attn_fwd_f32_sm90.cu (`cuda_attention.flash_design`).
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_attn_kernel`,
// reached through `_flash_fwd` (the Pallas forward behind `flash_dpa`, the
// TPU platform helper of `dot_product_attention`). Same contract: q, k, v
// (BH, T, D) row-major; an optional key mask (BH, Tk) of 0/1 floats; an
// optional START-aligned causal mask (key j visible to query i iff j <= i);
// masked scores are -1e30 as in the TPU kernel; optional attention dropout
// in the kernel (`_keep_mask`, flash_common.cuh): each probability is
// dropped after the denominator update and the kept ones scaled by
// 1/(1-rate), so neither the scores nor the mask reach device memory.
// Outputs are out (BH, Tq, D) in the input type and lse (BH, Tq) in
// float32. The backward kernels are flash_attn_bwd.cu.
//
// What bounds it on the H100: at the head dims it takes (D 192, 256) and
// T 512 a head does 4·D·T² flops against 4·T·D elements moved, ~T flops an
// element, so the card's arithmetic, not its memory, is the limit; this kernel runs it on the CUDA cores (67 TFLOP/s in float32).
// With D <= 128 both paths run on the tensor cores: 16-bit in
// flash_attn_fwd_sm90.cu, float32 in flash_attn_fwd_f32_sm90.cu, whose
// products are accurate to float32 by split TF32 passes (hi·lo, lo·hi,
// hi·hi), never single-pass TF32, and held to the same float32 checks as
// this kernel, unchanged.
//
// Design, and what it does about the TPU original:
//  * The Pallas grid walks the kv blocks as a sequential ('arbitrary') grid
//    axis with the running max / denominator / accumulator carried in VMEM
//    scratch. Blocks on Hopper run in no order, so here ONE block owns one
//    tile of ROWS query rows for one (batch*head) and loops over the K/V
//    tiles itself; nothing is carried between blocks.
//  * A query row belongs to a group of G = 8 threads. Thread g of the
//    group keeps dims g, g+G, g+2G, ... of the row's q and of its float32
//    accumulator in registers (DT = 32 floats each, so nothing spills);
//    its partial dot
//    products are summed across the group with warp shuffles. The strided
//    split keeps the group's shared-memory reads on distinct banks.
//  * Each K/V tile (BK rows) is staged once through shared memory in float32
//    at the padded width DT*G, the columns past D zero, and read by every
//    row of the block: a zero q entry times a zero key column adds nothing,
//    so the inner loops need no head-dim guard. The online softmax runs over
//    chunks of kChunk keys (one rescale per chunk).
//  * Whole tiles that start past the block's last row are skipped under the
//    causal mask (the TPU kernel's `run` predicate), and each row stops at
//    its own position inside the last tile.
//  * The ragged edge is masked in the kernel: keys >= Tk are never loaded
//    and queries >= Tq are never written. Nothing is padded in device
//    memory as `_pad_to_blocks` does on the TPU.
//  * A row whose keys are all masked gets finite values (the -1e30 fill,
//    as on the TPU), never NaN.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

#include "flash_common.cuh"

namespace {

using flash::from_f32;
using flash::keep_element;
using flash::kMasked;
using flash::kMaxHeadDim;
using flash::to_f32;

constexpr int kChunk = 16;  // keys per online-softmax rescale

// Tile geometry of one instantiation: DT dims per thread, G threads per row.
template <int DT, int G>
struct Tile {
  static_assert(G >= 2 && G <= 16 && 32 % G == 0, "a row group lies in a warp");
  static constexpr int DP = DT * G;          // padded head dim
  static constexpr int ROWS = 256 / G;       // query rows per block
  static constexpr int THREADS = ROWS * G;
  static constexpr int BK = 4096 / DP;       // staged keys per tile
};

// DROP: attention dropout at `rate` (keep mask from `*seed`); the
// instantiation without it is the rate-0 path, untouched by dropout.
template <typename T, int DT, int G, bool DROP>
__global__ void __launch_bounds__(Tile<DT, G>::THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ out, float* __restrict__ lse, int tq,
                 int tk, int d, float scale, int causal,
                 const int* __restrict__ seed, float rate, float inv_keep) {
  using Tl = Tile<DT, G>;
  constexpr int DP = Tl::DP, BK = Tl::BK, ROWS = Tl::ROWS;
  constexpr int NT = Tl::THREADS;
  __shared__ float ks[BK][DP];
  __shared__ float vs[BK][DP];
  __shared__ float ms[BK];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int g = tid % G;  // this thread holds dims g, g+G, ... of its row
  const int qi = q0 + tid / G;
  const bool row_ok = qi < tq;
  // the lanes of this row's group, for the partial-dot shuffles
  const unsigned lanes = ((1u << G) - 1u) << ((tid % 32) / G * G);

  const T* qb = q + (size_t)bh * tq * d;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;

  float qr[DT];
  float acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int c = i * G + g;
    qr[i] = (row_ok && c < d) ? to_f32(qb[(size_t)qi * d + c]) : 0.f;
    acc[i] = 0.f;
  }
  float m = kMasked;  // running row max
  float l = 0.f;      // running softmax denominator
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;

  // causal whole-tile skip: no row of this block sees keys past its last row
  const int q_last = min(q0 + ROWS, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;

  // staging: each thread owns one column of the tile and every RSTEP-th
  // row, so the row loop has a fixed trip count and a fixed pointer stride
  constexpr int RSTEP = NT / DP;
  static_assert(RSTEP * DP == NT && BK % RSTEP == 0, "staging must tile");
  const int sc_col = tid % DP;
  const int sr0 = tid / DP;
  const bool col_ok = sc_col < d;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    const int nk = min(BK, k_end - k0);
    __syncthreads();  // the previous tile is consumed by every row
    const size_t first = (size_t)(k0 + sr0) * d + sc_col;
    for (int i = 0; i < BK / RSTEP; ++i) {
      const int r = sr0 + i * RSTEP;
      float kv = 0.f, vv = 0.f;
      if (col_ok && r < nk) {
        const size_t e = first + (size_t)i * RSTEP * d;
        kv = to_f32(kb[e]);
        vv = to_f32(vb[e]);
      }
      ks[r][sc_col] = kv;
      vs[r][sc_col] = vv;
    }
    for (int r = tid; r < BK; r += NT) {
      ms[r] = (r < nk) ? (mask ? mask[(size_t)bh * tk + k0 + r] : 1.f) : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
    // keys of this tile the row attends to: causal rows stop at themselves
    // (the same for every thread of the row's group)
    const int jn = causal ? min(nk, qi - k0 + 1) : nk;
    for (int j0 = 0; j0 < jn; j0 += kChunk) {
      float s[kChunk];
      float cmax = m;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        float sc = -CUDART_INF_F;  // past the row's keys: weight exactly 0
        if (j < jn) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < DT; ++i) dot = fmaf(qr[i], ks[j][i * G + g], dot);
#pragma unroll
          for (int off = G / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(lanes, dot, off);
          sc = ms[j] > 0.5f ? dot * scale : kMasked;
        }
        s[jj] = sc;
        cmax = fmaxf(cmax, sc);
      }
      const float alpha = expf(m - cmax);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int j = j0 + jj;
        if (j < jn) {
          float p = expf(s[jj] - cmax);
          // the denominator takes the un-dropped p; dropout hits the
          // normalized probabilities, as on the TPU
          l += p;
          if (DROP) {
            if (!keep_element(seed_v, bh, qi, k0 + j, rate)) continue;
            p *= inv_keep;
          }
#pragma unroll
          for (int i = 0; i < DT; ++i)
            acc[i] = fmaf(p, vs[j][i * G + g], acc[i]);
        }
      }
      m = cmax;
    }
  }

  if (row_ok) {
    const float ls = fmaxf(l, 1e-30f);
    T* ob = out + ((size_t)bh * tq + qi) * d;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int c = i * G + g;
      if (c < d) ob[c] = from_f32<T>(acc[i] / ls);
    }
    if (g == 0) lse[(size_t)bh * tq + qi] = m + logf(ls);
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
};

template <typename T, int DT, int G, bool DROP>
int launch(const Args& a, cudaStream_t stream) {
  using Tl = Tile<DT, G>;
  const dim3 grid((a.tq + Tl::ROWS - 1) / Tl::ROWS, a.bh);
  flash_fwd_kernel<T, DT, G, DROP><<<grid, Tl::THREADS, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.tq, a.tk, a.d,
      a.scale, a.causal, a.seed, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool DROP>
int dispatch_d(const Args& a, cudaStream_t s) {
  // D <= 128 runs flash_attn_fwd_sm90.cu (16-bit) or
  // flash_attn_fwd_f32_sm90.cu (float32)
  if (a.d <= 128 || a.d % 8 != 0 || a.d > kMaxHeadDim) return -1;
  return launch<T, 32, 8, DROP>(a, s);
}

template <typename T>
int dispatch_drop(const Args& a, cudaStream_t s) {
  return a.rate > 0.f ? dispatch_d<T, true>(a, s) : dispatch_d<T, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; D > 128 only.
// mask may be null (every key visible). rate: attention-dropout rate in
// [0, 1); above 0, `seed` points to one int32 on the device and inv_keep is
// 1 / (1 - rate); at 0 both are ignored. Returns cudaGetLastError() of the
// launch, or -1 for an unsupported dtype or head dim (D % 8 != 0, D > 256,
// or D <= 128). Launches on `stream`; allocates nothing.
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, const void* mask, void* out,
                                   void* lse, int bh, int tq, int tk, int d,
                                   float scale, int causal, const void* seed,
                                   float rate, float inv_keep, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bh <= 0 || tq <= 0) return 0;
  const Args a{q,     k,     v,      mask,
               out,   lse,   bh,     tq,
               tk,    d,     scale,  causal,
               static_cast<const int*>(seed), rate, inv_keep};
  if (dtype == 0) return dispatch_drop<float>(a, s);
  if (dtype == 1) return dispatch_drop<__nv_bfloat16>(a, s);
  if (dtype == 2) return dispatch_drop<__half>(a, s);
  return -1;
}
