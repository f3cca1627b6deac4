// flash_attn_bwd.cu — blockwise (FlashAttention-2) attention backward on the
// CUDA cores (sm_90a): dq in one kernel, dk and dv in another. float32
// accumulation, any head dim D with D % 8 == 0 up to 256, the gradients
// written in the input type. Both take float32 with D > 64, and bfloat16
// and float16 with D > 128 (16-bit inputs with D <= 128 run the
// tensor-core kernels of flash_attn_dq_sm90.cu and flash_attn_dkv_sm90.cu,
// float32 with D <= 64 those of flash_attn_dq_f32_sm90.cu and
// flash_attn_dkv_f32_sm90.cu).
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py `_dq_kernel` and
// `_dkv_kernel`, reached through `_flash_bwd` (the backward of the
// `flash_attention` custom VJP behind `flash_dpa`). Same contract: q, k, v,
// dO (BH, T, D) row-major; the forward's lse (BH, Tq) and Δ = rowsum(dO·O)
// (BH, Tq), both float32 (Δ is a torch reduction, as the JAX package
// computes it outside Pallas); an optional key mask (BH, Tk) of 0/1 floats;
// an optional START-aligned causal mask; optional attention dropout whose
// keep mask is regenerated from the forward's seed (flash_common.cuh).
// With p = exp(s - lse), dp = dO·vᵀ masked and scaled like p, and
// ds = p·(dp - Δ):
//   dq = scale · ds·K,   dk = scale · dsᵀ·Q,   dv = p̃ᵀ·dO  (p̃: p after dropout)
//
// What bounds it on the H100: dq does 6·D and dk/dv 8·D operations per
// visible (query, key) pair against one read of q, k, v, dO; at BERT's
// shapes (BH 384 × T 128, BH 96 × T 512, D 64) that is ~20-80 operations a
// byte, so the arithmetic is the limit. These kernels run it on the CUDA
// cores in float32 (67 TFLOP/s); the 16-bit dq and dk/dv with D <= 128 run
// on the tensor cores in flash_attn_dq_sm90.cu and flash_attn_dkv_sm90.cu,
// and the float32 ones with D <= 64 there too, every product split into
// TF32 parts, in flash_attn_dq_f32_sm90.cu and flash_attn_dkv_f32_sm90.cu.
//
// Design, and what it does about the TPU original:
//  * The Pallas kernels carry their accumulators in VMEM across a
//    sequential grid axis (kv for dq, q for dk/dv). Here one block owns a
//    tile of rows and walks the other side itself: the dq block owns query
//    rows and streams K/V tiles; the dk/dv block owns key rows and streams
//    Q/dO tiles with their lse and Δ. Every output element is written by
//    one thread, once, in a fixed order: no atomics, no second pass, and
//    the gradients are the same bits on every run.
//  * A row belongs to a group of G threads (G = 4 for D <= 128, 8 for
//    D <= 256); thread g keeps dims g, g+G,
//    ... (32 per thread) of its row's operands and accumulators in
//    registers — dq: q, dO, dq; dk/dv: k, v, dk, dv — and the two dot
//    products per pair are summed across the group with warp shuffles.
//  * The streamed tile is staged once in shared memory in float32 at the
//    padded width 32·G, the columns past D zero, and read by every row of
//    the block, as in the forward.
//  * Causal: the dq block stops at its last row's key and each row at its
//    own; the dk/dv block starts at its first key's query row and each row
//    at its own. Pairs past the diagonal are never visited (their p is 0).
//  * A row whose keys are all masked gets the finite values the TPU
//    kernels give (p = exp(-1e30 - lse) over the -1e30 fill), never NaN.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

#include "flash_common.cuh"

namespace {

using flash::from_f32;
using flash::keep_element;
using flash::kMasked;
using flash::kMaxHeadDim;
using flash::to_f32;

constexpr int kDT = 32;  // head dims per thread

// Tile geometry for G threads per row.
template <int G>
struct Tile {
  static_assert(G == 4 || G == 8, "a row group lies in a warp");
  static constexpr int DP = kDT * G;                         // padded D
  static constexpr int THREADS = 256;
  static constexpr int ROWS = THREADS / G;                   // owned rows
  static constexpr int BS = 4096 / DP;                       // streamed rows
  static constexpr int RSTEP = THREADS / DP;                 // staging stride
  static_assert(RSTEP * DP == THREADS && BS % RSTEP == 0, "staging tiles");
};

template <int G>
__device__ __forceinline__ unsigned group_lanes(int tid) {
  return ((1u << G) - 1u) << ((tid % 32) / G * G);
}

template <int G>
__device__ __forceinline__ float group_sum(unsigned lanes, float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) x += __shfl_xor_sync(lanes, x, off);
  return x;
}

// Stage rows [r0, r0 + n) of two (T, d) matrices into float32 tiles of BS
// rows at the padded width DP (zeros past d and past n).
template <typename T, int G>
__device__ __forceinline__ void stage_pair(
    const T* __restrict__ a, const T* __restrict__ b, int r0, int n, int d,
    float (*as)[Tile<G>::DP], float (*bs)[Tile<G>::DP]) {
  using Tl = Tile<G>;
  const int tid = threadIdx.x;
  const int col = tid % Tl::DP;
  const int row0 = tid / Tl::DP;
  const bool col_ok = col < d;
  const size_t first = (size_t)(r0 + row0) * d + col;
#pragma unroll 4
  for (int i = 0; i < Tl::BS / Tl::RSTEP; ++i) {
    const int r = row0 + i * Tl::RSTEP;
    float x = 0.f, y = 0.f;
    if (col_ok && r < n) {
      const size_t e = first + (size_t)i * Tl::RSTEP * d;
      x = to_f32(a[e]);
      y = to_f32(b[e]);
    }
    as[r][col] = x;
    bs[r][col] = y;
  }
}

// dq: one block owns ROWS query rows of one batch*head and walks the K/V
// tiles (the TPU's sequential kv grid axis).
template <typename T, int G, bool DROP>
__global__ void __launch_bounds__(Tile<G>::THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ mask,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ seed,
                T* __restrict__ dq, int tq, int tk, int d, float scale,
                int causal, float rate, float inv_keep) {
  using Tl = Tile<G>;
  constexpr int DP = Tl::DP, BS = Tl::BS, ROWS = Tl::ROWS;
  __shared__ float ks[BS][DP];
  __shared__ float vs[BS][DP];
  __shared__ float ms[BS];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int qi = q0 + tid / G;
  const bool row_ok = qi < tq;
  const unsigned lanes = group_lanes<G>(tid);

  const size_t row = ((size_t)bh * tq + qi) * d;
  float qr[kDT], dor[kDT], acc[kDT];
#pragma unroll
  for (int i = 0; i < kDT; ++i) {
    const int c = i * G + g;
    const bool ok = row_ok && c < d;
    qr[i] = ok ? to_f32(q[row + c]) : 0.f;
    dor[i] = ok ? to_f32(dout[row + c]) : 0.f;
    acc[i] = 0.f;
  }
  const float lse_i = row_ok ? lse[(size_t)bh * tq + qi] : 0.f;
  const float delta_i = row_ok ? delta[(size_t)bh * tq + qi] : 0.f;
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;

  const int q_last = min(q0 + ROWS, tq) - 1;
  const int k_end = causal ? min(tk, q_last + 1) : tk;
  const T* kb = k + (size_t)bh * tk * d;
  const T* vb = v + (size_t)bh * tk * d;

  for (int k0 = 0; k0 < k_end; k0 += BS) {
    const int nk = min(BS, k_end - k0);
    __syncthreads();  // the previous tile is consumed by every row
    stage_pair<T, G>(kb, vb, k0, nk, d, ks, vs);
    for (int r = tid; r < BS; r += Tl::THREADS)
      ms[r] = (r < nk) ? (mask ? mask[(size_t)bh * tk + k0 + r] : 1.f) : 0.f;
    __syncthreads();
    if (!row_ok) continue;
    const int jn = causal ? min(nk, qi - k0 + 1) : nk;
    for (int j = 0; j < jn; ++j) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        sd = fmaf(qr[i], ks[j][i * G + g], sd);
        pd = fmaf(dor[i], vs[j][i * G + g], pd);
      }
      sd = group_sum<G>(lanes, sd);
      pd = group_sum<G>(lanes, pd);
      const float s = ms[j] > 0.5f ? sd * scale : kMasked;
      const float p = expf(s - lse_i);
      if (DROP)
        pd = keep_element(seed_v, bh, qi, k0 + j, rate) ? pd * inv_keep : 0.f;
      const float ds = p * (pd - delta_i);
#pragma unroll
      for (int i = 0; i < kDT; ++i) acc[i] = fmaf(ds, ks[j][i * G + g], acc[i]);
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int c = i * G + g;
      if (c < d) dq[row + c] = from_f32<T>(acc[i] * scale);
    }
  }
}

// dk/dv: one block owns ROWS key rows of one batch*head and walks the Q/dO
// tiles with their lse and Δ (the TPU's sequential q grid axis).
template <typename T, int G, bool DROP>
__global__ void __launch_bounds__(Tile<G>::THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const int* __restrict__ seed, T* __restrict__ dk,
                 T* __restrict__ dv, int tq, int tk, int d, float scale,
                 int causal, float rate, float inv_keep) {
  using Tl = Tile<G>;
  constexpr int DP = Tl::DP, BS = Tl::BS, ROWS = Tl::ROWS;
  __shared__ float qs[BS][DP];
  __shared__ float dos[BS][DP];
  __shared__ float ls[BS];
  __shared__ float dls[BS];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int g = tid % G;
  const int kj = k0 + tid / G;
  const bool row_ok = kj < tk;
  const unsigned lanes = group_lanes<G>(tid);

  const size_t row = ((size_t)bh * tk + kj) * d;
  float kr[kDT], vr[kDT], dka[kDT], dva[kDT];
#pragma unroll
  for (int i = 0; i < kDT; ++i) {
    const int c = i * G + g;
    const bool ok = row_ok && c < d;
    kr[i] = ok ? to_f32(k[row + c]) : 0.f;
    vr[i] = ok ? to_f32(v[row + c]) : 0.f;
    dka[i] = 0.f;
    dva[i] = 0.f;
  }
  const bool key_on =
      row_ok && (mask == nullptr || mask[(size_t)bh * tk + kj] > 0.5f);
  const unsigned seed_v = DROP ? static_cast<unsigned>(seed[0]) : 0u;

  // causal: query i sees key j iff j <= i, so no query row below this
  // block's first key contributes
  const int i_begin = causal ? k0 : 0;
  const T* qb = q + (size_t)bh * tq * d;
  const T* db = dout + (size_t)bh * tq * d;

  for (int i0 = i_begin; i0 < tq; i0 += BS) {
    const int ni = min(BS, tq - i0);
    __syncthreads();  // the previous tile is consumed by every row
    stage_pair<T, G>(qb, db, i0, ni, d, qs, dos);
    for (int r = tid; r < BS; r += Tl::THREADS) {
      const bool ok = r < ni;
      ls[r] = ok ? lse[(size_t)bh * tq + i0 + r] : 0.f;
      dls[r] = ok ? delta[(size_t)bh * tq + i0 + r] : 0.f;
    }
    __syncthreads();
    if (!row_ok) continue;
    const int ib = causal ? max(0, kj - i0) : 0;
    for (int ii = ib; ii < ni; ++ii) {
      float sd = 0.f, pd = 0.f;
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        sd = fmaf(kr[i], qs[ii][i * G + g], sd);
        pd = fmaf(vr[i], dos[ii][i * G + g], pd);
      }
      sd = group_sum<G>(lanes, sd);
      pd = group_sum<G>(lanes, pd);
      const float s = key_on ? sd * scale : kMasked;
      const float p = expf(s - ls[ii]);
      float pt = p;  // p after dropout
      if (DROP) {
        if (keep_element(seed_v, bh, i0 + ii, kj, rate)) {
          pt *= inv_keep;
          pd *= inv_keep;
        } else {
          pt = 0.f;
          pd = 0.f;
        }
      }
      const float ds = p * (pd - dls[ii]) * scale;
#pragma unroll
      for (int i = 0; i < kDT; ++i) {
        dka[i] = fmaf(ds, qs[ii][i * G + g], dka[i]);
        dva[i] = fmaf(pt, dos[ii][i * G + g], dva[i]);
      }
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < kDT; ++i) {
      const int c = i * G + g;
      if (c < d) {
        dk[row + c] = from_f32<T>(dka[i]);
        dv[row + c] = from_f32<T>(dva[i]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta, *seed;
  void *g0, *g1;  // dq, or dk and dv
  int bh, tq, tk, d;
  float scale;
  int causal;
  float rate, inv_keep;
};

template <typename T, int G, bool DROP>
int launch_dq(const Args& a, cudaStream_t s) {
  using Tl = Tile<G>;
  const dim3 grid((a.tq + Tl::ROWS - 1) / Tl::ROWS, a.bh);
  flash_dq_kernel<T, G, DROP><<<grid, Tl::THREADS, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seed),
      static_cast<T*>(a.g0), a.tq, a.tk, a.d, a.scale, a.causal, a.rate,
      a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int G, bool DROP>
int launch_dkv(const Args& a, cudaStream_t s) {
  using Tl = Tile<G>;
  const dim3 grid((a.tk + Tl::ROWS - 1) / Tl::ROWS, a.bh);
  flash_dkv_kernel<T, G, DROP><<<grid, Tl::THREADS, 0, s>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<const int*>(a.seed),
      static_cast<T*>(a.g0), static_cast<T*>(a.g1), a.tq, a.tk, a.d, a.scale,
      a.causal, a.rate, a.inv_keep);
  return static_cast<int>(cudaGetLastError());
}

template <bool DKV, typename T, bool DROP>
int dispatch_d(const Args& a, cudaStream_t s) {
  if (a.d <= 0 || a.d % 8 != 0 || a.d > kMaxHeadDim) return -1;
  if constexpr (std::is_same<T, float>::value) {
    // float32 D <= 64: flash_attn_dq_f32_sm90.cu and flash_attn_dkv_f32_sm90.cu
    if (a.d <= 64) return -1;
    if constexpr (!DKV) {
      if (a.d <= 128) return launch_dq<T, 4, DROP>(a, s);
      return launch_dq<T, 8, DROP>(a, s);
    } else {
      if (a.d <= 128) return launch_dkv<T, 4, DROP>(a, s);
      return launch_dkv<T, 8, DROP>(a, s);
    }
  } else {
    // 16-bit D <= 128: flash_attn_dq_sm90.cu and flash_attn_dkv_sm90.cu
    if (a.d <= 128) return -1;
    if constexpr (!DKV) return launch_dq<T, 8, DROP>(a, s);
    else return launch_dkv<T, 8, DROP>(a, s);
  }
}

template <bool DKV>
int dispatch(const Args& a, int dtype, cudaStream_t s) {
  const bool drop = a.rate > 0.f;
  if (dtype == 0)
    return drop ? dispatch_d<DKV, float, true>(a, s)
                : dispatch_d<DKV, float, false>(a, s);
  if (dtype == 1)
    return drop ? dispatch_d<DKV, __nv_bfloat16, true>(a, s)
                : dispatch_d<DKV, __nv_bfloat16, false>(a, s);
  if (dtype == 2)
    return drop ? dispatch_d<DKV, __half, true>(a, s)
                : dispatch_d<DKV, __half, false>(a, s);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout and the
// gradients); mask, lse and delta are float32, mask may be null. rate:
// dropout rate of the forward; above 0, `seed` points to the forward's
// int32 seed on the device and inv_keep is 1 / (1 - rate). Each returns
// cudaGetLastError() of its launch, or -1 for an unsupported dtype or head
// dim (also a float32 D <= 64 and a 16-bit D <= 128). Launch on `stream`;
// allocate nothing.
extern "C" int dl4j_flash_attn_dq(const void* q, const void* k, const void* v,
                                  const void* mask, const void* dout,
                                  const void* lse, const void* delta,
                                  const void* seed, void* dq, int bh, int tq,
                                  int tk, int d, float scale, int causal,
                                  float rate, float inv_keep, int dtype,
                                  void* stream) {
  if (bh <= 0 || tq <= 0) return 0;
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dq, nullptr,
               bh, tq, tk, d,    scale, causal, rate,  inv_keep};
  return dispatch<false>(a, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_flash_attn_dkv(const void* q, const void* k,
                                   const void* v, const void* mask,
                                   const void* dout, const void* lse,
                                   const void* delta, const void* seed,
                                   void* dk, void* dv, int bh, int tq, int tk,
                                   int d, float scale, int causal, float rate,
                                   float inv_keep, int dtype, void* stream) {
  if (bh <= 0 || tk <= 0) return 0;
  const Args a{q,  k,  v,  mask, dout,  lse,    delta, seed,     dk, dv,
               bh, tq, tk, d,    scale, causal, rate,  inv_keep};
  return dispatch<true>(a, dtype, static_cast<cudaStream_t>(stream));
}
