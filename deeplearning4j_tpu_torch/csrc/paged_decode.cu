// paged_decode.cu — decode-step attention over a block-paged KV cache for
// Hopper (sm_90a), float32, bfloat16 and float16 caches, float32 scores,
// any head dim D with D % 8 == 0 up to 256.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py
// `_paged_decode_kernel`, reached through `_paged_decode_call`. Same
// contract as `paged_decode_attention_xla`: one query per slot,
// q (S, H, D), attends over k/v_pages (P+1, page, H, D) through
// page_table (S, max_pages) int32; positions >= seq_lens[s] are masked.
// Output (S, H, D) in the input type.
//
// What bounds it on the H100: memory. Each (slot, head) reads its
// seq_len keys and values once and does 4*D flops per key, at most one flop
// per byte — far below the card's ~20 flops/byte (float32) balance point.
// The least time is the cache bytes the live sequences own over 3.35 TB/s.
//
// Design, and what it does about the TPU original:
//  * Pallas walks ALL max_pages pages of every slot (grid (S, max_pages))
//    with the page table in scalar-prefetch memory. Here one block owns one
//    (slot, head), reads its own page-table row, and walks only
//    ceil(seq_len / page) pages, so short sequences cost what they hold.
//  * Keys are staged KEYS at a time through shared memory (any page size:
//    the chunk crosses page boundaries by looking each position's page up),
//    in float32, at the padded width DP (32, 64, 128 or 256) with the
//    columns past D zero, so the dot products need no head-dim guard. Each
//    chunk first looks its positions' pages up into shared memory; then
//    every thread issues all its 16-byte K/V loads at once (no load waits
//    on another), coalesced: the D values of one (position, head) are
//    contiguous in the cache (D % 8 == 0 keeps every row 16-byte aligned).
//  * One thread per staged key computes its score; the chunk max, the
//    online-softmax rescale and the denominator follow the FlashAttention-2
//    recurrence of the TPU kernel, page-granular there and chunk-granular
//    here. The P.V product splits the chunk's keys over THREADS/DP thread
//    groups, combined once at the end.
//  * A slot with seq_len 0 (an inactive slot of the engine) walks no page
//    and writes zeros: finite, never NaN.
//  * Page ids are clamped into [0, num_pages), as a JAX gather clamps;
//    CUDA indexing would otherwise read out of bounds.
//  * No split-KV yet: one block walks the whole sequence (later work).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

constexpr int kMaxHeadDim = 256;

// 16 bytes of T (one vector load) widened to float
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f32(e[i]);
}

// Geometry of one instantiation: DP = padded head dim.
template <int DP>
struct Geom {
  static constexpr int THREADS = DP < 128 ? 128 : DP;
  static constexpr int KEYS = DP <= 64 ? 64 : 4096 / DP;  // staged keys
};

template <typename T, int DP>
__global__ void __launch_bounds__(Geom<DP>::THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    int heads, int d, int page, int max_pages, int num_pages,
                    float scale) {
  constexpr int NT = Geom<DP>::THREADS;
  constexpr int KEYS = Geom<DP>::KEYS;
  constexpr int G = NT / DP;                  // key groups of the P.V product
  constexpr int VEC = 16 / sizeof(T);         // elements per 16-byte load
  constexpr int PER = KEYS * (DP / VEC) / NT;  // loads per thread, at most
  static_assert(PER * NT == KEYS * (DP / VEC), "tile must split evenly");
  __shared__ float qs[DP];
  __shared__ float ks[KEYS][DP + 1];  // +1: conflict-free row-per-thread dots
  __shared__ float vs[KEYS][DP];
  __shared__ float ps[KEYS];
  __shared__ float red[NT];
  __shared__ long long rowoff[KEYS];  // element offset of (pos, h, 0); -1 past n

  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int tid = threadIdx.x;
  const int dd = tid % DP;
  const int grp = tid / DP;
  const int rowv = d / VEC;  // vector loads per key row

  const int n = max(0, min(seq_lens[s], max_pages * page));
  const int* pt = page_table + (size_t)s * max_pages;
  const T* qrow = q + ((size_t)s * heads + h) * d;
  for (int c = tid; c < DP; c += NT) qs[c] = c < d ? to_f32(qrow[c]) : 0.f;
  if (d < DP) {  // the padding columns stay zero; the loads never touch them
    for (int idx = tid; idx < KEYS * DP; idx += NT) {
      const int r = idx / DP, c = idx % DP;
      if (c >= d) ks[r][c] = vs[r][c] = 0.f;
    }
  }

  float acc = 0.f;
  float m = -CUDART_INF_F;
  float l = 0.f;
  for (int c0 = 0; c0 < n; c0 += KEYS) {
    const int nk = min(KEYS, n - c0);
    __syncthreads();  // qs written / previous chunk consumed
    // look every position's page up once, so the K/V loads below are
    // independent of each other and all in flight together
    if (tid < KEYS) {
      long long off = -1;
      if (tid < nk) {
        const int pos = c0 + tid;
        const int pg = min(max(pt[pos / page], 0), num_pages - 1);
        off = (((long long)pg * page + pos % page) * heads + h) * d;
      }
      rowoff[tid] = off;
    }
    __syncthreads();
    uint4 kraw[PER], vraw[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      kraw[i] = vraw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < KEYS * rowv) {
        const long long off = rowoff[idx / rowv];
        if (off >= 0) {
          const long long e = off + (idx % rowv) * VEC;
          kraw[i] = *reinterpret_cast<const uint4*>(kp + e);
          vraw[i] = *reinterpret_cast<const uint4*>(vp + e);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int idx = tid + i * NT;
      if (idx < KEYS * rowv) {
        const int r = idx / rowv, c = (idx % rowv) * VEC;
        float kf[VEC], vf[VEC];
        unpack<T>(kraw[i], kf);
        unpack<T>(vraw[i], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ks[r][c + e] = kf[e];
          vs[r][c + e] = vf[e];
        }
      }
    }
    __syncthreads();
    if (tid < KEYS) {
      float sc = -CUDART_INF_F;
      if (tid < nk) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < DP; ++c) dot = fmaf(qs[c], ks[tid][c], dot);
        sc = dot * scale;
      }
      ps[tid] = sc;
    }
    __syncthreads();
    float cmax = m;
    for (int r = 0; r < nk; ++r) cmax = fmaxf(cmax, ps[r]);
    const float alpha = expf(m - cmax);  // first chunk: exp(-inf) = 0
    __syncthreads();  // every thread has read the scores
    if (tid < KEYS) ps[tid] = tid < nk ? expf(ps[tid] - cmax) : 0.f;
    __syncthreads();
    float psum = 0.f;
    for (int r = 0; r < nk; ++r) psum += ps[r];
    l = l * alpha + psum;
    acc *= alpha;
    for (int r = grp; r < nk; r += G) acc = fmaf(ps[r], vs[r][dd], acc);
    m = cmax;
  }

  red[tid] = acc;
  __syncthreads();
  if (tid < d) {
    float a = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) a += red[g * DP + tid];
    out[((size_t)s * heads + h) * d + tid] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DP>
int launch(const void* q, const void* kp, const void* vp, const int* pt,
           const int* sl, void* out, int slots, int heads, int d, int page,
           int max_pages, int num_pages, float scale, cudaStream_t stream) {
  const dim3 grid(heads, slots);
  paged_decode_kernel<T, DP><<<grid, Geom<DP>::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), pt, sl, static_cast<T*>(out), heads, d, page,
      max_pages, num_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* kp, const void* vp,
               const int* pt, const int* sl, void* out, int slots, int heads,
               int page, int max_pages, int num_pages, float scale,
               cudaStream_t s) {
  if (d <= 0 || d % 8 != 0 || d > kMaxHeadDim) return -1;
  if (d <= 32)
    return launch<T, 32>(q, kp, vp, pt, sl, out, slots, heads, d, page,
                         max_pages, num_pages, scale, s);
  if (d <= 64)
    return launch<T, 64>(q, kp, vp, pt, sl, out, slots, heads, d, page,
                         max_pages, num_pages, scale, s);
  if (d <= 128)
    return launch<T, 128>(q, kp, vp, pt, sl, out, slots, heads, d, page,
                          max_pages, num_pages, scale, s);
  return launch<T, 256>(q, kp, vp, pt, sl, out, slots, heads, d, page,
                        max_pages, num_pages, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. num_pages counts the
// trash page (the first dimension of k/v_pages). Returns cudaGetLastError()
// of the launch, or -1 for an unsupported dtype or head dim (D % 8 != 0 or
// D > 256). Launches on `stream`; allocates nothing.
extern "C" int dl4j_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table,
                                 const int* seq_lens, void* out, int slots,
                                 int heads, int d, int page, int max_pages,
                                 int num_pages, float scale, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots <= 0 || heads <= 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(d, q, k_pages, v_pages, page_table, seq_lens,
                             out, slots, heads, page, max_pages, num_pages,
                             scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k_pages, v_pages, page_table,
                                     seq_lens, out, slots, heads, page,
                                     max_pages, num_pages, scale, s);
  if (dtype == 2)
    return dispatch_d<__half>(d, q, k_pages, v_pages, page_table, seq_lens,
                              out, slots, heads, page, max_pages, num_pages,
                              scale, s);
  return -1;
}
