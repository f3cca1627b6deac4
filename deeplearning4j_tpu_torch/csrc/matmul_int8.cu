// matmul_int8.cu — the int8 serving matmul for Hopper (sm_90a), in two
// kernels:
//
//   row_quantize:  s[r]    = max(max_c |x[r,c]|, 1e-12) / 127    (float32)
//                  q[r,c]  = clip(rint(x[r,c] / s[r]), -127, 127) (int8)
//   int8 GEMM:     y[r,n]  = (float)(sum_c q[r,c] * w_q[c,n]) * s[r] * w_s[n]
//
// x and y (M, K) / (M, N) in float32, bfloat16 or float16; w_q (K, N) int8
// row-major, w_s (N,) float32 — the weights quantized offline per column.
//
// Replaces: deeplearning4j_tpu/ops/quantized.py `_kernel` (the Pallas int8
// MXU kernel reached through `matmul_int8_pallas`), together with the
// per-row activation quantization `_row_quantize` that XLA runs before it.
// Both are held to the reference's arithmetic bit for bit:
//  * the scale: amax in x's type (exact), floored at 1e-12 rounded to x's
//    type, widened to float32 and divided by 127 (IEEE division: the build
//    has no --use_fast_math);
//  * the quotient x / scale is taken in x's type: for bfloat16/float16 the
//    scale is rounded to x's type, the division done in float32 and the
//    quotient rounded to x's type, as XLA and PyTorch compute a 16-bit
//    division; then rintf (round half to even, as jnp.round and
//    torch.round; roundf would round half away from zero) and the clip;
//  * the dot in int32 (s8 tensor cores), exact at any K — the TPU kernel's
//    float32 VMEM accumulator is exact only while |acc| < 2^24, which is
//    why it keeps block_k <= 1024; here there is no such limit;
//  * the de-scale (float)acc * s[r] * w_s[n] in float32, left to right,
//    two rounded multiplies (__fmul_rn: nothing to contract), then one
//    rounding to y's type.
// (A NaN in a row is not propagated into its scale as jnp.max would.)
//
// What bounds it on the H100: at the serving shapes (M 4096, K x N 768x768,
// 768x3072, 3072x768) the GEMM moves M*K + K*N int8 bytes in, M*N outputs
// out, for 2*M*K*N integer operations: bound by memory (3.35 TB/s) at
// K = 768 and by the dense int8 tensor-core rate (1979 TOPS) at K = 3072.
// row_quantize reads x and writes q and s once: memory-bound.
//
// Design, and what it does about the TPU original:
//  * Pallas walks an (M, N, K) grid in order, carrying the (bm, bn) float32
//    accumulator in VMEM across the sequential K axis and de-scaling at the
//    last K step. Here one block owns a 128x128 output tile and walks K
//    itself, 64 at a time, through shared memory; the int32 accumulator
//    stays in WMMA fragments (8 warps of 64x32, mma.sync underneath) and
//    the de-scale runs once after the loop, one 16x16 fragment at a time
//    through a per-warp scratch, each output written once, no atomics.
//  * WMMA 16x16x16 s8 fragments want 32-byte-aligned tiles, and a 16-byte
//    K step of a row-major tile is not. So each 16x16 byte sub-tile is
//    stored contiguously (leading dimension 16): A as [row tile][k tile],
//    B as [k tile][column tile]. B stays the row-major (K, N) weight: no
//    transpose is needed.
//  * Every edge is bounds-checked and zero-filled on load: a zero adds
//    nothing to an integer dot, so ragged M, N (the 768x2 classifier) and
//    K are exact. B is read in 16-byte loads where N keeps every vector
//    whole and the pointer is aligned, byte loads otherwise; A always in
//    byte loads: an A that 16-byte loads could take (K % 16 == 0, aligned)
//    goes to matmul_int8_sm90.cu instead (`int8_design`).
//  * row_quantize: one warp per row for K <= 1024, one block of 256
//    threads per row above (as fused_layer_norm.cu places its rows); the
//    amax is a shuffle (and shared-memory) max reduction, then the row is
//    read again — from L1/L2 — to quantize. 4 elements an access where K
//    and the pointers allow it.
//  * No TMA, no wgmma, no pipelined K loop yet: a simple first version.
//  * Allocates nothing; the wrapper allocates q, s and y.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr float QMAX = 127.0f;
constexpr int THREADS = 256;

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
  return __float2bfloat16(x);  // round to nearest even
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);  // round to nearest even
}

// v rounded to T's precision (the identity for float32)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ----------------------------------------------------------- row_quantize

// four consecutive elements of x, widened to float32
template <typename T>
__device__ __forceinline__ void load4(const T* p, float v[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* h = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = to_f32(h[j]);
  }
}

template <typename T>
__device__ __forceinline__ int8_t quantize(float v, float s_t) {
  float q = rintf(round_to<T>(__fdiv_rn(v, s_t)));
  q = fminf(fmaxf(q, -QMAX), QMAX);
  return static_cast<int8_t>(static_cast<int>(q));
}

// G threads own one row: G = 32 (a warp; 8 rows a block) or 256 (a block)
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
row_quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                    float* __restrict__ xs, long long m, int k, int vec) {
  __shared__ float red[THREADS / 32];
  const long long row =
      (long long)blockIdx.x * (THREADS / G) + threadIdx.x / G;
  if (row >= m) return;  // G = 32: the whole warp; G = 256: never
  const int t = threadIdx.x % G;
  const T* xr = x + row * k;
  int8_t* qr = xq + row * k;

  float amax = 0.f;
  if (vec) {  // k % 4 == 0 and aligned rows: 4 elements an access
    for (int c = 4 * t; c < k; c += 4 * G) {
      float v[4];
      load4(xr + c, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[j]));
    }
  } else {
    for (int c = t; c < k; c += G) amax = fmaxf(amax, fabsf(to_f32(xr[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (G > 32) {
    const int lane = threadIdx.x % 32;
    const int warp = threadIdx.x / 32;
    if (lane == 0) red[warp] = amax;
    __syncthreads();
    amax = red[0];
#pragma unroll
    for (int w = 1; w < THREADS / 32; ++w) amax = fmaxf(amax, red[w]);
  }
  // jnp.maximum(amax, 1e-12) in x's type, then float32 / 127
  const float scale = __fdiv_rn(fmaxf(amax, round_to<T>(1e-12f)), QMAX);
  const float s_t = round_to<T>(scale);  // scale.astype(x.dtype)

  if (vec) {
    for (int c = 4 * t; c < k; c += 4 * G) {
      float v[4];
      load4(xr + c, v);
      char4 q;
      q.x = quantize<T>(v[0], s_t);
      q.y = quantize<T>(v[1], s_t);
      q.z = quantize<T>(v[2], s_t);
      q.w = quantize<T>(v[3], s_t);
      *reinterpret_cast<char4*>(qr + c) = q;
    }
  } else {
    for (int c = t; c < k; c += G) qr[c] = quantize<T>(to_f32(xr[c]), s_t);
  }
  if (t == 0) xs[row] = scale;
}

template <typename T>
int launch_row_quantize(const void* x, int8_t* xq, float* xs, long long m,
                        int k, int vec, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  if (k <= 1024) {
    const long long blocks = (m + THREADS / 32 - 1) / (THREADS / 32);
    if (blocks > 0x7fffffffLL) return -1;
    row_quantize_kernel<T, 32><<<static_cast<unsigned>(blocks), THREADS, 0,
                                 stream>>>(xp, xq, xs, m, k, vec);
  } else {
    if (m > 0x7fffffffLL) return -1;
    row_quantize_kernel<T, THREADS><<<static_cast<unsigned>(m), THREADS, 0,
                                      stream>>>(xp, xq, xs, m, k, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ int8 GEMM

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 64;
constexpr int TILE = 16 * 16;  // bytes of one 16x16 int8 sub-tile

// A sub-tile (row tile rt, k tile kt) and B sub-tile (k tile kt, column
// tile ct), each 16x16 bytes stored row by row (leading dimension 16)
__device__ __forceinline__ int a_tile(int rt, int kt) {
  return (rt * (BK / 16) + kt) * TILE;
}
__device__ __forceinline__ int b_tile(int kt, int ct) {
  return (kt * (BN / 16) + ct) * TILE;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                 const int8_t* __restrict__ wq, const float* __restrict__ ws,
                 T* __restrict__ out, long long m, int n, int k, int vec_b) {
  __shared__ __align__(128) signed char As[BM * BK];
  __shared__ __align__(128) signed char Bs[BK * BN];
  __shared__ __align__(128) int scratch[THREADS / 32][16 * 16];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 2 warps down M, 64 rows each
  const int wn = warp % 4;  // 4 warps across N, 32 columns each
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A tile: 128 rows x 64 bytes = 512 vectors of 16, 2 per thread;
    // 4 neighbouring threads read one row's 64 contiguous bytes
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BK / 16);
      const int kt = idx % (BK / 16);
      const long long grow = m0 + row;
      const int gk = k0 + kt * 16;
      signed char* dst = As + a_tile(row / 16, kt) + (row % 16) * 16;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        dst[j] = (grow < m && gk + j < k) ? xq[grow * k + gk + j] : 0;
    }
    // B tile: 64 rows x 128 bytes = 512 vectors of 16, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BN / 16);
      const int ct = idx % (BN / 16);
      const int gk = k0 + row;
      const long long gn = (long long)n0 + ct * 16;
      signed char* dst = Bs + b_tile(row / 16, ct) + (row % 16) * 16;
      if (vec_b) {  // n % 16 == 0
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (gk < k && gn < n)
          raw = *reinterpret_cast<const uint4*>(wq + (long long)gk * n + gn);
        *reinterpret_cast<uint4*>(dst) = raw;
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          dst[j] = (gk < k && gn + j < n) ? wq[(long long)gk * n + gn + j] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kt = 0; kt < BK / 16; ++kt) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major>
          a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major>
          b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + a_tile(wm * 4 + i, kt), 16);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + b_tile(kt, wn * 2 + j), 16);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // de-scale, one 16x16 fragment at a time through the warp's scratch:
  // (float)acc * row scale * column scale, one rounding, one write
  int* s = scratch[warp];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(s, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const long long row0 = m0 + wm * 64 + i * 16;
      const int col0 = n0 + wn * 32 + j * 16;
#pragma unroll
      for (int e = lane; e < 256; e += 32) {
        const long long row = row0 + e / 16;
        const int col = col0 + e % 16;
        if (row < m && col < n) {
          const float v = __fmul_rn(__fmul_rn(__int2float_rn(s[e]),
                                              __ldg(xs + row)),
                                    __ldg(ws + col));
          out[row * n + col] = from_f32<T>(v);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch_gemm(const int8_t* xq, const float* xs, const int8_t* wq,
                const float* ws, void* out, long long m, int n, int k,
                int vec_b, dim3 grid, cudaStream_t stream) {
  int8_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(
      xq, xs, wq, ws, static_cast<T*>(out), m, n, k, vec_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) row-major of dtype 0 float32, 1 bfloat16, 2 float16; xq (m, k)
// int8 and xs (m,) float32 outputs. vec = 1 promises k % 4 == 0, x aligned
// to 4 elements and xq to 4 bytes. Any m >= 0, k >= 1. Returns
// cudaGetLastError() of the launch, or -1 for arguments not taken.
extern "C" int dl4j_row_quantize(const void* x, int8_t* xq, float* xs,
                                 long long m, int k, int dtype, int vec,
                                 void* stream) {
  if (m < 0 || k < 1) return -1;
  if (m == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_row_quantize<float>(x, xq, xs, m, k, vec, st);
    case 1:
      return launch_row_quantize<__nv_bfloat16>(x, xq, xs, m, k, vec, st);
    case 2:
      return launch_row_quantize<__half>(x, xq, xs, m, k, vec, st);
    default:
      return -1;
  }
}

// xq (m, k) int8, xs (m,) float32, wq (k, n) int8, ws (n,) float32, all
// row-major; out (m, n) of dtype 0 float32, 1 bfloat16, 2 float16.
// vec_b = 1 promises n % 16 == 0 and a 16-byte-aligned wq. Any m, n >= 0, k >= 1. Returns
// cudaGetLastError() of the launch, or -1 for arguments not taken.
// Launches on `stream`; allocates nothing.
extern "C" int dl4j_matmul_int8(const int8_t* xq, const float* xs,
                                const int8_t* wq, const float* ws, void* out,
                                long long m, int n, int k, int dtype,
                                int vec_b, void* stream) {
  if (m < 0 || n < 0 || k < 1) return -1;
  if (m == 0 || n == 0) return 0;
  const long long grid_m = (m + BM - 1) / BM;
  const long long grid_n = (n + BN - 1) / BN;
  if (grid_m > 0x7fffffffLL || grid_n > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(grid_n));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_gemm<float>(xq, xs, wq, ws, out, m, n, k, vec_b, grid,
                                st);
    case 1:
      return launch_gemm<__nv_bfloat16>(xq, xs, wq, ws, out, m, n, k, vec_b,
                                        grid, st);
    case 2:
      return launch_gemm<__half>(xq, xs, wq, ws, out, m, n, k, vec_b, grid,
                                 st);
    default:
      return -1;
  }
}
