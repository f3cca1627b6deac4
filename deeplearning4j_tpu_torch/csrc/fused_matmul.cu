// fused_matmul.cu — act(x @ w + b) with the bias and activation applied to
// the float32 accumulator before the single write, for Hopper (sm_90a):
//
//     out = act(x @ w + b)        x (M, K), w (K, N), b (N,) f32, out (M, N)
//
// in the operands' own type (float32, bfloat16 or float16), accumulated in
// float32; act is one of none, relu, tanh, gelu (the tanh approximation)
// and gelu_exact (the erf form), computed in float32; one rounding to the
// output type on the write.
//
// Replaces: deeplearning4j_tpu/ops/pallas_matmul.py `_kernel`, reached
// through `fused_matmul_bias_act_pallas` — the SameDiff optimizer's
// matmul + bias (+ activation) fusion target. Same contract: native-type
// operands with a float32 accumulator, the bias cast to float32 and added
// to the accumulator, the activation in float32, one write.
//
// What bounds it on the H100: at the imported BERT-base shapes (M 4096,
// K 768/3072, N 768/3072) the product dominates — 2*M*K*N flops against
// (M*K + K*N + M*N) elements moved, ~200-600 flops a byte in float32.
// So float32 here is bound by the CUDA cores (67 TFLOP/s; the port's
// float32 contract keeps products accurate to float32, so never
// single-pass TF32) and bfloat16/float16 by the tensor cores (989 TFLOP/s
// dense). This SGEMM now takes the float32 shapes TMA cannot read (K not a
// multiple of 4, or x off 16-byte alignment); the rest run fused_matmul_f32_sm90.cu, whose
// products are three TF32 passes on the tensor cores, held to the same
// float32 check (`cuda_matmul.kernel_tolerance`) unchanged.
//
// Design, and what it does about the TPU original:
//  * Pallas walks an (M, N, K) grid in order and keeps the (bm, bn)
//    accumulator in VMEM across the sequential K axis, applying the
//    epilogue at the last K step. Here one block owns a 128x128 output
//    tile and walks K itself through shared memory; the accumulator stays
//    in registers and the epilogue runs once, after the loop.
//  * float32: a register-tiled CUDA-core SGEMM. 256 threads, each an 8x8
//    micro-tile; K staged 8 at a time, the A tile stored transposed so a
//    thread reads its 8 rows as two 16-byte loads.
//  * bfloat16 / float16 that TMA cannot read (K or N not a multiple of 8,
//    or an operand not 16-byte aligned; every other 16-bit shape runs
//    fused_matmul_sm90.cu): WMMA 16x16x16 tensor-core fragments with
//    float32 accumulators (mma.sync underneath), as bn_matmul_stats.cu does;
//    8 warps of 64x32 each, K staged 32 at a time. The epilogue goes
//    through a 16x16 float scratch per warp, one fragment at a time, so
//    the whole 128x128 float tile never needs shared memory.
//  * Every edge is bounds-checked: any M, N and K are computed, the ragged
//    tiles zero-filled on load and masked on store. Both kernels only meet
//    shapes or pointers TMA cannot read, so both load elements.
//  * No TMA, no wgmma, no pipelining: the simple first version, kept for
//    the shapes the sm90 kernel does not take.
//  * Allocates nothing; the wrapper allocates the output.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "activation.cuh"

namespace {

using namespace nvcuda;
using epilogue::activate;
using epilogue::ACT_NONE;
using epilogue::ACT_GELU_EXACT;

constexpr int THREADS = 256;
constexpr int BM = 128;
constexpr int BN = 128;

// ----------------------------------------------------------------- float32

constexpr int SBK = 8;  // K columns staged per step

__global__ void __launch_bounds__(THREADS)
sgemm_bias_act_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ bias,
                      float* __restrict__ out, long long m, int n, int k,
                      int act) {
  __shared__ __align__(16) float As[SBK][BM];  // transposed: As[k][row]
  __shared__ __align__(16) float Bs[SBK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // 8 output columns each
  const int ty = tid / 16;  // 8 output rows each
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // loaders: A — row tid/2, 4 columns from (tid%2)*4; B — row tid/32,
  // 4 columns from (tid%32)*4
  const int a_row = tid / 2;
  const int a_col = (tid % 2) * 4;
  const int b_row = tid / 32;
  const int b_col = (tid % 32) * 4;
  const long long a_grow = m0 + a_row;
  const long long b_gcol = (long long)n0 + b_col;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < k; k0 += SBK) {
    {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      const int gk = k0 + a_col;
      if (a_grow < m) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (gk + j < k) v[j] = x[a_grow * k + gk + j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) As[a_col + j][a_row] = v[j];
    }
    {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      const int gk = k0 + b_row;
      if (gk < k) {
        const float* src = w + (long long)gk * n + b_gcol;
        if (b_gcol < n) t.x = src[0];
        if (b_gcol + 1 < n) t.y = src[1];
        if (b_gcol + 2 < n) t.z = src[2];
        if (b_gcol + 3 < n) t.w = src[3];
      }
      *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = t;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 8 + 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias and activation on the float32 accumulator, one write
  const int col0 = n0 + tx * 8;
  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    bv[j] = (bias != nullptr && col0 + j < n) ? __ldg(bias + col0 + j) : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long row = m0 + ty * 8 + i;
    if (row >= m) break;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = activate(acc[i][j] + bv[j], act);
    float* dst = out + row * n + col0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + j < n) dst[j] = v[j];
  }
}

// --------------------------------------------------- bfloat16 and float16

constexpr int HBK = 32;         // K columns staged per step
constexpr int LDA = HBK + 8;    // elements; a multiple of 8 (WMMA)
constexpr int LDB = BN + 8;

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
hgemm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ out,
                      long long m, int n, int k, int act) {
  // raw bytes: a __shared__ array of a class type may not be declared
  __shared__ __align__(128) unsigned char smem_a[BM * LDA * sizeof(T)];
  __shared__ __align__(128) unsigned char smem_b[HBK * LDB * sizeof(T)];
  __shared__ __align__(128) float scratch[THREADS / 32][16 * 16];
  T* As = reinterpret_cast<T*>(smem_a);
  T* Bs = reinterpret_cast<T*>(smem_b);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp / 4;  // 2 warps down M, 64 rows each
  const int wn = warp % 4;  // 4 warps across N, 32 columns each
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const T zero = from_float<T>(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k; k0 += HBK) {
    // A tile: 128 rows x 32 columns = 512 vectors of 8, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (HBK / 8);
      const int cv = (idx % (HBK / 8)) * 8;
      const long long grow = m0 + row;
      const int gk = k0 + cv;
      T* dst = As + row * LDA + cv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (grow < m && gk + j < k) ? x[grow * k + gk + j] : zero;
    }
    // B tile: 32 rows x 128 columns = 512 vectors of 8, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BN / 8);
      const int cv = (idx % (BN / 8)) * 8;
      const int gk = k0 + row;
      const long long gn = (long long)n0 + cv;
      T* dst = Bs + row * LDB + cv;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = (gk < k && gn + j < n) ? w[(long long)gk * n + gn + j]
                                        : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue, one 16x16 fragment at a time through the warp's scratch:
  // bias and activation on the float32 accumulator, one rounding, one write
  float* s = scratch[warp];
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
          float v = s[e];
          if (bias != nullptr) v += __ldg(bias + col);
          out[row * n + col] = from_float<T>(activate(v, act));
        }
      }
      __syncwarp();
    }
  }
}

template <typename T>
int launch_half(const void* x, const void* w, const float* bias, void* out,
                long long m, int n, int k, int act, dim3 grid,
                cudaStream_t stream) {
  hgemm_bias_act_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<T*>(out), m, n, k, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k), w (k, n), out (m, n), all row-major and of one type (dtype 0
// float32, 1 bfloat16, 2 float16); bias (n,) float32 or null; act 0..4 as
// `Act`. Any m, n, k >= 0.
// Returns cudaGetLastError() of the launch, or -1 for arguments the kernel
// does not take. Launches on `stream`; allocates nothing.
extern "C" int dl4j_fused_matmul(const void* x, const void* w,
                                 const float* bias, void* out, long long m,
                                 int n, int k, int dtype, int act,
                                 void* stream) {
  if (m < 0 || n < 0 || k < 0 || act < ACT_NONE || act > ACT_GELU_EXACT)
    return -1;
  if (m == 0 || n == 0) return 0;
  const long long grid_m = (m + BM - 1) / BM;
  const long long grid_n = (n + BN - 1) / BN;
  if (grid_m > 0x7fffffffLL || grid_n > 65535) return -1;
  const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(grid_n));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      sgemm_bias_act_kernel<<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w), bias,
          static_cast<float*>(out), m, n, k, act);
      return static_cast<int>(cudaGetLastError());
    case 1:
      return launch_half<__nv_bfloat16>(x, w, bias, out, m, n, k, act, grid,
                                        st);
    case 2:
      return launch_half<__half>(x, w, bias, out, m, n, k, act, grid, st);
    default:
      return -1;
  }
}
