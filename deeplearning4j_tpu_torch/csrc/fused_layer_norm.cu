// fused_layer_norm.cu — act(LayerNorm(x) * gain + bias) over the trailing
// axis in one pass, for Hopper (sm_90a):
//
//     mean = sum(x) / D;  var = sum((x - mean)^2) / D
//     out  = act((x - mean) * rsqrt(var + eps) * gain + bias)
//
// x and out (rows, D) in float32, bfloat16 or float16; gain and bias (D,)
// float32 (the wrapper casts them); every statistic and the epilogue in
// float32, one rounding to x's type on the write. act is one of none, relu,
// tanh, gelu (the tanh approximation) and gelu_exact (the erf form).
//
// Replaces: deeplearning4j_tpu/ops/pallas_layernorm.py `_kernel`, reached
// through `fused_layer_norm_pallas` — the target of the SameDiff
// optimizer's layer_norm → gelu fusion. Same contract: float32 mean, then
// the variance of the centered values already held (not E[x^2] - E[x]^2),
// normalize, gain, bias and activation on the float32 row, one write.
//
// What bounds it on the H100: memory. Each element is read once and
// written once with ~20 flops between, far below the card's ~20 flops a
// byte of float32 CUDA-core rate — at 4096 rows x 768 the bytes take
// 7.5 us (float32) at 3.35 TB/s.
//
// Design, and what it does about the TPU original:
//  * Pallas reads a (block_rows, D) tile into VMEM and reduces along the
//    lane axis. Here, for D <= 1024, one warp owns a row: each lane holds
//    its share of the row in registers (at most 32 floats), two warp
//    shuffle reductions give the mean and the centered variance, and the
//    lane normalizes and writes the values it already holds — x is read
//    from device memory once. 8 warps (rows) a block.
//  * D > 1024 (no TPU tile limit to mirror, but the registers of one warp
//    run out): one block of 256 threads owns a row and reduces through
//    shared memory; the row is re-read for the second and third passes,
//    from L1/L2 (a row of 4096 float32 is 16 KB).
//  * Any rows and any D: every column is bounds-checked. 16-byte vector
//    loads and stores are used when D keeps every vector whole and the
//    pointers are aligned (the `vec` flag); element accesses otherwise.
//  * Allocates nothing; the wrapper allocates the output.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "activation.cuh"

namespace {

using epilogue::activate;
using epilogue::ACT_GELU_EXACT;
using epilogue::ACT_NONE;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LANE_VALUES = 32;  // floats a lane holds: D <= 32 * 32
constexpr int WARP_MAX_D = 32 * LANE_VALUES;

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

// a 16-bit element from and to its bits
template <typename T>
__device__ __forceinline__ float bits_to_f32(unsigned short b);
template <>
__device__ __forceinline__ float bits_to_f32<__nv_bfloat16>(unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <>
__device__ __forceinline__ float bits_to_f32<__half>(unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
template <typename T>
__device__ __forceinline__ unsigned short f32_to_bits(float y);
template <>
__device__ __forceinline__ unsigned short f32_to_bits<__nv_bfloat16>(float y) {
  return __bfloat16_as_ushort(__float2bfloat16(y));
}
template <>
__device__ __forceinline__ unsigned short f32_to_bits<__half>(float y) {
  return __half_as_ushort(__float2half(y));
}

// PER elements of T in one 16-byte access
template <typename T>
struct Pack {
  static constexpr int PER = 16 / sizeof(T);
  union {
    uint4 raw;
    unsigned short h[8];
    float f[4];
  };
  __device__ __forceinline__ float get(int j) const {
    if constexpr (sizeof(T) == 4) {
      return f[j];
    } else {
      return bits_to_f32<T>(h[j]);
    }
  }
  __device__ __forceinline__ void set(int j, float y) {
    if constexpr (sizeof(T) == 4) {
      f[j] = y;
    } else {
      h[j] = f32_to_bits<T>(y);
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the block's 256 threads, returned to every thread; `red`
// holds WARPS + 1 floats and is free again when this returns
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < WARPS ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[WARPS] = t;
  }
  __syncthreads();
  const float total = red[WARPS];
  __syncthreads();
  return total;
}

__device__ __forceinline__ float affine(float c, float rstd,
                                        const float* __restrict__ gain,
                                        const float* __restrict__ bias,
                                        int col, int act) {
  float y = c * rstd * __ldg(gain + col);
  if (bias != nullptr) y += __ldg(bias + col);
  return activate(y, act);
}

// D <= 1024: one warp per row, the row in registers
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ln_warp_kernel(const T* __restrict__ x, const float* __restrict__ gain,
               const float* __restrict__ bias, T* __restrict__ out,
               long long rows, int d, float eps, int act) {
  constexpr int PER = VEC ? Pack<T>::PER : 1;  // elements per access
  constexpr int CHUNKS = LANE_VALUES / PER;    // accesses per lane
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave: no shuffle is left short
  const T* xr = x + row * d;
  T* orow = out + row * d;

  float v[LANE_VALUES];
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * PER;
    if (col < d) {  // VEC: d % PER == 0, so the vector is whole
      if constexpr (VEC) {
        Pack<T> p;
        p.raw = *reinterpret_cast<const uint4*>(xr + col);
#pragma unroll
        for (int j = 0; j < PER; ++j) v[c * PER + j] = p.get(j);
      } else {
        v[c] = to_f32(xr[col]);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) s += v[c * PER + j];
    }
  }
  const float mean = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * PER;
    if (col < d) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float t = v[c * PER + j] - mean;
        q += t * t;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / d + eps);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int col = (c * 32 + lane) * PER;
    if (col < d) {
      if constexpr (VEC) {
        Pack<T> p;
#pragma unroll
        for (int j = 0; j < PER; ++j)
          p.set(j, affine(v[c * PER + j] - mean, rstd, gain, bias, col + j,
                          act));
        *reinterpret_cast<uint4*>(orow + col) = p.raw;
      } else {
        orow[col] = from_f32<T>(affine(v[c] - mean, rstd, gain, bias, col,
                                       act));
      }
    }
  }
}

// D > 1024: one block per row, reduced through shared memory
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
ln_block_kernel(const T* __restrict__ x, const float* __restrict__ gain,
                const float* __restrict__ bias, T* __restrict__ out, int d,
                float eps, int act) {
  constexpr int PER = VEC ? Pack<T>::PER : 1;
  __shared__ float red[WARPS + 1];
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int n_acc = d / PER;  // VEC: d % PER == 0

  float s = 0.f;
  for (int i = threadIdx.x; i < n_acc; i += THREADS) {
    if constexpr (VEC) {
      Pack<T> p;
      p.raw = *reinterpret_cast<const uint4*>(xr + i * PER);
#pragma unroll
      for (int j = 0; j < PER; ++j) s += p.get(j);
    } else {
      s += to_f32(xr[i]);
    }
  }
  const float mean = block_sum(s, red) / d;
  float q = 0.f;
  for (int i = threadIdx.x; i < n_acc; i += THREADS) {
    if constexpr (VEC) {
      Pack<T> p;
      p.raw = *reinterpret_cast<const uint4*>(xr + i * PER);
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const float t = p.get(j) - mean;
        q += t * t;
      }
    } else {
      const float t = to_f32(xr[i]) - mean;
      q += t * t;
    }
  }
  const float rstd = rsqrtf(block_sum(q, red) / d + eps);
  for (int i = threadIdx.x; i < n_acc; i += THREADS) {
    if constexpr (VEC) {
      Pack<T> p;
      p.raw = *reinterpret_cast<const uint4*>(xr + i * PER);
#pragma unroll
      for (int j = 0; j < PER; ++j)
        p.set(j, affine(p.get(j) - mean, rstd, gain, bias, i * PER + j, act));
      *reinterpret_cast<uint4*>(orow + i * PER) = p.raw;
    } else {
      orow[i] = from_f32<T>(affine(to_f32(xr[i]) - mean, rstd, gain, bias, i,
                                   act));
    }
  }
}

template <typename T>
int launch(const void* x, const float* gain, const float* bias, void* out,
           long long rows, int d, float eps, int act, int vec,
           cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (d <= WARP_MAX_D) {
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL) return -1;
    const unsigned grid = static_cast<unsigned>(blocks);
    if (vec)
      ln_warp_kernel<T, true><<<grid, THREADS, 0, stream>>>(
          xp, gain, bias, op, rows, d, eps, act);
    else
      ln_warp_kernel<T, false><<<grid, THREADS, 0, stream>>>(
          xp, gain, bias, op, rows, d, eps, act);
  } else {
    if (rows > 0x7fffffffLL) return -1;
    const unsigned grid = static_cast<unsigned>(rows);
    if (vec)
      ln_block_kernel<T, true><<<grid, THREADS, 0, stream>>>(
          xp, gain, bias, op, d, eps, act);
    else
      ln_block_kernel<T, false><<<grid, THREADS, 0, stream>>>(
          xp, gain, bias, op, d, eps, act);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x and out (rows, d) row-major, of one type (dtype 0 float32, 1 bfloat16,
// 2 float16); gain (d,) float32; bias (d,) float32 or null; act 0..4 as
// `epilogue::Act`. vec = 1 promises 16-byte-aligned x and out with d a
// multiple of 4 (float32) or 8 (bfloat16/float16). Any rows >= 0, d >= 1.
// Returns cudaGetLastError() of the launch, or -1 for arguments the kernel
// does not take. Launches on `stream`; allocates nothing.
extern "C" int dl4j_fused_layer_norm(const void* x, const float* gain,
                                     const float* bias, void* out,
                                     long long rows, int d, float eps,
                                     int dtype, int act, int vec,
                                     void* stream) {
  if (rows < 0 || d < 1 || act < ACT_NONE || act > ACT_GELU_EXACT) return -1;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, gain, bias, out, rows, d, eps, act, vec, st);
    case 1:
      return launch<__nv_bfloat16>(x, gain, bias, out, rows, d, eps, act,
                                   vec, st);
    case 2:
      return launch<__half>(x, gain, bias, out, rows, d, eps, act, vec, st);
    default:
      return -1;
  }
}
