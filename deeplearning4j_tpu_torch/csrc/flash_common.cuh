// flash_common.cuh — what the flash attention forward (flash_attn_fwd.cu)
// and backward (flash_attn_bwd.cu) kernels share: element conversions, the
// mask fill, and the attention-dropout keep mask.
//
// The keep mask is the counter-based hash of the TPU kernels
// (deeplearning4j_tpu/ops/pallas_attention.py `_keep_mask`): a murmur-style
// mix of (seed, batch*head, absolute query row, absolute key column),
// thresholded against the rate. The TPU computes it in int32 arithmetic that
// wraps, with logical right shifts; uint32 arithmetic is the same bits. So
// the forward and both backward kernels regenerate the forward's mask
// exactly, and it equals the TPU kernel's bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace flash {

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

constexpr float kMasked = -1e30f;  // the TPU kernels' mask fill
constexpr int kMaxHeadDim = 256;

// True when attention probability (row, col) of batch*head `bh` is kept.
// `rate` is the float32 dropout rate: the TPU compares a float32 uniform
// with it, and so does this (the uniform is exact: 24 bits times 2^-24).
__device__ __forceinline__ bool keep_element(unsigned seed, int bh, int row,
                                             int col, float rate) {
  unsigned h = seed + static_cast<unsigned>(bh) * 7919u +
               static_cast<unsigned>(row) * 1103515245u +
               static_cast<unsigned>(col) * 1299709u;
  h ^= h >> 13;
  h *= 1274126177u;
  h ^= h >> 16;
  return __uint2float_rn(h & 0xFFFFFFu) * 5.9604644775390625e-08f >= rate;
}

}  // namespace flash
