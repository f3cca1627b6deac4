// flash_f32.cuh — what the float32 tensor-core flash kernels share
// (flash_attn_fwd_f32_sm90.cu, flash_attn_dq_f32_sm90.cu,
// flash_attn_dkv_f32_sm90.cu): the order of an operand's transposed copy —
// written by a pre-pass kernel (the forward's Vᵀ) or in shared memory from
// a landed tile (the backward's Kᵀ, Qᵀ and dOᵀ) —, the split of landed
// float32 tiles into TF32 parts in shared memory, the product of a split
// accumulator with a transposed copy, and the key-mask votes that let a
// kernel skip keys that are all masked.
//
// TF32 wgmma reads both shared-memory operands K-major only (sm90.cuh), so
// a product that contracts over rows of a row-major (BH, T, D) tensor —
// P·V and dS·K over keys, P̃ᵀ·dO and dSᵀ·Q over queries — reads the
// tensor's (BH, D, Tp) transposed copy, Tp = T rounded up to 8 (zeros past
// T). The contraction index of the copy is permuted 0, 2, 4, 6, 1, 3, 5, 7
// within each group of 8 (group_key): the order in which an accumulator
// handed over as the TF32 A fragment holds its columns (sm90.cuh
// `tf32_a_col`), so the hand-over needs no shuffle.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "sm90.cuh"

namespace flash_f32 {

// The row of the transposed copy's position p: each group of 8 in the
// order the TF32 A fragment reads an accumulator's columns.
__device__ __forceinline__ int group_key(int p) {
  return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1);
}

// Splits `n16` 16-byte chunks of float32 at `src` (generic shared-memory
// pointer) into TF32 parts in place: hi = tf32(v) over the values, lo =
// tf32(v - hi) at `src + lo_off`. Thread `i` of `count`. The swizzle moves
// whole 16-byte chunks, so the split is elementwise on a slab's bytes.
__device__ __forceinline__ void split_chunks(uint8_t* src, uint32_t lo_off,
                                             int n16, int i, int count) {
  for (int e = i; e < n16; e += count) {
    float4* h = reinterpret_cast<float4*>(src + e * 16);
    float4* l = reinterpret_cast<float4*>(src + lo_off + e * 16);
    const float4 x = *h;
    uint32_t hx, lx, hy, ly, hz, lz, hw, lw;
    sm90::tf32_split(x.x, hx, lx);
    sm90::tf32_split(x.y, hy, ly);
    sm90::tf32_split(x.z, hz, lz);
    sm90::tf32_split(x.w, hw, lw);
    *h = make_float4(__uint_as_float(hx), __uint_as_float(hy),
                     __uint_as_float(hz), __uint_as_float(hw));
    *l = make_float4(__uint_as_float(lx), __uint_as_float(ly),
                     __uint_as_float(lz), __uint_as_float(lw));
  }
}

// Splits a landed row-major tile of 32 rows × DP float32 values (TMA's
// layout: DP / 32 slabs of 32 swizzled 128-byte rows) into TF32 parts:
// with ROWS in the same layout, hi at `hi` (may be `src`) and lo at `lo`;
// with TRANSPOSE its transposed copy's, at `thi` and `tlo`: one slab of DP
// swizzled rows of 32 values, position p of row c holding column c of tile
// row group_key(p) — what TMA would bring of a pre-pass's copy. Warp
// `warp` of `warps` takes 4-column groups in turn, a lane a row: the
// lanes' transposed stores for one column then fill the 32 positions of
// one row, each bank once.
template <int DP, bool ROWS, bool TRANSPOSE>
__device__ __forceinline__ void split_rows(const uint8_t* src, uint8_t* hi,
                                           uint8_t* lo, uint8_t* thi,
                                           uint8_t* tlo, int warp, int warps,
                                           int lane) {
  const int r = lane;
  const int p = (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);  // group_key⁻¹
  for (int g = warp; g < DP / 4; g += warps) {
    const int sp = g / 8, lc = g % 8;  // the slab, the chunk in the row
    const int off = sp * 32 * 128 + r * 128 + ((lc ^ (r & 7)) << 4);
    const float4 x = *reinterpret_cast<const float4*>(src + off);
    const float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) sm90::tf32_split(v[k], h[k], l[k]);
    if (ROWS) {
      *reinterpret_cast<float4*>(hi + off) =
          make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                      __uint_as_float(h[2]), __uint_as_float(h[3]));
      *reinterpret_cast<float4*>(lo + off) =
          make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                      __uint_as_float(l[2]), __uint_as_float(l[3]));
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = sp * 32 + lc * 4 + k;
        const int t = c * 128 + ((((p >> 2) ^ c) & 7) << 4) + (p & 3) * 4;
        *reinterpret_cast<uint32_t*>(thi + t) = h[k];
        *reinterpret_cast<uint32_t*>(tlo + t) = l[k];
      }
    }
  }
}

// True when key k0 + lane, or one of the next 31, is unmasked: a vote of
// the whole warp (every lane calls it with the same k0).
__device__ __forceinline__ bool keys_on(const float* mrow, int k0, int tk,
                                        int lane) {
  const int key = k0 + lane;
  return __ballot_sync(0xffffffffu, key < tk && mrow[key] > 0.5f) != 0;
}

// True when the key mask row `mrow` (nullptr: none) has an unmasked key
// below `k_lim`. Only then may a kernel skip keys that are all masked: a
// masked key's p is exp(-1e30 - lse) = 0 exactly unless every key the
// query row sees is masked (then lse is the fill's, and p = 1). So k_lim is
// Tk, or with the causal mask the first key that not every row concerned
// sees: each of those rows then sees an unmasked key. A vote of the whole
// warp.
__device__ __forceinline__ bool can_skip_masked(const float* mrow, int k_lim,
                                                int lane) {
  if (mrow == nullptr) return false;
  for (int k0 = 0; k0 < k_lim; k0 += 32)
    if (keys_on(mrow, k0, k_lim, lane)) return true;
  return false;
}

// acc += A·B for one tile: A (64 × K) a float32 accumulator split into
// TF32 parts in registers (hi, lo; values in acc_row / acc_col order), B
// (K × N) K-major in shared memory, given by its parts' slabs (N rows of K
// values, each group of 8 in group_key order). Three passes, lo·hi, hi·lo
// and hi·hi, summed from zero on the tensor cores and added to acc on the
// CUDA cores: one accumulator through a long chain of wgmma additions
// loses about a unit of the sum per addition.
template <int N, int K>
__device__ __forceinline__ void add_split_product(float (&acc)[N / 2],
                                                  uint32_t (&hi)[K / 2],
                                                  uint32_t (&lo)[K / 2],
                                                  uint32_t b_hi,
                                                  uint32_t b_lo) {
  float part[N / 2];
  sm90::fence_regs(hi);
  sm90::fence_regs(lo);
  sm90::wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass) {
    const uint32_t b = pass == 1 ? b_lo : b_hi;
#pragma unroll
    for (int kk = 0; kk < K / 8; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // register r reads value 4kk + π(r)
        const int i = 4 * kk + (r & 1) * 2 + (r >> 1);
        a[r] = pass == 0 ? lo[i] : hi[i];
      }
      const uint32_t bk = b + (kk / 4) * N * 128 + (kk % 4) * 32;
      sm90::WgmmaTf32<N>::rs(part, a, sm90::desc_sw128(bk, 16, 1024),
                             pass > 0 || kk > 0);
    }
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(part);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
}

}  // namespace flash_f32
