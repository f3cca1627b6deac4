// matmul_int8_sm90.cu — the int8 serving GEMM on Hopper's tensor cores
// (sm_90a), with its de-scale epilogue:
//
//     y[r, n] = (float)(sum_c q[r, c] * w_q[c, n]) * s[r] * w_s[n]
//
// q (M, K) int8 and s (M,) float32 from row_quantize (matmul_int8.cu);
// w_q given as its K-major (N, K) copy `wt`, w_s (N,) float32; y (M, N)
// float32, bfloat16 or float16. The contract of `dl4j_matmul_int8`, whose
// WMMA kernel keeps the shapes TMA cannot read (`int8_design`).
//
// Replaces: deeplearning4j_tpu/ops/quantized.py `_kernel` (the Pallas int8
// MXU kernel reached through `matmul_int8_pallas`), held to the reference
// bit for bit:
//  * the dot in int32: wgmma m64nNk32 .s32.s8.s8, exact at any K (the TPU
//    kernel's float32 VMEM accumulator is exact only below 2^24);
//  * the de-scale (float)acc * s[r] * w_s[n] in float32, left to right,
//    two rounded multiplies (__fmul_rn: nothing to contract), then one
//    rounding to y's type.
//
// What bounds it on the H100: at the serving shapes (M 4096; K x N
// 768x768, 768x3072, 3072x768) M*K + K*N int8 bytes in and M*N outputs out
// against 2*M*K*N integer operations — bytes at K 768 with a float32 y,
// the dense int8 rate (1979 TOP/s) at K 3072.
//
// Design (the skeleton of fused_matmul_sm90.cu):
//  * A persistent block an SM: a producer warpgroup (setmaxnreg 24) that
//    issues TMA from one thread, two consumer warpgroups (240) of 64 rows,
//    each one m64nBNk32 wgmma chain into BN/2 int32 registers a thread.
//    Tiles 128 x BN walked M fastest (the blocks in flight share wt's
//    column tile in L2); the producer runs on into the next tile while the
//    consumers de-scale the last.
//  * A stage is one 128-byte swizzle span of K — 128 int8 columns: the q
//    tile (128 x 128 bytes, 16 KB) and the wt tile (BN x 128 bytes), both
//    K-major as 8-bit wgmma demands (it has no transpose bit). Edges read
//    as TMA zeros, which add nothing to an integer dot: any M and N, and
//    any K a multiple of 16 (TMA's 16-byte row stride).
//  * BN (128 or 192) is a template argument the wrapper picks for the
//    fuller last wave (`int8_tile_n`): at M 4096 x N 768 BN 192 gives 128
//    tiles, one wave on 132 SMs. The ring holds as many stages as shared
//    memory leaves beside the staging tile (3 for a float32 y at BN 192,
//    else 4).
//  * The epilogue: each value placed by acc_row / acc_col (the s32
//    accumulator of m64nNk32 has the float32 m64nNk16 layout), de-scaled,
//    rounded once, staged in shared memory (rows padded by 8 elements: the
//    8 rows of a warp's fragment fall on distinct banks) and written 16
//    bytes a thread along the rows where N allows it (N * sizeof(y) % 16
//    == 0), one element a thread otherwise (the N = 2 classifier).
//  * Allocates nothing; the wrapper allocates y and the K-major copy.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int BM = 128;                     // rows a tile (2 warpgroups)
constexpr int BK = 128;                     // K values a stage: one span
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kTileQ = BM * 128;       // 16 KB
constexpr uint32_t kSmemBudget = 232448 - 1024 - 256;  // - align, statics

template <typename T, int BN>
struct Cfg {
  static constexpr uint32_t kStage = kTileQ + BN * 128;
  static constexpr uint32_t kEpiRow = (BN + 8) * sizeof(T);
  static constexpr uint32_t kEpi = BM * kEpiRow;
  static constexpr int kFit = (kSmemBudget - kEpi) / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr uint32_t kSmem = kStages * kStage + kEpi + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
};

__device__ __forceinline__ float descale(int acc, float s, float ws) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), s), ws);
}

// two neighbouring outputs, each rounded once to T, as one store
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = sm90::pack2<T>(a, b);
  }
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_w,
               const float* __restrict__ xs, const float* __restrict__ ws,
               T* __restrict__ out, int m, int n, int k) {
  using C = Cfg<T, BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const epi_all = smem_raw + (base - raw) + kStages * C::kStage;
  auto full = [&](int s) { return sm90::smem_u32(&bars[s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[kStages + s]); };

  const int tiles_m = (m + BM - 1) / BM;
  const int n_tiles = tiles_m * ((n + BN - 1) / BN);
  const int n_k = (k + BK - 1) / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), kConsumers);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warpgroup: one thread issues TMA
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = (t % tiles_m) * BM;
        const int n0 = (t / tiles_m) * BN;
        for (int j = 0; j < n_k; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) sm90::mbar_wait(empty(s), (it / kStages - 1) & 1);
          const uint32_t st = base + s * C::kStage;
          sm90::mbar_arrive_expect_tx(full(s), C::kStage);
          sm90::tma_load_3d(st, &tm_q, full(s), j * BK, m0, 0);
          sm90::tma_load_3d(st + kTileQ, &tm_w, full(s), j * BK, n0, 0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM;
    const int n0 = (t / tiles_m) * BN;
    int acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;

    for (int j = 0; j < n_k; ++j, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = base + s * C::kStage;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint32_t a = st + wg * 64 * 128 + kk * 32;
        const uint32_t b = st + kTileQ + kk * 32;
        sm90::WgmmaS8<BN>::ss(acc, sm90::desc_sw128(a, 16, 1024),
                              sm90::desc_sw128(b, 16, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // slab it - 1's chain is done: release it
      sm90::fence_regs(acc);
      if (j > 0) sm90::mbar_arrive(empty((it - 1) % kStages));
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    if (n_k > 0) sm90::mbar_arrive(empty((it - 1) % kStages));

    // ---- epilogue: (float)acc * s[row] * w_s[col], one rounding, staged
    uint8_t* const epi = epi_all + wg * 64 * C::kEpiRow;
    const int rl = sm90::acc_row(0, warp, lane);  // and rl + 8
    const int row0 = m0 + wg * 64 + rl;
    const float s_lo = row0 < m ? __ldg(xs + row0) : 0.f;
    const float s_hi = row0 + 8 < m ? __ldg(xs + row0 + 8) : 0.f;
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int cl = sm90::acc_col(4 * c, lane);
      const int col = n0 + cl;
      const float w0 = col < n ? __ldg(ws + col) : 0.f;
      const float w1 = col + 1 < n ? __ldg(ws + col + 1) : 0.f;
      store2(reinterpret_cast<T*>(epi + rl * C::kEpiRow) + cl,
             descale(acc[4 * c], s_lo, w0), descale(acc[4 * c + 1], s_lo, w1));
      store2(reinterpret_cast<T*>(epi + (rl + 8) * C::kEpiRow) + cl,
             descale(acc[4 * c + 2], s_hi, w0),
             descale(acc[4 * c + 3], s_hi, w1));
    }
    sm90::named_barrier(1 + wg, 128);
    if ((n * sizeof(T)) % 16 == 0) {  // a 16-byte chunk is all in or out
      constexpr int kPer = 16 / sizeof(T);
      constexpr int kChunks = BN / kPer;
      for (int e = tid % 128; e < 64 * kChunks; e += 128) {
        const int r = e / kChunks, ch = e % kChunks;
        const int row = m0 + wg * 64 + r, col = n0 + ch * kPer;
        if (row < m && col < n)
          *reinterpret_cast<uint4*>(out + (size_t)row * n + col) =
              *reinterpret_cast<const uint4*>(epi + r * C::kEpiRow + ch * 16);
      }
    } else {
      for (int e = tid % 128; e < 64 * BN; e += 128) {
        const int r = e / BN, cc = e % BN;
        const int row = m0 + wg * 64 + r, col = n0 + cc;
        if (row < m && col < n)
          out[(size_t)row * n + col] =
              reinterpret_cast<const T*>(epi + r * C::kEpiRow)[cc];
      }
    }
    sm90::named_barrier(1 + wg, 128);  // the staged tile is free again
  }
}

template <typename T, int BN>
int launch(const int8_t* q, const float* xs, const int8_t* wt,
           const float* ws, void* out, int m, int n, int k,
           cudaStream_t stream) {
  CUtensorMap mq, mw;
  if (!sm90::make_map(&mq, q, 3, 1, m, k, BM) ||
      !sm90::make_map(&mw, wt, 3, 1, n, k, BN))
    return -2;
  auto kernel = int8_gemm_sm90<T, BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<T, BN>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long tiles =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, Cfg<T, BN>::kSmem, stream>>>(
      mq, mw, xs, ws, static_cast<T*>(out), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bn(const int8_t* q, const float* xs, const int8_t* wt,
                const float* ws, void* out, int m, int n, int k, int bn,
                cudaStream_t st) {
  if (bn == 128) return launch<T, 128>(q, xs, wt, ws, out, m, n, k, st);
  if (bn == 192) return launch<T, 192>(q, xs, wt, ws, out, m, n, k, st);
  return -1;
}

}  // namespace

// q (m, k) int8 and xs (m,) float32; wt (n, k) int8, the K-major copy of
// the (k, n) weight; ws (n,) float32; out (m, n) of dtype 0 float32, 1
// bfloat16, 2 float16, 16-byte aligned. k % 16 == 0 and q, wt 16-byte
// aligned (TMA); any m, n >= 0. `bn` is the tile width, 128 or 192.
// Returns cudaGetLastError() of the launch, -1 for arguments not taken, -2
// when a tensor map cannot be encoded. Launches on `stream`; allocates
// nothing.
extern "C" int dl4j_matmul_int8_sm90(const int8_t* q, const float* xs,
                                     const int8_t* wt, const float* ws,
                                     void* out, long long m, int n, int k,
                                     int dtype, int bn, void* stream) {
  if (m < 0 || n < 0 || k < 16 || k % 16 != 0) return -1;
  if (m > 0x7fffffffLL - BM) return -1;
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  switch (dtype) {
    case 0:
      return dispatch_bn<float>(q, xs, wt, ws, out, mi, n, k, bn, st);
    case 1:
      return dispatch_bn<__nv_bfloat16>(q, xs, wt, ws, out, mi, n, k, bn, st);
    case 2:
      return dispatch_bn<__half>(q, xs, wt, ws, out, mi, n, k, bn, st);
    default:
      return -1;
  }
}
