// fused_matmul_sm90.cu — act(x @ w + b) on Hopper's tensor cores for
// bfloat16 and float16 operands (sm_90a), float32 accumulation:
//
//     out = act(x @ w + b)        x (M, K), w (K, N), b (N,) f32, out (M, N)
//
// with the bias and activation applied to the float32 accumulator and one
// rounding to the operand type on the write. Takes K % 8 == 0, N % 8 == 0
// and 16-byte-aligned x, w and out (TMA's row strides and addresses); the
// float32 operands and the 16-bit shapes TMA cannot read keep the kernels
// of fused_matmul.cu (`cuda_matmul.matmul_design` chooses).
//
// Replaces: deeplearning4j_tpu/ops/pallas_matmul.py `_kernel`, reached
// through `fused_matmul_bias_act_pallas`, with fused_matmul.cu's contract
// (`dl4j_fused_matmul`): x and w row-major in one 16-bit type; the bias
// float32 or null, added to the float32 accumulator; the activation
// (activation.cuh: none, relu, tanh, gelu, gelu_exact) in float32; one
// write.
//
// What bounds it on the H100: 2·M·K·N operations against (M·K + K·N + M·N)
// 16-bit elements — at the imported BERT-base shapes (M 4096, K×N 768×768,
// 768×3072, 3072×768) 600–1500 operations a byte — so the tensor cores
// (989 TFLOP/s dense bf16) are the limit.
//
// Design:
//  * A block computes 128 × 192 output tiles: two consumer warpgroups of 64
//    rows, each one m64n192k16 wgmma chain, and a producer warpgroup that
//    hands its registers to the consumers (setmaxnreg 24 / 240) and issues
//    TMA from one thread. The kernel is persistent: one block an SM walks
//    the tiles gridDim.x apart, M fastest (the blocks in flight share w's
//    column tiles in L2), and the producer runs on into the next tile's
//    slabs while the consumers write the last one — the ring's fill is
//    paid once a block, not once a tile.
//  * BN = 192 and the wave count on 132 SMs (one block an SM: 211 KB of
//    shared memory): at M 4096 × N 768, BN 128 gives 32 × 6 = 192 tiles,
//    1.45 waves, the second 45% full, while BN 192 gives 32 × 4 = 128
//    tiles in one wave (97% of the SMs busy); at N 3072 both give ~97%
//    (BN 192: 512 tiles, 3.88 waves; BN 128: 768 tiles, 5.82 waves). So
//    BN 192 everywhere: at most one short wave.
//  * The K loop steps 64 columns, one 128-byte-swizzled slab: a stage holds
//    the x tile (128 × 64, K-major A, 16 KB) and the w tile (64 × 192 as
//    three 64-column slabs, N contiguous, read MN-major through wgmma's
//    transpose bit, 24 KB). Four stages (160 KB) in a ring guarded by
//    `full` / `empty` mbarriers: a consumer issues slab j's chain, waits
//    until only it is in flight (wait_group 1), then releases slab j - 1,
//    so the tensor cores run slab j while TMA fills j + 1 … j + 3.
//  * Edges: 3-D tensor maps over (columns, rows, 1), the encoder of
//    sm90.cuh as it is; rows past M, columns past N and K past its end read
//    as TMA zeros, which add nothing to the product.
//  * The epilogue: every value placed by acc_row / acc_col, bias[col]
//    added, `activate` applied (the activation a template argument),
//    rounded once, staged in a 50 KB shared-memory tile (the ring's stages
//    stay free for the next tile's loads) and written to device memory 16
//    bytes a thread along the rows, masked past M and N. The products stay
//    float32 until this single rounding.
//  * Allocates nothing; the wrapper allocates the output.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

#include "activation.cuh"
#include "sm90.cuh"

namespace {

using epilogue::activate;
using epilogue::ACT_GELU_EXACT;
using epilogue::ACT_NONE;
using sm90::Wgmma;

constexpr int BM = 128;                     // output rows per block (2 WGs)
constexpr int BN = 192;                     // output columns per block
constexpr int BK = 64;                      // K columns per stage: one slab
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // consumer threads
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;           // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr uint32_t kTileX = BM * 128;              // 16 KB
constexpr uint32_t kSlabW = BK * 128;              // one 64-column w slab
constexpr uint32_t kStage = kTileX + (BN / 64) * kSlabW;  // 40 KB
// the output tile staged for coalesced stores: BN 16-bit values a row plus
// 16 bytes, so the 8 rows a warp's fragment writes fall on distinct banks
constexpr uint32_t kEpiRow = BN * 2 + 16;
constexpr uint32_t kEpi = BM * kEpiRow;                       // 50 KB
constexpr uint32_t kSmem = kStages * kStage + kEpi + 1024;    // + alignment

// ACT is a template argument: `activate` then folds to one activation,
// inlined for each of the 96 values a thread writes. (A runtime switch
// inlined 96 times made the kernel several times larger and its epilogue
// slower on the H100.)
template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
hgemm_bias_act_sm90(const __grid_constant__ CUtensorMap tm_x,
                    const __grid_constant__ CUtensorMap tm_w,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int m, int n, int k) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const epi_all =
      smem_raw + (base - sm90::smem_u32(smem_raw)) + kStages * kStage;
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

  // Both roles walk the same tiles (M fastest) and count the same slabs:
  // slab `it` of the block lives in stage it % kStages, phase it / kStages.
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
          const uint32_t st = base + s * kStage;
          sm90::mbar_arrive_expect_tx(full(s), kStage);
          sm90::tma_load_3d(st, &tm_x, full(s), j * BK, m0, 0);
          for (int sl = 0; sl < BN / 64; ++sl)
            sm90::tma_load_3d(st + kTileX + sl * kSlabW, &tm_w, full(s),
                              n0 + sl * 64, j * BK, 0);
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
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_k; ++j, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = base + s * kStage;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a = st + wg * 64 * 128 + kk * 32;
        const uint32_t b = st + kTileX + kk * 16 * 128;
        Wgmma<BN, T>::template ss<1>(acc, sm90::desc_sw128(a, 16, 1024),
                                     sm90::desc_sw128(b, kSlabW, 1024), 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // slab it - 1's chain is done: release it
      sm90::fence_regs(acc);
      if (j > 0) sm90::mbar_arrive(empty((it - 1) % kStages));
    }
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc);
    // the tile's last slab: the producer may refill it for the next tile
    // while this one's epilogue runs
    if (n_k > 0) sm90::mbar_arrive(empty((it - 1) % kStages));

    // ---- epilogue: bias and activation on the float32 accumulator, one
    // rounding; the warpgroup's 64 rows staged in shared memory, then
    // written 16 bytes a thread along the rows (n % 8 == 0: a 16-byte
    // chunk is all in or all out). Writing the fragment's 4-byte pairs
    // straight to device memory scattered each warp's store over 8 rows and
    // cost more than the tile's products.
    uint8_t* const epi = epi_all + wg * 64 * kEpiRow;
    const int rl = sm90::acc_row(0, warp, lane);  // and rl + 8
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int cl = sm90::acc_col(4 * c, lane);
      const int col = n0 + cl;
      // two 4-byte loads: the bias may be a view 4 bytes off 8-byte
      // alignment
      const bool b_in = bias != nullptr && col < n;
      const float2 bv = make_float2(b_in ? __ldg(bias + col) : 0.f,
                                    b_in ? __ldg(bias + col + 1) : 0.f);
      *reinterpret_cast<uint32_t*>(epi + rl * kEpiRow + cl * 2) =
          sm90::pack2<T>(activate(acc[4 * c] + bv.x, ACT),
                         activate(acc[4 * c + 1] + bv.y, ACT));
      *reinterpret_cast<uint32_t*>(epi + (rl + 8) * kEpiRow + cl * 2) =
          sm90::pack2<T>(activate(acc[4 * c + 2] + bv.x, ACT),
                         activate(acc[4 * c + 3] + bv.y, ACT));
    }
    sm90::named_barrier(1 + wg, 128);
    constexpr int kChunks = BN / 8;  // 16-byte chunks a row
    for (int e = tid % 128; e < 64 * kChunks; e += 128) {
      const int r = e / kChunks, ch = e % kChunks;
      const int row = m0 + wg * 64 + r, col = n0 + ch * 8;
      if (row < m && col < n)
        *reinterpret_cast<uint4*>(out + (size_t)row * n + col) =
            *reinterpret_cast<const uint4*>(epi + r * kEpiRow + ch * 16);
    }
    sm90::named_barrier(1 + wg, 128);  // the staged tile is free again
  }
}

template <typename T, int ACT>
int launch(const void* x, const void* w, const float* bias, void* out, int m,
           int n, int k, int dtype, cudaStream_t stream) {
  CUtensorMap mx, mw;
  if (k > 0) {
    if (!sm90::make_map(&mx, x, dtype, 1, m, k, BM) ||
        !sm90::make_map(&mw, w, dtype, 1, k, n, BK))
      return -2;
  } else {  // no K loop: the kernel reads no tile (a map has no zero extent)
    std::memset(&mx, 0, sizeof(mx));
    std::memset(&mw, 0, sizeof(mw));
  }
  auto kernel = hgemm_bias_act_sm90<T, ACT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // persistent: one block an SM (its shared memory allows no second),
  // walking tiles gridDim.x apart
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long tiles =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, kSmem, stream>>>(mx, mw, bias, static_cast<T*>(out),
                                            m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_act(const void* x, const void* w, const float* bias, void* out,
                 int m, int n, int k, int dtype, int act, cudaStream_t st) {
  switch (act) {
    case epilogue::ACT_RELU:
      return launch<T, epilogue::ACT_RELU>(x, w, bias, out, m, n, k, dtype, st);
    case epilogue::ACT_TANH:
      return launch<T, epilogue::ACT_TANH>(x, w, bias, out, m, n, k, dtype, st);
    case epilogue::ACT_GELU:
      return launch<T, epilogue::ACT_GELU>(x, w, bias, out, m, n, k, dtype, st);
    case ACT_GELU_EXACT:
      return launch<T, ACT_GELU_EXACT>(x, w, bias, out, m, n, k, dtype, st);
    default:
      return launch<T, ACT_NONE>(x, w, bias, out, m, n, k, dtype, st);
  }
}

}  // namespace

// dl4j_fused_matmul's contract for dtype 1 = bfloat16 and 2 = float16 with
// k % 8 == 0, n % 8 == 0 and x, w, out 16-byte aligned: x (m, k), w (k, n),
// out (m, n) row-major; bias (n,) float32 or null; act 0..4 as `Act`.
// Returns cudaGetLastError() of the launch, -1 for arguments the kernel
// does not take, -2 when a tensor map cannot be encoded. Launches on
// `stream`; allocates nothing.
extern "C" int dl4j_fused_matmul_sm90(const void* x, const void* w,
                                      const float* bias, void* out,
                                      long long m, int n, int k, int dtype,
                                      int act, void* stream) {
  if (m < 0 || n < 0 || k < 0 || act < ACT_NONE || act > ACT_GELU_EXACT)
    return -1;
  if (k % 8 != 0 || n % 8 != 0 || m > INT_MAX - BM) return -1;
  // tile indices are ints
  if ((m + BM - 1) / BM * ((n + BN - 1) / (long long)BN) > INT_MAX) return -1;
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  if (dtype == 1)
    return dispatch_act<__nv_bfloat16>(x, w, bias, out, mi, n, k, dtype, act,
                                       st);
  if (dtype == 2)
    return dispatch_act<__half>(x, w, bias, out, mi, n, k, dtype, act, st);
  return -1;
}
