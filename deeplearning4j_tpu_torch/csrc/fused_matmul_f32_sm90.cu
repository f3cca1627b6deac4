// fused_matmul_f32_sm90.cu — act(x @ w + b) for float32 operands on
// Hopper's tensor cores (sm_90a), every product accurate to float32 by a
// split into TF32 parts:
//
//     out = act(x @ w + b)        x (M, K), w (K, N), b (N,), out (M, N) f32
//
// Replaces: deeplearning4j_tpu/ops/pallas_matmul.py `_kernel`, reached
// through `fused_matmul_bias_act_pallas`, for float32 — which on the TPU
// hands the MXU float32 operands (Mosaic's multi-pass float32 path) — with
// fused_matmul.cu's contract (`dl4j_fused_matmul`): x and w row-major
// float32; the bias float32 or null, added to the float32 accumulator; the
// activation (activation.cuh: none, relu, tanh, gelu, gelu_exact) in
// float32; one write. Takes K % 4 == 0 and a 16-byte-aligned x (TMA's row
// stride and address); any M and N. Other float32 shapes keep the CUDA-core
// SGEMM of fused_matmul.cu (`cuda_matmul.matmul_design` chooses).
//
// Numerics: never single-pass TF32. x = x_hi + x_lo and w = w_hi + w_lo
// with hi = tf32(v), lo = tf32(v - hi) (sm90.cuh `tf32_split`), and each
// 32-deep K slab adds x_lo·w_hi, then x_hi·w_lo, then x_hi·w_hi: the terms
// left out (x_lo·w_lo and the lo parts' rounding) are ~2^-22 of each
// |x·w|. The tensor cores add each k-step's products into their float32
// accumulator in a rounding of their own that loses about a unit of the
// sum each time; so they sum 64 K values (two slabs, `kPromote`) from
// zero, and that partial sum is promoted into the tile's float32 sum by
// adds rounded to nearest. On the H100 (BERT-base shapes, chip_smoke's
// data) that holds the kernel at 0.02–0.10 of the float32 check
// (`cuda_matmul.kernel_tolerance`) where one accumulator over the whole K
// sat at 0.39–0.78, and one TF32 pass breaks the check 8–20×.
//
// What bounds it on the H100: 2·M·K·N operations, three times over on
// TF32 tensor cores (494.7 TFLOP/s dense, so 165 TFLOP/s of float32
// products), against (M·K + K·N + M·N) float32 values — at the imported
// BERT-base shapes (M 4096, K×N 768×768, 768×3072, 3072×768) 300–750
// operations a byte, so the tensor cores are the limit.
//
// Design (the skeleton of fused_matmul_sm90.cu and matmul_int8_sm90.cu):
//  * TF32 wgmma reads shared-memory operands K-major only, and w (K, N) is
//    not: the wrapper hands the kernel the weight's K-major split copy ws
//    (2, N, K) = (w_hi, w_lo) transposed, made once a weight by
//    `dl4j_tf32_split_weight` below (`cuda_matmul.kmajor_weight`) — so w
//    is split once, not once a tile.
//    x is split in registers: a consumer reads its A fragment from the
//    landed x slab (`tf32_a_row` / `tf32_a_col`, four 4-byte loads a
//    k-step, no bank conflicts under the swizzle), splits it, and issues
//    the three passes as register-A (rs) wgmma m64nBNk8 chains.
//  * A persistent block an SM: a producer warpgroup (setmaxnreg 24) that
//    issues TMA from one thread, two consumer warpgroups (240) of 64 rows.
//    Tiles 128 x BN walked M fastest (the blocks in flight share ws's
//    column tile in L2); the producer runs on into the next tile while the
//    consumers write the last.
//  * A stage is one 128-byte swizzle span of K — 32 float32 columns: x
//    (128 x 32, 16 KB), w_hi and w_lo (BN x 32 each). BN (128 or 192) is a
//    template argument the wrapper picks for the fuller last wave
//    (`fullest_tile_n`): BN 192 is 64 KB a stage, 3 stages (192 KB); BN 128
//    48 KB, 4 stages (192 KB); the 227 KB of shared memory leave no room
//    for a staged output tile beside them, so the epilogue stores from the
//    registers (a warp's float2 stores fill whole 32-byte sectors: 8 rows x
//    4 threads x 8 bytes).
//  * A stage's A fragments are registers the chain reads asynchronously,
//    so a consumer waits for its chain (wait_group 0) before it loads the
//    next slab's: the two warpgroups' chains interleave on the tensor cores
//    in that gap, and the ring keeps TMA 2–3 stages ahead. The partial sum
//    takes BN/2 registers beside the tile's BN/2 and the 32 fragment
//    registers: 224 of the 240 at BN 192. Promoting after every slab cost
//    up to 36% of the time at K 3072 (the adds sit between two chains);
//    every second slab costs nothing measurable.
//  * Edges: 3-D tensor maps over (columns, rows, 1 or 2); rows past M,
//    columns past N and K past its end read as TMA zeros, which add
//    nothing to the product; the epilogue masks rows past M and columns
//    past N (float2 stores where N is even, else single floats).
//  * Allocates nothing; the wrapper allocates the output and the split copy.

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
using sm90::WgmmaTf32;

constexpr int BM = 128;                     // rows a tile (2 warpgroups)
constexpr int BK = 32;                      // K values a stage: one span
constexpr int kPromote = 2;                 // slabs summed before promotion
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;           // 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;
constexpr uint32_t kTileX = BM * 128;       // 16 KB
constexpr uint32_t kSmemBudget = 232448 - 1024 - 256;  // - align, statics

template <int BN>
struct Cfg {
  static constexpr uint32_t kPart = BN * 128;           // w_hi or w_lo
  static constexpr uint32_t kStage = kTileX + 2 * kPart;
  static constexpr int kFit = kSmemBudget / kStage;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr uint32_t kSmem = kStages * kStage + 1024;
  static_assert(kStages >= 2, "the ring needs two stages");
};

template <int BN, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
sgemm_split_sm90(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ bias, float* __restrict__ out,
                 int m, int n, int k) {
  using C = Cfg<BN>;
  constexpr int kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
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
          const uint32_t st = base + s * C::kStage;
          sm90::mbar_arrive_expect_tx(full(s), C::kStage);
          sm90::tma_load_3d(st, &tm_x, full(s), j * BK, m0, 0);
          sm90::tma_load_3d(st + kTileX, &tm_w, full(s), j * BK, n0, 0);
          sm90::tma_load_3d(st + kTileX + C::kPart, &tm_w, full(s), j * BK,
                            n0, 1);
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
  // this thread's A-fragment rows within the warpgroup's 64 (r and r + 8:
  // the same row % 8, so one swizzle phase)
  const int ar = sm90::tf32_a_row(0, warp, lane);
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int m0 = (t % tiles_m) * BM;
    const int n0 = (t / tiles_m) * BN;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    float part[BN / 2];  // the sum of the current kPromote slabs

    for (int j = 0; j < n_k; ++j, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = base + s * C::kStage;
      // the x slab's A fragments, split: value (row, col) of the swizzled
      // slab sits at row * 128 + ((col / 4) ^ (row % 8)) * 16 + (col % 4) * 4
      uint32_t hi[BK / 8][4], lo[BK / 8][4];
      const uint32_t xrow = st + (wg * 64 + ar) * 128;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = 8 * kk + sm90::tf32_a_col(r, lane);
          const uint32_t a = xrow + (r & 1) * 8 * 128 +
                             (((col >> 2) ^ (ar & 7)) << 4) + (col & 3) * 4;
          sm90::tf32_split(sm90::lds_f32(a), hi[kk][r], lo[kk][r]);
        }
      }
      sm90::fence_regs(part);
      sm90::wgmma_fence();
      const uint32_t w_hi = st + kTileX, w_lo = w_hi + C::kPart;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        WgmmaTf32<BN>::rs(part, lo[kk],
                          sm90::desc_sw128(w_hi + kk * 32, 16, 1024),
                          kk > 0 || j % kPromote != 0);  // 0: restart
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        WgmmaTf32<BN>::rs(part, hi[kk],
                          sm90::desc_sw128(w_lo + kk * 32, 16, 1024), 1);
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk)
        WgmmaTf32<BN>::rs(part, hi[kk],
                          sm90::desc_sw128(w_hi + kk * 32, 16, 1024), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(part);
      sm90::mbar_arrive(empty(s));
      // promoted into the tile's sum by float32 adds rounded to nearest
      if (j % kPromote == kPromote - 1 || j == n_k - 1) {
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
      }
    }

    // ---- epilogue: bias and activation on the float32 accumulator, one
    // write from the registers
    const int rl = m0 + wg * 64 + sm90::acc_row(0, warp, lane);  // and + 8
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = n0 + sm90::acc_col(4 * c, lane);
      if (col >= n) continue;
      const bool in1 = col + 1 < n;
      const float b0 = bias != nullptr ? __ldg(bias + col) : 0.f;
      const float b1 = bias != nullptr && in1 ? __ldg(bias + col + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h;
        if (row >= m) continue;
        const float v0 = activate(acc[4 * c + 2 * h] + b0, ACT);
        const float v1 = activate(acc[4 * c + 2 * h + 1] + b1, ACT);
        float* p = out + (size_t)row * n + col;
        if ((n & 1) == 0) {  // col even, n even: an aligned pair
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (in1) p[1] = v1;
        }
      }
    }
  }
}

template <int BN, int ACT>
int launch(const float* x, const float* ws, const float* bias, float* out,
           int m, int n, int k, cudaStream_t stream) {
  using C = Cfg<BN>;
  CUtensorMap mx, mw;
  if (k > 0) {
    if (!sm90::make_map(&mx, x, 0, 1, m, k, BM) ||
        !sm90::make_map(&mw, ws, 0, 2, n, k, BN))
      return -2;
  } else {  // no K loop: the kernel reads no tile (a map has no zero extent)
    std::memset(&mx, 0, sizeof(mx));
    std::memset(&mw, 0, sizeof(mw));
  }
  auto kernel = sgemm_split_sm90<BN, ACT>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // persistent: one block an SM, walking tiles gridDim.x apart
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long tiles =
      (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(mx, mw, bias, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int dispatch_act(const float* x, const float* ws, const float* bias,
                 float* out, int m, int n, int k, int act, cudaStream_t st) {
  switch (act) {
    case epilogue::ACT_RELU:
      return launch<BN, epilogue::ACT_RELU>(x, ws, bias, out, m, n, k, st);
    case epilogue::ACT_TANH:
      return launch<BN, epilogue::ACT_TANH>(x, ws, bias, out, m, n, k, st);
    case epilogue::ACT_GELU:
      return launch<BN, epilogue::ACT_GELU>(x, ws, bias, out, m, n, k, st);
    case ACT_GELU_EXACT:
      return launch<BN, ACT_GELU_EXACT>(x, ws, bias, out, m, n, k, st);
    default:
      return launch<BN, ACT_NONE>(x, ws, bias, out, m, n, k, st);
  }
}

// ws (2, n, k) = (tf32(wᵀ), tf32(wᵀ - tf32(wᵀ))) of a (k, n) row-major w:
// 32 x 32 tiles through shared memory, read along w's rows and written
// along ws's.
__global__ void __launch_bounds__(256)
split_weight(const float* __restrict__ w, float* __restrict__ ws, int k,
             int n) {
  __shared__ float tile[32][33];
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int kk = k0 + i, nn = n0 + tx;
    tile[i][tx] = kk < k && nn < n ? __ldg(w + (size_t)kk * n + nn) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int nn = n0 + i, kk = k0 + tx;
    if (nn >= n || kk >= k) continue;
    uint32_t hi, lo;
    sm90::tf32_split(tile[tx][i], hi, lo);
    const size_t at = (size_t)nn * k + kk;
    ws[at] = __uint_as_float(hi);
    ws[(size_t)n * k + at] = __uint_as_float(lo);
  }
}

}  // namespace

// The K-major split copy the kernel below reads: ws (2, n, k) from a (k, n)
// row-major float32 w, both parts rounded as sm90.cuh `tf32_split` rounds
// (to nearest, ties away from zero: cuda_matmul.tf32_split on the CPU gives
// the same bits). Returns cudaGetLastError() of the launch, -1 for
// arguments not taken. Launches on `stream`; allocates nothing.
extern "C" int dl4j_tf32_split_weight(const float* w, float* ws, int k, int n,
                                      void* stream) {
  if (k < 0 || n < 0 || (k + 31) / 32 > 65535) return -1;
  if (k == 0 || n == 0) return 0;
  split_weight<<<dim3((n + 31) / 32, (k + 31) / 32), 256, 0,
                 static_cast<cudaStream_t>(stream)>>>(w, ws, k, n);
  return static_cast<int>(cudaGetLastError());
}

// dl4j_fused_matmul's contract for float32 with k % 4 == 0 and x 16-byte
// aligned: x (m, k) row-major; ws (2, n, k), the K-major split copy of the
// (k, n) weight — ws[0] = tf32(wᵀ), ws[1] = tf32(wᵀ - ws[0]); bias (n,) or
// null; out (m, n) row-major, 8-byte aligned; act 0..4 as `Act`; `bn` the
// tile width, 128 or 192. Returns cudaGetLastError() of the launch, -1 for
// arguments the kernel does not take, -2 when a tensor map cannot be
// encoded. Launches on `stream`; allocates nothing.
extern "C" int dl4j_fused_matmul_f32_sm90(const float* x, const float* ws,
                                          const float* bias, float* out,
                                          long long m, int n, int k, int act,
                                          int bn, void* stream) {
  if (m < 0 || n < 0 || k < 0 || k % 4 != 0 || act < ACT_NONE ||
      act > ACT_GELU_EXACT || m > INT_MAX - BM)
    return -1;
  // tile indices are ints
  if ((m + BM - 1) / BM * ((n + 127) / 128LL) > INT_MAX) return -1;
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  if (bn == 128) return dispatch_act<128>(x, ws, bias, out, mi, n, k, act, st);
  if (bn == 192) return dispatch_act<192>(x, ws, bias, out, mi, n, k, act, st);
  return -1;
}
