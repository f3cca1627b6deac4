// bn_matmul_stats_sm90.cu — fused BN-apply -> 1x1 conv (matmul) -> BN
// statistics on Hopper's tensor cores (sm_90a), bfloat16 operands, float32
// accumulation:
//
//     z = (relu?)(x * scale + shift) @ W          (prologue optional)
//     csum[i, :] = sum over the rows of block i of (acc - s)
//     csq[i, :]  = sum over the rows of block i of (acc - s)^2
//
// x (M, K) bf16, W (K, N) bf16, scale/shift (K,) f32, s (N,) f32 — the
// running mean that shifts the moments; z (M, N) bf16; csum/csq
// (M/128, N) f32 partial sums of 128-row blocks, taken from the float32
// accumulator `acc` before z is rounded, reduced by the wrapper. The
// contract of bn_matmul_stats.cu (`dl4j_bn_matmul_stats`), whose WMMA
// kernel keeps the operands TMA cannot read (`convbn_design`).
//
// Replaces: deeplearning4j_tpu/ops/pallas_convbn.py `_kernel`, reached
// through `fused_bn_matmul_stats`. Same math: the prologue in float32
// (x*scale, then +shift, then relu, each rounded: __fmul_rn, __fadd_rn)
// rounded to bf16 before the product, as the Pallas kernel and
// `reference_bn_matmul_stats` do; the statistics from the float32
// accumulator, as the Pallas kernel takes them. No atomics: the sums are
// reduced in a fixed order, so two runs give the same bits.
//
// What bounds it on the H100: x and z are M*K and M*N bf16, the product
// 2*M*K*N operations (989 TFLOP/s bf16). At the ResNet-50 shapes it is
// bound by bytes from K = 64 (stage-1 c3: 51 MB in, 205 MB of z out) to
// K = 1024 (stage-3 c1), and by neither by much at K = 2048.
//
// Design (the producer / consumer ring of fused_matmul_sm90.cu):
//  * A persistent block an SM: a producer warpgroup that hands its
//    registers to the consumers (setmaxnreg 24 / 240) and issues TMA from
//    one thread, and two consumer warpgroups that take the block's tiles in
//    turn ("ping-pong"): each computes a whole 128 x BN tile (two m64nBNk16
//    wgmma chains), so one warpgroup's epilogue — the z store and the
//    statistics, most of the work at K 64 — runs under the other's
//    prologue and products. The mainloops keep tile order on the ring: a
//    warpgroup starts waiting on its tile's slabs only after the other has
//    passed the previous tile's (the `turn` mbarriers); a consumer more
//    than one ring pass ahead would misread a stage's phase parity.
//  * Tiles are walked N fastest: the blocks in flight share x's row tile in
//    L2, so x leaves device memory once whatever BN. The producer runs on
//    into the next tiles' slabs while the consumers write z.
//  * A ring of four stages guarded by full / empty mbarriers; a stage is a
//    64-column slab: the x tile (128 x 64, K-major, 16 KB) and the w tile
//    (64 x BN as BN/64 64-column slabs, N contiguous, read MN-major
//    through wgmma's transpose bit).
//  * BN (64 or 128) is a template argument the wrapper picks by N, for the
//    fuller last wave on the card's SMs (`convbn_tile_n`).
//  * The prologue rewrites the slab in place (not the register A operand:
//    one code path, the ss product, serves both cases, and the no-prologue
//    calls skip the rewrite). Each consumer thread owns one 16-byte chunk
//    column of the 128 rows; the 128-byte swizzle maps it to the same 8 K
//    columns in all eight of its rows, so it loads those 8 scales and
//    shifts once a slab (once a kernel when K is one slab). Then
//    fence.proxy.async — without it the tensor cores may read the bytes
//    TMA wrote, not the prologue's — and a warpgroup barrier before the
//    wgmma.
//  * z is rounded once to bf16 and staged in shared memory in TMA's
//    128-byte-swizzled layout; one thread stores it with bulk tensor stores
//    (`cp.async.bulk.tensor`), waited on only before the warpgroup's next
//    tile reuses the staging tile. (On the H100 this beat every thread
//    writing 16-byte row chunks from a padded tile by 1.6-6% at the
//    ResNet-50 shapes; PERF.md.)
//  * The statistics come from the accumulator registers: each value placed
//    by acc_row / acc_col, s[col] subtracted, a thread's four rows of a
//    column folded in place, then a reduce-scatter over the 8 lanes that
//    share a column (__shfl_xor 16, 8, 4: each round hands half the values
//    to the partner, 7/8 of a shuffle a value instead of 3), then the 4
//    warps summed through shared memory in warp order.
//  * Allocates nothing; the wrapper allocates z and the partial sums.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                     // rows a tile
constexpr int BK = 64;                      // K columns a stage: one slab
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups, in turn
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr uint32_t kTileX = BM * 128;       // 16 KB
constexpr uint32_t kSlabW = BK * 128;       // one 64-column w slab, 8 KB

template <int BN>
struct Cfg {
  static constexpr uint32_t kStage = kTileX + (BN / 64) * kSlabW;
  // a warpgroup's z staging tile: BN/64 swizzled 128-row slabs
  static constexpr uint32_t kEpi = (BN / 64) * BM * 128;
  static constexpr uint32_t kRed = 2 * 4 * BN * 4;  // [sum|sq][warp][col]
  static constexpr uint32_t kSmem =
      kStages * kStage + 2 * (kEpi + kRed) + 1024;
};

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
bn_matmul_stats_sm90(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_z,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     const float* __restrict__ stat_shift,
                     float* __restrict__ csum, float* __restrict__ csq,
                     int m, int n, int k, int prologue, int relu) {
  using C = Cfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 2];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gen = smem_raw + (base - raw);  // generic view of `base`
  auto full = [&](int s) { return sm90::smem_u32(&bars[s]); };
  auto empty = [&](int s) { return sm90::smem_u32(&bars[kStages + s]); };
  // turn(w): warpgroup w has passed the ring waits of one more tile
  auto turn = [&](int w) { return sm90::smem_u32(&bars[2 * kStages + w]); };

  const int tiles_n = (n + BN - 1) / BN;
  const int n_tiles = (m / BM) * tiles_n;
  const int n_k = k / BK;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 128);  // one warpgroup consumes a slab
    }
    sm90::mbar_init(turn(0), 128);
    sm90::mbar_init(turn(1), 128);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // The block's tiles are t = blockIdx.x + i * gridDim.x, i = 0, 1, ...;
  // warpgroup i % 2 computes tile i. Slab `it` of the block (tile it / n_k)
  // lives in stage it % kStages, phase it / kStages.
  if (tid >= kConsumers) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int m0 = (t / tiles_n) * BM;
        const int n0 = (t % tiles_n) * BN;
        for (int j = 0; j < n_k; ++j, ++it) {
          const int s = it % kStages;
          if (it >= kStages) sm90::mbar_wait(empty(s), (it / kStages - 1) & 1);
          const uint32_t st = base + s * C::kStage;
          sm90::mbar_arrive_expect_tx(full(s), C::kStage);
          sm90::tma_load_3d(st, &tm_x, full(s), j * BK, m0, 0);
#pragma unroll
          for (int sl = 0; sl < BN / 64; ++sl)
            sm90::tma_load_3d(st + kTileX + sl * kSlabW, &tm_w, full(s),
                              n0 + sl * 64, j * BK, 0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg computes the block's tiles wg, wg + 2, ...
  sm90::setmaxnreg_inc<kConsumerRegs>();
  const int wg = tid / 128;
  const int tw = tid % 128;
  const int warp = tw / 32;
  const int lane = tid % 32;
  uint8_t* const epi = gen + kStages * C::kStage + wg * C::kEpi;
  const uint32_t epi_s = base + kStages * C::kStage + wg * C::kEpi;
  float* const red = reinterpret_cast<float*>(gen + kStages * C::kStage +
                                              2 * C::kEpi + wg * C::kRed);
  // the prologue's chunk: physical 16-byte chunk `pc` of rows
  // tw / 8 + 16 i (i = 0..7); every one of them has r % 8 == (tw / 8) % 8,
  // so the swizzle maps the chunk to the same logical K columns 8 lc..+7
  const int pc = tw % 8;
  const int lc = pc ^ ((tw / 8) & 7);
  float sc[8], sh[8];
  auto load_affine = [&](int j) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      sc[e] = __ldg(scale + j * BK + lc * 8 + e);
      sh[e] = __ldg(shift + j * BK + lc * 8 + e);
    }
  };
  if (prologue && n_k == 1) load_affine(0);  // the same slab every tile

  for (int i = wg, t = blockIdx.x + wg * gridDim.x; t < n_tiles;
       i += 2, t += 2 * gridDim.x) {
    const int m0 = (t / tiles_n) * BM;
    const int n0 = (t % tiles_n) * BN;
    // tile i - 1 (the other warpgroup's ((i - 1) / 2)-th) has passed its
    // ring waits: this one's slabs are the ring's next
    if (i > 0) sm90::mbar_wait(turn(1 - wg), ((i - 1) / 2) & 1);
    float acc0[BN / 2], acc1[BN / 2];  // rows 0..63 and 64..127
#pragma unroll
    for (int v = 0; v < BN / 2; ++v) acc0[v] = acc1[v] = 0.f;

    int it = i * n_k;
    for (int j = 0; j < n_k; ++j, ++it) {
      const int s = it % kStages;
      sm90::mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t st = base + s * C::kStage;
      if (prologue) {  // relu?(x * scale + shift) -> bf16, in place
        if (n_k > 1) load_affine(j);
        uint8_t* const rows = gen + s * C::kStage;
#pragma unroll
        for (int r8 = 0; r8 < 8; ++r8) {
          uint4* const p = reinterpret_cast<uint4*>(
              rows + (tw / 8 + 16 * r8) * 128 + pc * 16);
          uint4 v = *p;
          bf16* const e8 = reinterpret_cast<bf16*>(&v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            float y = __fadd_rn(__fmul_rn(__bfloat162float(e8[e]), sc[e]),
                                sh[e]);
            if (relu) y = fmaxf(y, 0.f);
            e8[e] = __float2bfloat16(y);
          }
          *p = v;
        }
        sm90::fence_proxy_async();  // the generic writes, before wgmma
        sm90::named_barrier(1 + wg, 128);
      }
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b =
            sm90::desc_sw128(st + kTileX + kk * 16 * 128, kSlabW, 1024);
        sm90::Wgmma<BN, bf16>::template ss<1>(
            acc0, sm90::desc_sw128(st + kk * 32, 16, 1024), b, 1);
        sm90::Wgmma<BN, bf16>::template ss<1>(
            acc1, sm90::desc_sw128(st + 64 * 128 + kk * 32, 16, 1024), b, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // slab it - 1's chains are done: release it
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      if (j > 0) sm90::mbar_arrive(empty((it - 1) % kStages));
    }
    sm90::mbar_arrive(turn(wg));  // the other warpgroup's tile may start
    sm90::wgmma_wait_all();
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    sm90::mbar_arrive(empty((it - 1) % kStages));

    // ---- z: rounded once to bf16 and staged
    const int rl = sm90::acc_row(0, warp, lane);  // and rl + 8, + 64, + 72
    // the store of this warpgroup's last tile has read the staging tile
    if (tw == 0) sm90::bulk_wait_read<0>();
    sm90::named_barrier(1 + wg, 128);
    // column 8c + 2 (lane & 3): slab c / 8, 16-byte chunk c % 8 of the
    // row, XOR-swizzled by the row's r % 8 (= rl % 8 for all four rows)
    auto stage = [&](const float (&a)[BN / 2], int r) {
#pragma unroll
      for (int c = 0; c < BN / 8; ++c) {
        uint8_t* const p = epi + (c / 8) * BM * 128 + r * 128 +
                           (((c % 8) ^ (rl & 7)) * 16) + 4 * (lane & 3);
        *reinterpret_cast<uint32_t*>(p) =
            sm90::pack2<bf16>(a[4 * c], a[4 * c + 1]);
        *reinterpret_cast<uint32_t*>(p + 8 * 128) =
            sm90::pack2<bf16>(a[4 * c + 2], a[4 * c + 3]);
      }
    };
    stage(acc0, rl);
    stage(acc1, 64 + rl);
    sm90::fence_proxy_async();  // the staged tile, before TMA reads it
    sm90::named_barrier(1 + wg, 128);
    if (tw == 0) {
      for (int sl = 0; sl < BN / 64; ++sl)
        if (n0 + sl * 64 < n)
          sm90::tma_store_3d(&tm_z, epi_s + sl * BM * 128, n0 + sl * 64,
                             m0, 0);
      sm90::bulk_commit();
    }

    // ---- statistics from the float32 accumulator. Fold the thread's four
    // rows of each column in place: value 4c+0 / 4c+1 of acc0 becomes the
    // sum of (acc - s) over them for columns cl / cl + 1, 4c+2 / 4c+3 the
    // sum of squares (columns past N: s = 0, and the zeros TMA read add
    // nothing)
#pragma unroll
    for (int c = 0; c < BN / 8; ++c) {
      const int col = n0 + sm90::acc_col(4 * c, lane);
      const float s0 = col < n ? __ldg(stat_shift + col) : 0.f;
      const float s1 = col + 1 < n ? __ldg(stat_shift + col + 1) : 0.f;
      const float a0 = acc0[4 * c] - s0, b0 = acc0[4 * c + 2] - s0;
      const float c0 = acc1[4 * c] - s0, d0 = acc1[4 * c + 2] - s0;
      const float a1 = acc0[4 * c + 1] - s1, b1 = acc0[4 * c + 3] - s1;
      const float c1 = acc1[4 * c + 1] - s1, d1 = acc1[4 * c + 3] - s1;
      acc0[4 * c] = (a0 + b0) + (c0 + d0);
      acc0[4 * c + 1] = (a1 + b1) + (c1 + d1);
      acc0[4 * c + 2] = fmaf(b0, b0, a0 * a0) + fmaf(d0, d0, c0 * c0);
      acc0[4 * c + 3] = fmaf(b1, b1, a1 * a1) + fmaf(d1, d1, c1 * c1);
    }
    // reduce-scatter over the 8 lanes of a column (lane bits 4, 3, 2): in
    // each round a lane keeps one half of its live values, adds the
    // partner's copy of that half and hands over the other half
    constexpr int V = BN / 2;
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const bool hi = lane & 16;
      const float give = hi ? acc0[j] : acc0[j + V / 2];
      const float keep = hi ? acc0[j + V / 2] : acc0[j];
      acc0[j] = keep + __shfl_xor_sync(0xffffffffu, give, 16);
    }
#pragma unroll
    for (int j = 0; j < V / 4; ++j) {
      const bool hi = lane & 8;
      const float give = hi ? acc0[j] : acc0[j + V / 4];
      const float keep = hi ? acc0[j + V / 4] : acc0[j];
      acc0[j] = keep + __shfl_xor_sync(0xffffffffu, give, 8);
    }
#pragma unroll
    for (int j = 0; j < V / 8; ++j) {
      const bool hi = lane & 4;
      const float give = hi ? acc0[j] : acc0[j + V / 8];
      const float keep = hi ? acc0[j + V / 8] : acc0[j];
      acc0[j] = keep + __shfl_xor_sync(0xffffffffu, give, 4);
    }
    // value j now stands for folded value L = j + off of every lane of the
    // column, summed over the warp's 32 rows (V / 8 is a multiple of 4, so
    // L % 4 == j % 4: the kind and the column parity are j's)
    const int off = ((lane & 4) ? V / 8 : 0) + ((lane & 8) ? V / 4 : 0) +
                    ((lane & 16) ? V / 2 : 0);
#pragma unroll
    for (int j = 0; j < V / 8; ++j) {
      const int col = 8 * ((j + off) >> 2) + 2 * (lane & 3) + (j & 1);
      const int kind = (j >> 1) & 1;  // 0 sum, 1 sum of squares
      red[(kind * 4 + warp) * BN + col] = acc0[j];
    }
    sm90::named_barrier(1 + wg, 128);
    for (int e = tw; e < 2 * BN; e += 128) {
      const int kind = e / BN, col = e % BN;
      const float v = ((red[(kind * 4) * BN + col] +
                        red[(kind * 4 + 1) * BN + col]) +
                       red[(kind * 4 + 2) * BN + col]) +
                      red[(kind * 4 + 3) * BN + col];
      if (n0 + col < n)
        (kind ? csq : csum)[(size_t)(m0 / BM) * n + n0 + col] = v;
    }
    // the warp partials are free again
    sm90::named_barrier(1 + wg, 128);
  }
  // the last bulk stores must have read shared memory before it is freed
  if (tw == 0) sm90::bulk_wait_read<0>();
}

template <int BN>
int launch(const void* x, const float* scale, const float* shift,
           const void* w, const float* stat_shift, void* z, float* csum,
           float* csq, int m, int k, int n, int prologue, int relu,
           cudaStream_t stream) {
  CUtensorMap mx, mw, mz;
  if (!sm90::make_map(&mx, x, 1, 1, m, k, BM) ||
      !sm90::make_map(&mw, w, 1, 1, k, n, BK) ||
      !sm90::make_map(&mz, z, 1, 1, m, n, BM))
    return -2;
  using C = Cfg<BN>;
  auto kernel = bn_matmul_stats_sm90<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 1;
  }();
  const long long tiles = (long long)(m / BM) * ((n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      mx, mw, mz, scale, shift, stat_shift, csum, csq, m, n, k, prologue,
      relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dl4j_bn_matmul_stats's contract on the tensor cores: M % 128 == 0,
// K % 64 == 0, N % 64 == 0; x, w and z 16-byte aligned (TMA);
// scale/shift/stat_shift read as scalars (any alignment). `bn` is the tile
// width, 64 or 128.
// Returns cudaGetLastError() of the launch, -1 for arguments the kernel
// does not take, -2 when a tensor map cannot be encoded. Launches on
// `stream`; allocates nothing.
extern "C" int dl4j_bn_matmul_stats_sm90(const void* x, const float* scale,
                                         const float* shift, const void* w,
                                         const float* stat_shift, void* z,
                                         float* csum, float* csq, long long m,
                                         int k, int n, int prologue, int relu,
                                         int bn, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m % BM || k % BK || n % 64) return -1;
  if (m > 0x7fffffffLL) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mi = static_cast<int>(m);
  if (bn == 64)
    return launch<64>(x, scale, shift, w, stat_shift, z, csum, csq, mi, k, n,
                      prologue, relu, st);
  if (bn == 128)
    return launch<128>(x, scale, shift, w, stat_shift, z, csum, csq, mi, k, n,
                       prologue, relu, st);
  return -1;
}
