// bn_matmul_stats.cu — fused BN-apply -> 1x1 conv (matmul) -> BN statistics
// for Hopper (sm_90a), bfloat16 operands, float32 accumulation:
//
//     z = (relu?)(x * scale + shift) @ W          (prologue optional)
//     csum[i, :] = sum over the rows of block i of (z - s)
//     csq[i, :]  = sum over the rows of block i of (z - s)^2
//
// x (M, K) bf16, W (K, N) bf16, scale/shift (K,) f32, s (N,) f32 — the
// running mean that shifts the moments; z (M, N) bf16; csum/csq
// (M/128, N) f32 partial sums, reduced over the row blocks by the wrapper.
//
// Replaces: deeplearning4j_tpu/ops/pallas_convbn.py `_kernel`, reached
// through `fused_bn_matmul_stats`. Same math: the prologue is applied in
// float32 (x*scale, then +shift, then relu) and rounded to bf16 before the
// product, as the Pallas kernel does; the statistics come from the float32
// accumulator, before z is rounded to bf16, as in the Pallas kernel.
//
// What bounds it on the H100: at the ResNet-50 shapes it is near the
// balance point — x and z are M*K and M*N bf16 (bytes), the product is
// 2*M*K*N flops on the tensor cores (989 TFLOP/s bf16); with K = 64 (the
// first stage's c3) the bytes bound, with K = 1024 the flops do.
//
// Design, and what it does about the TPU original:
//  * Pallas walks a (M, N, K) grid in order and keeps the accumulator in
//    VMEM across the sequential K axis. Here one block of 256 threads owns
//    a 128x64 output tile and walks K itself, 32 columns at a time, through
//    shared memory; the tensor cores multiply through WMMA bf16 16x16x16
//    fragments (8 warps, each a 32x32 sub-tile), accumulating in float32.
//  * The prologue runs while the A tile is staged: 16-byte loads of x,
//    the affine and relu in float32 with the same two roundings as the
//    plain version (__fmul_rn, __fadd_rn), then bf16 into shared memory.
//  * Epilogue: the accumulator goes through shared memory once; z is
//    written as bf16 with 16-byte stores, and each column's shifted sum
//    and sum of squares over the tile's 128 rows are reduced in a fixed
//    order into the block's row of csum/csq. No atomics: the result does
//    not depend on block scheduling.
//  * No TMA, no wgmma, no double buffering: bn_matmul_stats_sm90.cu is the
//    tensor-core design, and this kernel keeps only the x and w pointers
//    it cannot read (off 16-byte alignment: `convbn_design`). So x and w
//    are read in 16-byte vectors where `vec_x` / `vec_w` say the pointer
//    allows it, one element at a time otherwise.
//  * Allocates nothing; the wrapper allocates z and the partial sums.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;   // bf16 elements; a multiple of 8 (WMMA)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // float elements; a multiple of 4 (WMMA)
constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

__global__ void __launch_bounds__(THREADS)
bn_matmul_stats_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ stat_shift,
                       __nv_bfloat16* __restrict__ z,
                       float* __restrict__ csum, float* __restrict__ csq,
                       int k_dim, int n, int grid_n, int prologue, int relu,
                       int vec_x, int vec_w) {
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ float red_sum[THREADS / BN][BN];
  __shared__ float red_sq[THREADS / BN][BN];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  float* Cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 4 warps down M, 32 rows each
  const int wn = warp % 2;  // 2 warps across N, 32 columns each
  const int mb = blockIdx.x / grid_n;
  const int nb = blockIdx.x % grid_n;
  const long long m0 = (long long)mb * BM;
  const int n0 = nb * BN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < k_dim; k0 += BK) {
    // A tile: 128 rows x 32 columns = 512 vectors of 8 bf16, 2 per thread
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS;
      const int row = idx / (BK / 8);
      const int cv = (idx % (BK / 8)) * 8;
      const __nv_bfloat16* src = x + (m0 + row) * k_dim + k0 + cv;
      uint4 raw;
      if (vec_x) {
        raw = *reinterpret_cast<const uint4*>(src);
      } else {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = src[j];
      }
      if (prologue) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float y = __fadd_rn(__fmul_rn(__bfloat162float(e[j]),
                                        __ldg(scale + k0 + cv + j)),
                              __ldg(shift + k0 + cv + j));
          if (relu) y = fmaxf(y, 0.f);
          e[j] = __float2bfloat16(y);
        }
      }
      *reinterpret_cast<uint4*>(As + row * LDA + cv) = raw;
    }
    // B tile: 32 rows x 64 columns = 256 vectors, 1 per thread
    {
      const int row = tid / (BN / 8);
      const int cv = (tid % (BN / 8)) * 8;
      const __nv_bfloat16* src = w + (long long)(k0 + row) * n + n0 + cv;
      if (vec_w) {
        *reinterpret_cast<uint4*>(Bs + row * LDB + cv) =
            *reinterpret_cast<const uint4*>(src);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) Bs[row * LDB + cv + j] = src[j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j],
                                                   acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: the float32 tile into shared memory (over As/Bs)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  // z as bf16: 128 x 64 = 1024 vectors of 8, 4 per thread
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = tid + i * THREADS;
    const int row = idx / (BN / 8);
    const int cv = (idx % (BN / 8)) * 8;
    uint4 out;
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&out);
#pragma unroll
    for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(Cs[row * LDC + cv + j]);
    *reinterpret_cast<uint4*>(z + (m0 + row) * n + n0 + cv) = out;
  }

  // shifted column moments from the float32 accumulator: 4 threads per
  // column, 32 rows each, then the 4 partials in a fixed order
  {
    const int col = tid % BN;
    const int part = tid / BN;
    const float s = __ldg(stat_shift + n0 + col);
    float sum = 0.f, sq = 0.f;
    for (int r = part * (BM / 4); r < (part + 1) * (BM / 4); ++r) {
      const float c = Cs[r * LDC + col] - s;
      sum += c;
      sq = fmaf(c, c, sq);
    }
    red_sum[part][col] = sum;
    red_sq[part][col] = sq;
  }
  __syncthreads();
  if (tid < BN) {
    float sum = 0.f, sq = 0.f;
#pragma unroll
    for (int p = 0; p < THREADS / BN; ++p) {
      sum += red_sum[p][tid];
      sq += red_sq[p][tid];
    }
    csum[(long long)mb * n + n0 + tid] = sum;
    csq[(long long)mb * n + n0 + tid] = sq;
  }
}

}  // namespace

// Shapes: M % 128 == 0, K % 32 == 0, N % 64 == 0 (the wrapper's gate asks
// K % 64, as the JAX gate does); z 16-byte aligned; vec_x = 1 (vec_w = 1)
// promises a 16-byte-aligned x (w), read in 16-byte vectors. Returns
// cudaGetLastError() of the launch, or -1 for a shape the kernel does not
// take. Launches on `stream`; allocates nothing.
extern "C" int dl4j_bn_matmul_stats(const void* x, const float* scale,
                                    const float* shift, const void* w,
                                    const float* stat_shift, void* z,
                                    float* csum, float* csq, long long m,
                                    int k, int n, int prologue, int relu,
                                    int vec_x, int vec_w, void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || m % BM || k % BK || n % BN) return -1;
  const long long grid_m = m / BM;
  const int grid_n = n / BN;
  if (grid_m * grid_n > 0x7fffffffLL) return -1;
  bn_matmul_stats_kernel<<<(unsigned)(grid_m * grid_n), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), scale, shift,
      static_cast<const __nv_bfloat16*>(w), stat_shift,
      static_cast<__nv_bfloat16*>(z), csum, csq, k, n, grid_n, prologue, relu,
      vec_x, vec_w);
  return static_cast<int>(cudaGetLastError());
}
