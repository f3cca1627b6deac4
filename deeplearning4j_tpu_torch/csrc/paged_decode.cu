// paged_decode.cu — decode-step attention over a block-paged KV cache for
// Hopper (sm_90a), float32, bfloat16 and float16 caches, float32 scores,
// any head dim D with D % 8 == 0 up to 256, any page size.
//
// Replaces: deeplearning4j_tpu/ops/pallas_attention.py
// `_paged_decode_kernel`, reached through `_paged_decode_call`. Same
// contract as `paged_decode_attention_xla`: one query per slot,
// q (S, H, D), attends over k/v_pages (P+1, page, H, D) through
// page_table (S, max_pages) int32; positions >= seq_lens[s] are masked.
// Output (S, H, D) in the input type.
//
// What bounds it on the H100: memory. Each (slot, head) reads its
// seq_len keys and values once and does 4*D flops per key, at most one flop
// per byte — far below the card's ~20 flops/byte (float32) balance point.
// The least time is the cache bytes the live sequences own over 3.35 TB/s.
//
// Design, and what it does about the TPU original:
//  * Pallas walks ALL max_pages pages of every slot in order (grid
//    (S, max_pages), the running max, sum and accumulator in scratch
//    memory from one grid step to the next). Blocks on the card run in
//    parallel and in no order, and a decode batch mixes a 1-token slot
//    with a 1024-token one, so one block a slot would leave most SMs idle
//    while the long slot's block walks its pages. Here the sequence is
//    split (split-KV): a block owns one (split, slot, head group), a split
//    being `pps` consecutive pages. `pps` comes from the batch's capacity
//    (slots × max_pages against 2 × the SMs, ops/cuda_attention.py
//    `paged_plan`); the splits a slot has follow its own seq_len on the
//    device — a 1024-token slot gets many, a 1-token slot one — and the
//    blocks past a slot's last split exit at once. The host never reads
//    seq_lens, so a call never synchronises and stays capturable in a
//    CUDA graph.
//  * In the cache layout (P+1, page, H, D) the positions of a page, with
//    all their heads, are one contiguous run. A tile (`tp` positions of a
//    page, all the block's heads: the whole page where the stage holds it)
//    lands in shared memory by one bulk asynchronous copy for K and one for
//    V (`cp.async.bulk`, no tensor map), completed on an mbarrier, into a
//    ring of `nst` stages, so the next tiles land while this one is read.
//    Where the block owns fewer heads than the cache has, a tile is one
//    copy per position.
//  * Warps own heads, a lane D/32 of the head dim (rounded up to 1, 2, 4
//    or 8 elements). Scores are float32 dot products, 8 positions at a
//    time, reduced across the warp by a reduce-scatter of shuffles that
//    leaves each lane one position's score (9 shuffles for 8 positions,
//    one exp2 a lane); the online softmax (running max m, sum l,
//    accumulator acc, in base 2) is kept in registers, so no score goes
//    through shared memory. On the H100 this per-position work, not the
//    copies, sets the time of a long split (PERF.md §6, row 2): a
//    butterfly per position, every lane computing every exponential, was
//    several times slower.
//  * Each split of a slot with more than one writes its (m, l, acc) per
//    head to a workspace; the last block of the slot to finish (a ticket
//    from atomicAdd on a per-(slot, head group) counter, after a
//    __threadfence) combines them with the log-sum-exp rescale and resets
//    the counter for the next call. One launch a call. A slot with one
//    split writes its output directly.
//  * A slot with seq_len 0 (an inactive slot of the engine) writes zeros:
//    finite, never NaN.
//  * Page ids are clamped into [0, num_pages), as a JAX gather clamps;
//    CUDA indexing would otherwise read out of bounds.
//  * The wrapper allocates the workspace (caching allocator) and keeps
//    the counters; nothing is allocated here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "sm90.cuh"

namespace {

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

constexpr int kMaxHeadDim = 256;
constexpr int kMaxWarps = 16;            // heads a block owns, at most
constexpr int kSub = 8;  // positions scored together (reduce_scatter8)
constexpr int kMaxSmem = 200 * 1024;     // the ring, at most
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* kp;
  const void* vp;
  const int* pt;
  const int* sl;
  void* out;
  float* ws;       // acc (S, n_split, H, D), then (m, l) (S, n_split, H, 2)
  int* counters;   // (S, head groups), zero between calls
  int heads, d, page, max_pages, num_pages;
  int tp;          // positions a tile (divides page)
  int hb;          // heads a block (one warp each)
  int nst;         // stages of the ring
  int pps;         // pages a split
  int n_split;     // splits of a full slot: ceil(max_pages / pps)
  float scale;
};

// DPL consecutive elements of T (a lane's share of a head row) as floats,
// one load of DPL * sizeof(T) bytes (the row and the lane's offset are
// aligned to it).
template <typename T, int DPL>
__device__ __forceinline__ void load_lane(const T* p, float (&out)[DPL]) {
  constexpr int B = DPL * static_cast<int>(sizeof(T));
  if constexpr (B >= 16) {
#pragma unroll
    for (int i = 0; i < B / 16; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < 16 / static_cast<int>(sizeof(T)); ++k)
        out[i * (16 / sizeof(T)) + k] = to_f32(e[k]);
    }
  } else {
    using W = std::conditional_t<
        B == 8, uint2, std::conditional_t<B == 4, uint32_t, uint16_t>>;
    const W u = *reinterpret_cast<const W*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[k] = to_f32(e[k]);
  }
}

// DPL floats of a split's accumulator (written by another block: read at
// L2), one load of 4, 8 or 16 bytes per 4 floats.
template <int DPL>
__device__ __forceinline__ void ldcg_lane(const float* p, float (&out)[DPL]) {
  if constexpr (DPL == 1) {
    out[0] = __ldcg(p);
  } else if constexpr (DPL == 2) {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < DPL / 4; ++i) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(p) + i);
      out[4 * i] = v.x;
      out[4 * i + 1] = v.y;
      out[4 * i + 2] = v.z;
      out[4 * i + 3] = v.w;
    }
  }
}

// The 8 positions' dot products, summed over the warp and scattered: lane
// l returns position l / 4's sum (each held by 4 lanes). 9 shuffles where a
// butterfly over each position would take 40.
__device__ __forceinline__ float reduce_scatter8(const float (&part)[8],
                                                 int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float r4[4];  // positions 4 * b4 + k
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r4[k] = (b4 ? part[k + 4] : part[k]) +
            __shfl_xor_sync(kFull, b4 ? part[k] : part[k + 4], 16);
  float r2[2];  // positions 4 * b4 + 2 * b3 + k
#pragma unroll
  for (int k = 0; k < 2; ++k)
    r2[k] = (b3 ? r4[k + 2] : r4[k]) +
            __shfl_xor_sync(kFull, b3 ? r4[k] : r4[k + 2], 8);
  float r = (b2 ? r2[1] : r2[0]) +
            __shfl_xor_sync(kFull, b2 ? r2[0] : r2[1], 4);
  r += __shfl_xor_sync(kFull, r, 2);
  return r + __shfl_xor_sync(kFull, r, 1);
}

// max and sum over the 8 positions (lanes 4 apart hold different ones)
__device__ __forceinline__ float max8(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 16));
}
__device__ __forceinline__ float sum8(float v) {
  v += __shfl_xor_sync(kFull, v, 4);
  v += __shfl_xor_sync(kFull, v, 8);
  return v + __shfl_xor_sync(kFull, v, 16);
}

template <typename T, int DPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_decode_kernel(const __grid_constant__ Params a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int j = blockIdx.x;
  const int s = blockIdx.y;
  const int hg = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h0 = hg * a.hb;
  const int hb = min(a.hb, a.heads - h0);  // heads of this block
  const int h = h0 + warp;
  const bool head = warp < hb;
  const bool lane_on = lane * DPL < a.d;
  const int split_len = a.pps * a.page;
  const int n = max(0, min(a.sl[s], a.max_pages * a.page));
  const int n_splits = max(1, (n + split_len - 1) / split_len);
  if (j >= n_splits) return;
  T* out = static_cast<T*>(a.out) + ((size_t)s * a.heads + h) * a.d +
           lane * DPL;
  if (n == 0) {  // inactive slot
    if (head && lane_on) {
#pragma unroll
      for (int k = 0; k < DPL; ++k) out[k] = from_f32<T>(0.f);
    }
    return;
  }

  const int p0 = j * split_len;
  const int p1 = min(p0 + split_len, n);
  const int n_tiles = (p1 - p0 + a.tp - 1) / a.tp;
  const int row = hb * a.d;  // elements of one position's heads in a tile
  const uint32_t row_bytes = row * sizeof(T);
  const uint32_t tile_bytes = a.tp * row_bytes;
  const uint32_t stage_bytes = 2 * tile_bytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + a.nst * stage_bytes);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
  const int* pt = a.pt + (size_t)s * a.max_pages;

  // tile t of the split into stage t % nst (thread 0 only)
  auto issue = [&](int t) {
    const int st = t % a.nst;
    const int pos = p0 + t * a.tp;
    const int pg = min(max(pt[pos / a.page], 0), a.num_pages - 1);
    const size_t src =
        (((size_t)pg * a.page + pos % a.page) * a.heads + h0) * a.d;
    const uint32_t dk = sm90::smem_u32(smem + st * stage_bytes);
    const uint32_t dv = dk + tile_bytes;
    const uint32_t bar = sm90::smem_u32(&bars[st]);
    sm90::mbar_arrive_expect_tx(bar, stage_bytes);
    if (hb == a.heads) {  // the tile is one contiguous run
      sm90::bulk_load(dk, kp + src, tile_bytes, bar);
      sm90::bulk_load(dv, vp + src, tile_bytes, bar);
    } else {
      const size_t stride = (size_t)a.heads * a.d;
      for (int r = 0; r < a.tp; ++r) {
        sm90::bulk_load(dk + r * row_bytes, kp + src + r * stride, row_bytes,
                        bar);
        sm90::bulk_load(dv + r * row_bytes, vp + src + r * stride, row_bytes,
                        bar);
      }
    }
  };

  if (tid == 0) {
    for (int i = 0; i < a.nst; ++i)
      sm90::mbar_init(sm90::smem_u32(&bars[i]), 1);
    sm90::mbar_fence_init();
    for (int t = 0; t < min(a.nst, n_tiles); ++t) issue(t);
  }
  __syncthreads();

  float q[DPL];
  float acc[DPL];
  const T* qrow =
      static_cast<const T*>(a.q) + ((size_t)s * a.heads + h) * a.d;
#pragma unroll
  for (int k = 0; k < DPL; ++k) {
    q[k] = head && lane_on ? to_f32(qrow[lane * DPL + k]) : 0.f;
    acc[k] = 0.f;
  }
  const float scale2 = a.scale * kLog2e;  // scores in base 2
  float m = -CUDART_INF_F;
  float l = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % a.nst;
    sm90::mbar_wait(sm90::smem_u32(&bars[st]), (t / a.nst) & 1);
    if (head) {
      const T* kt = reinterpret_cast<const T*>(smem + st * stage_bytes) +
                    warp * a.d + lane * DPL;
      const T* vt = kt + tile_bytes / sizeof(T);
      const int np = min(a.tp, p1 - (p0 + t * a.tp));
      for (int i0 = 0; i0 < np; i0 += kSub) {
        float part[kSub];  // this lane's share of the 8 dot products
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          part[i] = 0.f;
          if (i0 + i < np && lane_on) {
            float kf[DPL];
            load_lane<T, DPL>(kt + (size_t)(i0 + i) * row, kf);
#pragma unroll
            for (int k = 0; k < DPL; ++k)
              part[i] = fmaf(q[k], kf[k], part[i]);
          }
        }
        // lane owns position i0 + lane / 4; scores in base 2
        const float sc = reduce_scatter8(part, lane);
        const float s2 = i0 + (lane >> 2) < np ? sc * scale2 : -CUDART_INF_F;
        const float mn = fmaxf(m, max8(s2));
        const float alpha = exp2f(m - mn);  // first: exp2(-inf) = 0
        const float p = exp2f(s2 - mn);     // masked: 0
        l = l * alpha + sum8(p);
#pragma unroll
        for (int k = 0; k < DPL; ++k) acc[k] *= alpha;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float pi = __shfl_sync(kFull, p, 4 * i);
          if (i0 + i < np && lane_on) {
            float vf[DPL];
            load_lane<T, DPL>(vt + (size_t)(i0 + i) * row, vf);
#pragma unroll
            for (int k = 0; k < DPL; ++k) acc[k] = fmaf(pi, vf[k], acc[k]);
          }
        }
        m = mn;
      }
    }
    __syncthreads();  // every warp has read the stage
    if (tid == 0 && t + a.nst < n_tiles) issue(t + a.nst);
  }

  if (n_splits == 1) {
    if (head && lane_on) {
#pragma unroll
      for (int k = 0; k < DPL; ++k) out[k] = from_f32<T>(acc[k] / l);
    }
    return;
  }
  // this split's partial, then a ticket: the slot's last block combines
  const size_t row0 = (size_t)s * a.n_split * a.heads + h;  // split 0
  float* acc_ws = a.ws + row0 * a.d;
  float* ml_ws =
      a.ws + (size_t)gridDim.y * a.n_split * a.heads * a.d + row0 * 2;
  const size_t acc_stride = (size_t)a.heads * a.d;  // a split to the next
  const size_t ml_stride = (size_t)a.heads * 2;
  if (head) {
    if (lane_on) {
#pragma unroll
      for (int k = 0; k < DPL; ++k)
        acc_ws[j * acc_stride + lane * DPL + k] = acc[k];
    }
    if (lane == 0) {
      ml_ws[j * ml_stride] = m;
      ml_ws[j * ml_stride + 1] = l;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* cnt = a.counters + (size_t)s * gridDim.z + hg;
    last = atomicAdd(cnt, 1) == n_splits - 1;
    if (last) *cnt = 0;  // every split has taken its ticket
  }
  __syncthreads();
  if (!last || !head) return;
  __threadfence();
  // the lanes read the splits' (m, l) side by side, then walk the
  // accumulators 32 splits at a time with each split's weight broadcast
  float mx = -CUDART_INF_F;
  for (int i = lane; i < n_splits; i += 32)
    mx = fmaxf(mx, __ldcg(ml_ws + i * ml_stride));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  float lsum = 0.f;
  float o[DPL];
#pragma unroll
  for (int k = 0; k < DPL; ++k) o[k] = 0.f;
  for (int i0 = 0; i0 < n_splits; i0 += 32) {
    const int i = i0 + lane;
    float c = 0.f;
    if (i < n_splits) {
      const float2 ml = __ldcg(reinterpret_cast<const float2*>(
          ml_ws + i * ml_stride));
      c = exp2f(ml.x - mx);
      lsum = fmaf(ml.y, c, lsum);
    }
    const int cnt = min(32, n_splits - i0);
#pragma unroll 8
    for (int r = 0; r < cnt; ++r) {
      const float cr = __shfl_sync(kFull, c, r);
      if (lane_on) {
        float w[DPL];
        ldcg_lane<DPL>(acc_ws + (i0 + r) * acc_stride + lane * DPL, w);
#pragma unroll
        for (int k = 0; k < DPL; ++k) o[k] = fmaf(w[k], cr, o[k]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lsum += __shfl_xor_sync(kFull, lsum, off);
  if (lane_on) {
#pragma unroll
    for (int k = 0; k < DPL; ++k) out[k] = from_f32<T>(o[k] / lsum);
  }
}

template <typename T, int DPL>
int launch(const Params& a, int slots, int groups, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, DPL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t smem =
      (size_t)a.nst * 2 * a.tp * a.hb * a.d * sizeof(T) + 8 * a.nst;
  if (smem > kMaxSmem) return -1;
  const dim3 grid(a.n_split, slots, groups);
  kernel<<<grid, a.hb * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const Params& a, int slots, int groups, cudaStream_t s) {
  if (a.d <= 32) return launch<T, 1>(a, slots, groups, s);
  if (a.d <= 64) return launch<T, 2>(a, slots, groups, s);
  if (a.d <= 128) return launch<T, 4>(a, slots, groups, s);
  return launch<T, 8>(a, slots, groups, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. num_pages counts the
// trash page (the first dimension of k/v_pages). The plan (tp, hb, nst,
// pps; ops/cuda_attention.py `paged_plan`): tiles of tp positions (tp
// divides page), hb heads a block (1..16; the grid's z covers
// ceil(heads / hb) head groups), nst stages, pps pages a split. ws holds
// slots × ceil(max_pages / pps) × heads × (d + 2) floats; counters
// slots × head groups ints, zero (each call leaves them zero). k/v_pages
// 16-byte aligned. Returns cudaGetLastError() of the launch, or -1 for an
// unsupported dtype, head dim (D % 8 != 0 or D > 256) or plan. Launches on
// `stream`; allocates nothing.
extern "C" int dl4j_paged_decode(const void* q, const void* k_pages,
                                 const void* v_pages, const int* page_table,
                                 const int* seq_lens, void* out, float* ws,
                                 int* counters, int slots, int heads, int d,
                                 int page, int max_pages, int num_pages,
                                 float scale, int tp, int hb, int nst,
                                 int pps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots <= 0 || heads <= 0) return 0;
  if (d <= 0 || d % 8 != 0 || d > kMaxHeadDim || page <= 0 ||
      max_pages <= 0 || num_pages <= 0 || tp <= 0 || page % tp != 0 ||
      hb <= 0 || hb > kMaxWarps || hb > heads || nst <= 0 || pps <= 0)
    return -1;
  const Params a = {q,  k_pages, v_pages, page_table, seq_lens, out, ws,
                    counters, heads, d, page, max_pages, num_pages, tp, hb,
                    nst, pps, (max_pages + pps - 1) / pps, scale};
  const int groups = (heads + hb - 1) / hb;
  if (dtype == 0) return dispatch_d<float>(a, slots, groups, s);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a, slots, groups, s);
  if (dtype == 2) return dispatch_d<__half>(a, slots, groups, s);
  return -1;
}
