// fused_updater.cu — one optimizer step for a whole group of parameter
// leaves in one launch, for Hopper (sm_90a): any of the 11 updater kinds of
// nn/updater.py, leaves in float32, bfloat16 or float16, math in float32.
//
// Replaces: deeplearning4j_tpu/ops/pallas_updater.py `_kernel`, reached
// through `fused_updater_helper`. Same contract as the `fused_updater_step`
// op, leaf by leaf: new_param = param - update, plus the new state buffers;
// param, grad and each state buffer are read once, the new param and state
// written once.
//
// What bounds it on the H100: memory. Every kind does a handful of flops per
// element on 4 to 8 bytes moved per buffer, far below the card's balance
// point; the least time is (param, grad, state read + param, state written)
// over 3.35 TB/s, summed over the group's leaves.
//
// Design, and what it does about the TPU original:
//  * Pallas pads each leaf to (rows, 128) lane tiles and runs one kernel per
//    leaf. A training step has 161 (ResNet-50) to 206 (BERT-base) leaves,
//    most of them small, so one launch per leaf leaves the card idle
//    between launches and never fills it inside the small ones. Here one
//    launch updates a group of leaves that share the kind, the
//    hyperparameters, the scheduled lr and step, and the dtype (PyTorch's
//    `_fused_sgd_` / `_fused_adam_` are built the same way).
//  * The group travels as the kernel's parameter struct, by value
//    (`__grid_constant__`, up to 32 764 bytes since CUDA 12.1): per leaf
//    its pointers, element count and 16-byte vector count, and the prefix
//    sum of the leaves' chunk counts. No table is copied to the device, so
//    the launch needs no H2D copy and stays capturable in a CUDA graph.
//    A group larger than one table (256 leaves) is split by the wrapper
//    over several launches. A per-leaf call ships the same table: on the
//    H100 a 16-leaf table timed the same (PERF.md §6, row 5).
//  * One block per chunk of a leaf (256 threads × 4 vectors × 16 bytes
//    per buffer); the block finds its (leaf, chunk) by binary search over
//    the prefix sums. Each thread issues its 4 independent 16-byte loads
//    of every buffer before it computes, so enough bytes are in flight per
//    SM for HBM3. Loads and stores carry the streaming hint (`ld.global.cs`
//    / `st.global.cs`): every byte is touched once.
//  * A leaf whose pointers are not all 16-byte aligned takes the scalar
//    path over its whole range, and an aligned leaf's ragged tail (its
//    last n mod 16/sizeof(T) elements) too, inside the same launch.
//  * The kind is a template parameter: no switch, no reference arguments,
//    no stack frame (`ptxas -v`: 0 bytes stack, no spills).
//  * The arithmetic repeats PyTorch's eager plain version operation by
//    operation, each rounded once: written with __fmul_rn/__fadd_rn/
//    __fsub_rn/__fdiv_rn/__fsqrt_rn, which nvcc never contracts into FMAs,
//    so float32 results agree bit for bit with the plain version on the
//    card. Quantities that depend only on lr and step (Adam's alpha, the
//    bias corrections) are computed once on the host by the same torch ops
//    the plain version runs, and passed by value (`coef`).
//  * Nadam divides by its bias corrections; torch's CUDA division by a host
//    scalar multiplies by the float32 reciprocal, so the kernel does too
//    (the reciprocal comes in `coef`).
//  * Out of place: the wrapper allocates the outputs; nothing is allocated
//    here.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;  // 16-byte vectors per buffer per thread in flight
constexpr int kChunkBytes = kThreads * kIlp * 16;  // per buffer, per block

struct Coef {
  float c[8];
};

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

// The kinds, in nn/updater.py UPDATERS order; state buffers s[0..NS) in
// sorted-key order. Each mirrors that class's `apply` (c = its
// `coefficients`) and returns the update; s is updated in place (a local
// array, registers once inlined).
template <int KIND>
struct Kind;

template <>
struct Kind<0> {  // Sgd: u = lr*g                                c = (lr)
  static constexpr int NS = 0;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float*) {
    return __fmul_rn(k.c[0], g);
  }
};
template <>
struct Kind<1> {  // NoOp: u = g
  static constexpr int NS = 0;
  __device__ __forceinline__ static float step(const Coef&, float g,
                                               float*) {
    return g;
  }
};
template <>
struct Kind<2> {  // Frozen: u = 0
  static constexpr int NS = 0;
  __device__ __forceinline__ static float step(const Coef&, float,
                                               float*) {
    return 0.f;
  }
};
template <>
struct Kind<3> {  // Nesterovs, s = (v)                    c = (mu, lr, 1+mu)
  static constexpr int NS = 1;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float vp = __fmul_rn(k.c[0], s[0]);
    const float v = __fsub_rn(vp, __fmul_rn(k.c[1], g));
    s[0] = v;
    return __fsub_rn(vp, __fmul_rn(k.c[2], v));
  }
};
template <>
struct Kind<4> {  // AdaGrad, s = (h)                            c = (lr, eps)
  static constexpr int NS = 1;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float h = __fadd_rn(s[0], __fmul_rn(g, g));
    s[0] = h;
    return __fdiv_rn(__fmul_rn(k.c[0], g), __fadd_rn(__fsqrt_rn(h), k.c[1]));
  }
};
template <>
struct Kind<5> {  // RmsProp, s = (g2)                  c = (d, 1-d, lr, eps)
  static constexpr int NS = 1;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float g2 = __fadd_rn(__fmul_rn(k.c[0], s[0]),
                               __fmul_rn(__fmul_rn(k.c[1], g), g));
    s[0] = g2;
    return __fdiv_rn(__fmul_rn(g, k.c[2]), __fsqrt_rn(__fadd_rn(g2, k.c[3])));
  }
};
template <>
struct Kind<6> {  // AdaDelta, s = (msdx, msg)          c = (rho, 1-rho, eps)
  static constexpr int NS = 2;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float msg = __fadd_rn(__fmul_rn(k.c[0], s[1]),
                                __fmul_rn(__fmul_rn(k.c[1], g), g));
    const float dx = __fmul_rn(__fdiv_rn(__fsqrt_rn(__fadd_rn(s[0], k.c[2])),
                                         __fsqrt_rn(__fadd_rn(msg, k.c[2]))),
                               g);
    s[0] = __fadd_rn(__fmul_rn(k.c[0], s[0]),
                     __fmul_rn(__fmul_rn(k.c[1], dx), dx));
    s[1] = msg;
    return dx;
  }
};
// Adam and AmsGrad, s = (m, v[, vhat])
//                                  c = (b1, 1-b1, b2, 1-b2, alpha, eps)
template <bool AMS>
struct AdamStep {
  static constexpr int NS = AMS ? 3 : 2;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float m = __fadd_rn(__fmul_rn(k.c[0], s[0]), __fmul_rn(k.c[1], g));
    const float v = __fadd_rn(__fmul_rn(k.c[2], s[1]),
                              __fmul_rn(__fmul_rn(k.c[3], g), g));
    float den = v;
    if constexpr (AMS) {
      den = fmaxf(s[2], v);
      s[2] = den;
    }
    s[0] = m;
    s[1] = v;
    return __fdiv_rn(__fmul_rn(k.c[4], m), __fadd_rn(__fsqrt_rn(den), k.c[5]));
  }
};
template <>
struct Kind<7> : AdamStep<false> {};
template <>
struct Kind<8> {  // AdaMax, s = (m, u)
                  //               c = (b1, 1-b1, b2, lr/(1-b1^t), eps)
  static constexpr int NS = 2;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float m = __fadd_rn(__fmul_rn(k.c[0], s[0]), __fmul_rn(k.c[1], g));
    const float u = fmaxf(__fmul_rn(k.c[2], s[1]), fabsf(g));
    s[0] = m;
    s[1] = u;
    return __fdiv_rn(__fmul_rn(k.c[3], m), __fadd_rn(u, k.c[4]));
  }
};
template <>
struct Kind<9> {  // Nadam, s = (m, v)
  // c = (b1, 1-b1, b2, 1-b2, lr, 1/(1-b1^t), 1/(1-b2^t), eps)
  static constexpr int NS = 2;
  __device__ __forceinline__ static float step(const Coef& k, float g,
                                               float* s) {
    const float m = __fadd_rn(__fmul_rn(k.c[0], s[0]), __fmul_rn(k.c[1], g));
    const float v = __fadd_rn(__fmul_rn(k.c[2], s[1]),
                              __fmul_rn(__fmul_rn(k.c[3], g), g));
    const float m_hat = __fmul_rn(m, k.c[5]);
    const float v_hat = __fmul_rn(v, k.c[6]);
    const float inner = __fadd_rn(__fmul_rn(k.c[0], m_hat),
                                  __fmul_rn(__fmul_rn(k.c[1], g), k.c[5]));
    s[0] = m;
    s[1] = v;
    return __fdiv_rn(__fmul_rn(k.c[4], inner),
                     __fadd_rn(__fsqrt_rn(v_hat), k.c[7]));
  }
};
template <>
struct Kind<10> : AdamStep<true> {};

// One leaf of a launch: src = (param, grad, state...), dst = (new param,
// new state...), n elements, n_vec 16-byte vectors on the vector path (0
// when a pointer is not 16-byte aligned: the whole leaf is scalar).
template <int NS>
struct Leaf {
  const void* src[2 + NS];
  void* dst[1 + NS];
  long long n;
  long long n_vec;
};

// The launch's table, passed by value. chunk_start[i] is the first block
// of leaf i (an exclusive prefix sum of the chunk counts); block b updates
// chunk b - chunk_start[i] of the last leaf i with chunk_start[i] <= b.
constexpr int kCap = 256;  // leaves a launch

template <int NS>
struct Table {
  Leaf<NS> leaf[kCap];
  int chunk_start[kCap];
  int n_leaves;
  Coef k;
};

static_assert(sizeof(Table<3>) <= 32764,
              "the largest table must fit the kernel parameter space");

template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& u, float (&out)[N]) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

template <typename T, int N>
__device__ __forceinline__ uint4 pack(const float (&in)[N]) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f32<T>(in[i]);
  return u;
}

template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
fused_updater_kernel(const __grid_constant__ Table<Kind<KIND>::NS> tab) {
  using K = Kind<KIND>;
  constexpr int NS = K::NS;
  constexpr int NB = 2 + NS;                   // buffers read
  constexpr int VEC = 16 / sizeof(T);          // elements per vector
  constexpr long long CHUNK = kChunkBytes / sizeof(T);  // elements a block
  const int b = blockIdx.x;
  const int tid = threadIdx.x;

  int lo = 0, hi = tab.n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.chunk_start[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Leaf<NS>& L = tab.leaf[lo];
  const long long n = L.n;
  const long long n_vec = L.n_vec;
  const long long e0 = (long long)(b - tab.chunk_start[lo]) * CHUNK;

  // vector body: vectors v0 + [0, v_count), v_count =
  // min(kThreads * kIlp, n_vec - v0); thread t's i-th is v0 + i*kThreads + t
  const long long v0 = e0 / VEC;
  const int v_count = (int)max(0LL, min((long long)kThreads * kIlp,
                                        n_vec - v0));
  if (v_count > 0) {
    uint4 raw[NB][kIlp];
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const int v = i * kThreads + tid;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        raw[j][i] = v < v_count
                        ? __ldcs(static_cast<const uint4*>(L.src[j]) + v0 + v)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kIlp; ++i) {
      const int v = i * kThreads + tid;
      if (v < v_count) {
        float pf[VEC], gf[VEC], sf[NS > 0 ? NS : 1][VEC];
        unpack<T>(raw[0][i], pf);
        unpack<T>(raw[1][i], gf);
#pragma unroll
        for (int j = 0; j < NS; ++j) unpack<T>(raw[2 + j][i], sf[j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          float s[NS > 0 ? NS : 1];
#pragma unroll
          for (int j = 0; j < NS; ++j) s[j] = sf[j][e];
          pf[e] = __fsub_rn(pf[e], K::step(tab.k, gf[e], s));
#pragma unroll
          for (int j = 0; j < NS; ++j) sf[j][e] = s[j];
        }
        __stcs(static_cast<uint4*>(L.dst[0]) + v0 + v, pack<T>(pf));
#pragma unroll
        for (int j = 0; j < NS; ++j)
          __stcs(static_cast<uint4*>(L.dst[1 + j]) + v0 + v,
                 pack<T>(sf[j]));
      }
    }
  }
  // scalar path: the chunk's elements past the vectors (the ragged tail,
  // or the whole chunk of an unaligned leaf)
  const long long s_first = max(e0, n_vec * VEC);
  const int s_count = (int)max(0LL, min(e0 + CHUNK, n) - s_first);
#pragma unroll 1
  for (int i = tid; i < s_count; i += kThreads) {
    const long long e = s_first + i;
    float s[NS > 0 ? NS : 1];
#pragma unroll
    for (int j = 0; j < NS; ++j)
      s[j] = to_f32(static_cast<const T*>(L.src[2 + j])[e]);
    const float g = to_f32(static_cast<const T*>(L.src[1])[e]);
    const float p = to_f32(static_cast<const T*>(L.src[0])[e]);
    const float u = K::step(tab.k, g, s);
    static_cast<T*>(L.dst[0])[e] = from_f32<T>(__fsub_rn(p, u));
#pragma unroll
    for (int j = 0; j < NS; ++j)
      static_cast<T*>(L.dst[1 + j])[e] = from_f32<T>(s[j]);
  }
}

// rows: n_leaves rows of 11 int64 (p, g, s0, s1, s2, op, o0, o1, o2, n,
// n_vec); starts: the n_leaves chunk starts, then the total chunk count.
template <typename T, int KIND>
int launch(const long long* rows, const int* starts, int n_leaves,
           const Coef& k, cudaStream_t stream) {
  constexpr int NS = Kind<KIND>::NS;
  Table<NS> tab;
  for (int i = 0; i < n_leaves; ++i) {
    const long long* r = rows + 11 * i;
    tab.leaf[i].src[0] = reinterpret_cast<const void*>(r[0]);
    tab.leaf[i].src[1] = reinterpret_cast<const void*>(r[1]);
    tab.leaf[i].dst[0] = reinterpret_cast<void*>(r[5]);
    for (int j = 0; j < NS; ++j) {
      tab.leaf[i].src[2 + j] = reinterpret_cast<const void*>(r[2 + j]);
      tab.leaf[i].dst[1 + j] = reinterpret_cast<void*>(r[6 + j]);
    }
    tab.leaf[i].n = r[9];
    tab.leaf[i].n_vec = r[10];
    tab.chunk_start[i] = starts[i];
  }
  tab.n_leaves = n_leaves;
  tab.k = k;
  const int blocks = starts[n_leaves];
  if (blocks <= 0) return 0;
  fused_updater_kernel<T, KIND><<<blocks, kThreads, 0, stream>>>(tab);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_kind(int kind, const long long* rows, const int* starts, int n_leaves,
            const Coef& k, cudaStream_t s) {
  switch (kind) {
    case 0: return launch<T, 0>(rows, starts, n_leaves, k, s);
    case 1: return launch<T, 1>(rows, starts, n_leaves, k, s);
    case 2: return launch<T, 2>(rows, starts, n_leaves, k, s);
    case 3: return launch<T, 3>(rows, starts, n_leaves, k, s);
    case 4: return launch<T, 4>(rows, starts, n_leaves, k, s);
    case 5: return launch<T, 5>(rows, starts, n_leaves, k, s);
    case 6: return launch<T, 6>(rows, starts, n_leaves, k, s);
    case 7: return launch<T, 7>(rows, starts, n_leaves, k, s);
    case 8: return launch<T, 8>(rows, starts, n_leaves, k, s);
    case 9: return launch<T, 9>(rows, starts, n_leaves, k, s);
    case 10: return launch<T, 10>(rows, starts, n_leaves, k, s);
  }
  return -1;
}

}  // namespace

// One launch over n_leaves (1..256) leaves of one dtype (0 = float32,
// 1 = bfloat16, 2 = float16) and one kind (index into nn/updater.py
// UPDATERS, 0..10); rows and starts as `launch` reads them; c0..c7 the
// kind's coefficients. Returns cudaGetLastError() of the launch, or -1 for
// an unsupported dtype, kind or leaf count. Launches on `stream`;
// allocates nothing.
extern "C" int dl4j_fused_updater_multi(const long long* rows,
                                        const int* starts, int n_leaves,
                                        int kind, int dtype, float c0,
                                        float c1, float c2, float c3,
                                        float c4, float c5, float c6,
                                        float c7, void* stream) {
  if (kind < 0 || kind > 10 || n_leaves < 1 || n_leaves > kCap)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Coef k = {{c0, c1, c2, c3, c4, c5, c6, c7}};
  if (dtype == 0) return by_kind<float>(kind, rows, starts, n_leaves, k, st);
  if (dtype == 1)
    return by_kind<__nv_bfloat16>(kind, rows, starts, n_leaves, k, st);
  if (dtype == 2) return by_kind<__half>(kind, rows, starts, n_leaves, k, st);
  return -1;
}
