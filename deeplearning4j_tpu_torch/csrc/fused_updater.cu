// fused_updater.cu — one optimizer step for one parameter leaf, for Hopper
// (sm_90a): any of the 11 updater kinds of nn/updater.py, leaves in
// float32, bfloat16 or float16, math in float32.
//
// Replaces: deeplearning4j_tpu/ops/pallas_updater.py `_kernel`, reached
// through `fused_updater_helper`. Same contract as the `fused_updater_step`
// op: new_param = param - update, plus the new state buffers; param, grad
// and each state buffer are read once, the new param and state written once.
//
// What bounds it on the H100: memory. Every kind does a handful of flops per
// element on 4 to 8 bytes moved per buffer, far below the card's balance
// point; the least time is (param, grad, state read + param, state written)
// over 3.35 TB/s.
//
// Design, and what it does about the TPU original:
//  * Pallas pads the leaf to (rows, 128) lane tiles and traces the kind's
//    `Updater.apply` into the kernel body, so each kind is its own kernel.
//    Here one kernel per element type switches on the kind at run time
//    (uniform across the grid, so the branch costs nothing) — three
//    instantiations instead of 33, to keep the build short.
//  * One thread per 16 bytes of each buffer (4 float32 or 8 16-bit
//    elements), grid-stride, when every pointer is 16-byte aligned; the
//    ragged tail (and unaligned leaves) take one element per thread. No
//    padding, no slicing.
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
constexpr int kMaxBlocks = 4096;

struct Coef {
  float c[8];
};

template <typename T>
struct Args {
  const T* p;
  const T* g;
  const T* s[3];
  T* op;
  T* os[3];
  int nstate;
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

// The kinds, in nn/updater.py UPDATERS order; state buffers in sorted-key
// order. Each case mirrors that class's `apply` (c = its `coefficients`).
__device__ __forceinline__ float update_one(int kind, const Coef& k, float g,
                                            float& s0, float& s1, float& s2) {
  switch (kind) {
    case 0:  // Sgd: u = lr*g                                   c = (lr)
      return __fmul_rn(k.c[0], g);
    case 1:  // NoOp: u = g
      return g;
    case 2:  // Frozen: u = 0
      return 0.f;
    case 3: {  // Nesterovs, s0 = v                     c = (mu, lr, 1+mu)
      const float vp = __fmul_rn(k.c[0], s0);
      const float v = __fsub_rn(vp, __fmul_rn(k.c[1], g));
      s0 = v;
      return __fsub_rn(vp, __fmul_rn(k.c[2], v));
    }
    case 4: {  // AdaGrad, s0 = h                              c = (lr, eps)
      const float h = __fadd_rn(s0, __fmul_rn(g, g));
      s0 = h;
      return __fdiv_rn(__fmul_rn(k.c[0], g), __fadd_rn(__fsqrt_rn(h), k.c[1]));
    }
    case 5: {  // RmsProp, s0 = g2                    c = (d, 1-d, lr, eps)
      const float g2 = __fadd_rn(__fmul_rn(k.c[0], s0),
                                 __fmul_rn(__fmul_rn(k.c[1], g), g));
      s0 = g2;
      return __fdiv_rn(__fmul_rn(g, k.c[2]), __fsqrt_rn(__fadd_rn(g2, k.c[3])));
    }
    case 6: {  // AdaDelta, s0 = msdx, s1 = msg       c = (rho, 1-rho, eps)
      const float msg = __fadd_rn(__fmul_rn(k.c[0], s1),
                                  __fmul_rn(__fmul_rn(k.c[1], g), g));
      const float dx = __fmul_rn(__fdiv_rn(__fsqrt_rn(__fadd_rn(s0, k.c[2])),
                                           __fsqrt_rn(__fadd_rn(msg, k.c[2]))),
                                 g);
      s0 = __fadd_rn(__fmul_rn(k.c[0], s0), __fmul_rn(__fmul_rn(k.c[1], dx), dx));
      s1 = msg;
      return dx;
    }
    case 7:     // Adam, s0 = m, s1 = v
    case 10: {  // AmsGrad, s0 = m, s1 = v, s2 = vhat
                //                  c = (b1, 1-b1, b2, 1-b2, alpha, eps)
      const float m = __fadd_rn(__fmul_rn(k.c[0], s0), __fmul_rn(k.c[1], g));
      const float v = __fadd_rn(__fmul_rn(k.c[2], s1),
                                __fmul_rn(__fmul_rn(k.c[3], g), g));
      float den = v;
      if (kind == 10) {
        den = fmaxf(s2, v);
        s2 = den;
      }
      s0 = m;
      s1 = v;
      return __fdiv_rn(__fmul_rn(k.c[4], m), __fadd_rn(__fsqrt_rn(den), k.c[5]));
    }
    case 8: {  // AdaMax, s0 = m, s1 = u
               //                  c = (b1, 1-b1, b2, lr/(1-b1^t), eps)
      const float m = __fadd_rn(__fmul_rn(k.c[0], s0), __fmul_rn(k.c[1], g));
      const float u = fmaxf(__fmul_rn(k.c[2], s1), fabsf(g));
      s0 = m;
      s1 = u;
      return __fdiv_rn(__fmul_rn(k.c[3], m), __fadd_rn(u, k.c[4]));
    }
    case 9: {  // Nadam, s0 = m, s1 = v
               // c = (b1, 1-b1, b2, 1-b2, lr, 1/(1-b1^t), 1/(1-b2^t), eps)
      const float m = __fadd_rn(__fmul_rn(k.c[0], s0), __fmul_rn(k.c[1], g));
      const float v = __fadd_rn(__fmul_rn(k.c[2], s1),
                                __fmul_rn(__fmul_rn(k.c[3], g), g));
      const float m_hat = __fmul_rn(m, k.c[5]);
      const float v_hat = __fmul_rn(v, k.c[6]);
      const float inner = __fadd_rn(__fmul_rn(k.c[0], m_hat),
                                    __fmul_rn(__fmul_rn(k.c[1], g), k.c[5]));
      s0 = m;
      s1 = v;
      return __fdiv_rn(__fmul_rn(k.c[4], inner),
                       __fadd_rn(__fsqrt_rn(v_hat), k.c[7]));
    }
  }
  return 0.f;
}

// 16 bytes of T (one vector load) widened to float, and back
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) out[i] = to_f32(e[i]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* in) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) e[i] = from_f32<T>(in[i]);
  return u;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_updater_kernel(Args<T> a, long long n_vec, long long n, int kind,
                     Coef k) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int ns = a.nstate;
  for (long long i = tid; i < n_vec; i += stride) {
    const long long e = i * VEC;
    float pf[VEC], gf[VEC], sf[3][VEC];
    unpack<T>(*reinterpret_cast<const uint4*>(a.p + e), pf);
    unpack<T>(*reinterpret_cast<const uint4*>(a.g + e), gf);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (j < ns) {
        unpack<T>(*reinterpret_cast<const uint4*>(a.s[j] + e), sf[j]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) sf[j][v] = 0.f;
      }
    }
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const float u = update_one(kind, k, gf[v], sf[0][v], sf[1][v], sf[2][v]);
      pf[v] = __fsub_rn(pf[v], u);
    }
    *reinterpret_cast<uint4*>(a.op + e) = pack<T>(pf);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      if (j < ns) *reinterpret_cast<uint4*>(a.os[j] + e) = pack<T>(sf[j]);
  }
  // ragged tail (everything, when a buffer is not 16-byte aligned)
  for (long long e = n_vec * VEC + tid; e < n; e += stride) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int j = 0; j < ns; ++j) s[j] = to_f32(a.s[j][e]);
    const float u = update_one(kind, k, to_f32(a.g[e]), s[0], s[1], s[2]);
    a.op[e] = from_f32<T>(__fsub_rn(to_f32(a.p[e]), u));
    for (int j = 0; j < ns; ++j) a.os[j][e] = from_f32<T>(s[j]);
  }
}

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
int launch(const void* p, const void* g, const void* const* s, void* op,
           void* const* os, int nstate, long long n, int kind, const Coef& k,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  Args<T> a;
  a.p = static_cast<const T*>(p);
  a.g = static_cast<const T*>(g);
  a.op = static_cast<T*>(op);
  a.nstate = nstate;
  bool aligned = aligned16(p) && aligned16(g) && aligned16(op);
  for (int j = 0; j < 3; ++j) {
    a.s[j] = j < nstate ? static_cast<const T*>(s[j]) : nullptr;
    a.os[j] = j < nstate ? static_cast<T*>(os[j]) : nullptr;
    aligned = aligned && aligned16(a.s[j]) && aligned16(a.os[j]);
  }
  const long long n_vec = aligned ? n / VEC : 0;
  const long long work = n_vec + (n - n_vec * VEC);
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  fused_updater_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      a, n_vec, n, kind, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. kind: index into
// nn/updater.py UPDATERS (0..10); nstate state buffers s0..s2 / o0..o2 in
// sorted-key order (unused ones null); c0..c7 the kind's coefficients.
// Returns cudaGetLastError() of the launch, or -1 for an unsupported dtype,
// kind or state count. Launches on `stream`; allocates nothing.
extern "C" int dl4j_fused_updater(const void* p, const void* g,
                                  const void* s0, const void* s1,
                                  const void* s2, void* op, void* o0, void* o1,
                                  void* o2, long long n, int kind, int nstate,
                                  int dtype, float c0, float c1, float c2,
                                  float c3, float c4, float c5, float c6,
                                  float c7, void* stream) {
  if (kind < 0 || kind > 10 || nstate < 0 || nstate > 3) return -1;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* s[3] = {s0, s1, s2};
  void* os[3] = {o0, o1, o2};
  const Coef k = {{c0, c1, c2, c3, c4, c5, c6, c7}};
  if (dtype == 0) return launch<float>(p, g, s, op, os, nstate, n, kind, k, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(p, g, s, op, os, nstate, n, kind, k, st);
  if (dtype == 2) return launch<__half>(p, g, s, op, os, nstate, n, kind, k, st);
  return -1;
}
