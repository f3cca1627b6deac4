"""The int8 serving matmul on the card: the hand-written CUDA kernels, their
plain versions, the gate and the registry helper.

Counterpart of the Pallas half of ``deeplearning4j_tpu/ops/quantized.py``
— ``matmul_int8_pallas`` (the ``pl.pallas_call`` at ``:175``, kernel body
``_kernel`` ``:122``) with the row quantization XLA runs before it:

* :func:`row_quantize` launches ``dl4j_row_quantize`` of
  ``csrc/matmul_int8.cu``: per-row int8 activations and float32 row scales
  from a (M, K) x, bit for bit ``quantized._row_quantize``. Its launches
  are counted in ``row_quantize.launches``.
* :func:`int8_matmul` launches a GEMM: the int8 dot on s8 tensor cores
  with an int32 accumulator (exact at any K) and the float32 de-scale
  epilogue, bit for bit :func:`int8_matmul_reference`.
  :func:`int8_design` picks the kernel statically: ``"sm90"``
  (``csrc/matmul_int8_sm90.cu``, wgmma fed by TMA through an mbarrier
  ring) where TMA can read q (K % 16, 16-byte aligned), ``"wmma"``
  (``dl4j_matmul_int8``) otherwise. 8-bit wgmma reads its operands
  K-major only, so the sm90 design takes the weight as its (N, K) copy
  (``cuda_matmul.kmajor_weight``, made once a weight). Its launches are
  counted in ``int8_matmul.launches``, the sm90 design's also in
  ``int8_matmul.sm90_launches``.
* :func:`matmul_int8` is the two in a row — the forward of the op's
  ``"cuda"`` helper; :func:`matmul_int8_reference` is its plain version
  (the generic forward, ``_matmul_int8_raw``). :func:`matmul_int8_helper`
  wraps it in the straight-through :class:`quantized.Int8MatmulFn`.

Both kernels are ``torch.library`` operators (``ops/library.py``:
``matmul_int8_row_quantize``, ``matmul_int8``), so an exported program
reaches them. Each wrapper given CPU tensors computes its plain version;
given CUDA tensors it launches or raises — there is no fallback.

:func:`matmul_int8_usable` is the JAX ``_usable`` (``:211``) on CUDA
tensors without its TPU rules: 2-D or 3-D float x, a 2-D int8 (K, N)
weight, a (N,) or (1, N) float scale. The Mosaic tile rule (M % 32,
K % 128, N % 128) is left out because the kernel bound-checks every edge;
the ``pallas_min_m`` crossover is read from the port's own tuning table
(``ops/tuning.py``). What the kernel cannot
take — a float64 x, an empty K, a mismatched scale — the gate refuses.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deeplearning4j_tpu_torch.ops import _build, library, tuning
from deeplearning4j_tpu_torch.ops import quantized as Q
from deeplearning4j_tpu_torch.ops.cuda_attention import _on_cuda, _stream
from deeplearning4j_tpu_torch.ops.cuda_matmul import (
    fullest_tile_n, kmajor_weight, sm_count,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ROW_ARGS = (_P, _P, _P, _LL, _I, _I, _I, _P)
_GEMM_ARGS = (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P)
# q xs wt ws out | m n k dtype bn | stream
_SM90_ARGS = (_P, _P, _P, _P, _P, _LL, _I, _I, _I, _I, _P)
TILE_N = (192, 128)  # the sm90 GEMM's tile widths, preferred first
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check(rc: int, kernel: str, what: str) -> None:
    if rc == -1:
        raise ValueError(f"{kernel}: {what} not taken by the kernel")
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {rc}")


def row_quantize(x):
    """``(xq, xs)`` of a (M, K) x: int8 (M, K) and float32 (M, 1), as
    ``quantized._row_quantize``: the operator
    ``dl4j_tpu_torch::matmul_int8_row_quantize``."""
    return tuple(library.ops().matmul_int8_row_quantize(x))


def _row_quantize_fake(x):
    m, k = x.shape
    return (x.new_empty((m, k), dtype=torch.int8),
            x.new_empty((m, 1), dtype=torch.float32))


def _row_quantize(x):
    """The row kernel's launch: the CUDA implementation of the operator."""
    if x.device.type != "cuda":
        raise ValueError(f"row_quantize: unsupported device {x.device}")
    if x.ndim != 2 or x.shape[1] == 0 or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"row_quantize: x {tuple(x.shape)} {x.dtype} is "
                         f"not a (M, K>0) float32/bfloat16/float16 matrix")
    x = x.contiguous()
    m, k = x.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    xs = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    if m == 0:  # nothing to compute: no launch
        return xq, xs
    vec = int(k % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0
              and xq.data_ptr() % 4 == 0)
    fn = _build.kernel_fn("matmul_int8", "dl4j_row_quantize", _ROW_ARGS)
    rc = fn(x.data_ptr(), xq.data_ptr(), xs.data_ptr(), m, k,
            _DTYPE_CODES[x.dtype], vec, _stream(x))
    _check(rc, "row_quantize", f"({m}, {k})")
    row_quantize.launches += 1
    return xq, xs


row_quantize.launches = 0
library.define("matmul_int8_row_quantize", "(Tensor x) -> (Tensor, Tensor)",
               cuda=_row_quantize, cpu=Q._row_quantize,
               fake=_row_quantize_fake)


def int8_matmul_reference(xq, xs, w_q, w_scale, dtype: torch.dtype):
    """Plain version of the GEMM: the exact integer dot and the float32
    de-scale, cast to ``dtype`` (``quantized._int8_descale``)."""
    return Q._int8_descale(xq, xs, w_q, w_scale, dtype)


def int8_design(xq) -> str:
    """Which GEMM multiplies the contiguous (M, K) int8 ``xq``: ``"sm90"``
    where TMA can read it — K % 16 == 0 (16-byte rows) and a 16-byte
    aligned pointer — ``"wmma"`` otherwise (an odd K, an offset view). The
    weight does not enter: the sm90 design reads its own K-major copy. A
    static choice, not a fallback: either kernel raises when its build or
    launch fails."""
    return ("sm90" if xq.shape[1] % 16 == 0 and xq.data_ptr() % 16 == 0
            else "wmma")


def int8_tile_n(m: int, n: int, sms: int) -> int:
    """The sm90 GEMM's tile width for an (M, N) output on ``sms`` SMs:
    192 or 128, whichever leaves the fuller waves (``fullest_tile_n``)."""
    return fullest_tile_n(m, n, TILE_N, sms)


def int8_matmul(xq, xs, w_q, w_scale, dtype: torch.dtype):
    """The CUDA kernel of :func:`int8_matmul_reference`: xq (M, K) int8,
    xs (M, 1) or (M,) float32, w_q (K, N) int8, w_scale (N,) or (1, N)
    float32 -> (M, N) of ``dtype`` (float32, bfloat16 or float16), by the
    design :func:`int8_design` picks: the operator
    ``dl4j_tpu_torch::matmul_int8``, whose CUDA implementation makes the
    weight's K-major copy (kept on the tensor it was given)."""
    return library.ops().matmul_int8(xq, xs, w_q, w_scale, dtype)


def _int8_matmul_fake(xq, xs, w_q, w_scale, dtype):
    return xq.new_empty((xq.shape[0], w_q.shape[1]), dtype=dtype)


def _int8_matmul(xq, xs, w_q, w_scale, dtype: torch.dtype):
    """The GEMM's launch: the CUDA implementation of the operator."""
    if xq.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {xq.device}")
    if (xq.ndim != 2 or w_q.ndim != 2 or xq.shape[1] != w_q.shape[0]
            or xq.dtype != torch.int8 or w_q.dtype != torch.int8):
        raise ValueError(f"int8_matmul: xq {tuple(xq.shape)} {xq.dtype} and "
                         f"w_q {tuple(w_q.shape)} {w_q.dtype} are not int8 "
                         f"(M, K) and (K, N)")
    m, k = xq.shape
    n = w_q.shape[1]
    if xs.numel() != m or w_scale.numel() != n or dtype not in _DTYPE_CODES:
        raise ValueError(f"int8_matmul: scales {tuple(xs.shape)} and "
                         f"{tuple(w_scale.shape)} for ({m}, {k})x({k}, {n}),"
                         f" out {dtype}")
    xq = xq.contiguous()
    xs = xs.to(torch.float32).reshape(m).contiguous()
    ws = w_scale.to(torch.float32).reshape(n).contiguous()
    if any(t.device != xq.device for t in (xs, w_q, ws)):
        raise ValueError("int8_matmul: inputs on different devices")
    out = torch.empty((m, n), dtype=dtype, device=xq.device)
    if m == 0 or n == 0:  # nothing to compute: no launch
        return out
    design = int8_design(xq)
    if design == "sm90":
        wt = kmajor_weight(w_q)
        bn = int8_tile_n(m, n, sm_count(xq.device.index or 0))
        fn = _build.kernel_fn("matmul_int8_sm90", "dl4j_matmul_int8_sm90",
                              _SM90_ARGS)
        rc = fn(xq.data_ptr(), xs.data_ptr(), wt.data_ptr(), ws.data_ptr(),
                out.data_ptr(), m, n, k, _DTYPE_CODES[dtype], bn, _stream(xq))
    else:
        w_q = w_q.contiguous()
        vec_b = int(n % 16 == 0 and w_q.data_ptr() % 16 == 0)
        fn = _build.kernel_fn("matmul_int8", "dl4j_matmul_int8", _GEMM_ARGS)
        rc = fn(xq.data_ptr(), xs.data_ptr(), w_q.data_ptr(), ws.data_ptr(),
                out.data_ptr(), m, n, k, _DTYPE_CODES[dtype], vec_b,
                _stream(xq))
    kernel = "int8_matmul" + ("_sm90" if design == "sm90" else "")
    if rc == -2:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (or libcuda does not export it)")
    _check(rc, kernel, f"({m}, {k})x({k}, {n})")
    int8_matmul.launches += 1
    int8_matmul.sm90_launches += int(design == "sm90")
    return out


int8_matmul.launches = 0
int8_matmul.sm90_launches = 0
library.define("matmul_int8", "(Tensor xq, Tensor xs, Tensor w_q, "
               "Tensor w_scale, ScalarType dtype) -> Tensor",
               cuda=_int8_matmul, cpu=int8_matmul_reference,
               fake=_int8_matmul_fake)


def matmul_int8_reference(x, w_q, w_scale):
    """Plain version of :func:`matmul_int8`: the generic forward."""
    return Q._matmul_int8_raw(x, w_q, w_scale)


def matmul_int8(x, w_q, w_scale):
    """The kernels of :func:`matmul_int8_reference`: x (M, K) or (B, T, K)
    float32/bfloat16/float16, w_q (K, N) int8, w_scale (N,) or (1, N).
    Not differentiable: the registry reaches it through
    :func:`matmul_int8_helper`."""
    if x.device.type == "cpu":
        return matmul_int8_reference(x, w_q, w_scale)
    if x.ndim not in (2, 3):
        raise ValueError(f"matmul_int8: x {tuple(x.shape)} is not (M, K) or "
                         f"(B, T, K)")
    lead, k = x.shape[:-1], x.shape[-1]
    xq, xs = row_quantize(x.reshape(-1, k))
    y = int8_matmul(xq, xs, w_q, w_scale, x.dtype)
    return y.reshape(lead + (w_q.shape[1],))


def matmul_int8_helper(x, w_q, w_scale):
    """The registered CUDA platform impl: the kernels under the
    straight-through backward."""
    return Q.Int8MatmulFn.apply(x, w_q, w_scale, matmul_int8)


def matmul_int8_usable(x, w_q, w_scale, **kw) -> bool:
    """Gate of the CUDA helper (module docstring)."""
    if not _on_cuda(x, w_q, w_scale):
        return False
    if x.ndim not in (2, 3) or w_q.ndim != 2 or w_q.dtype != torch.int8:
        return False
    if x.dtype not in _DTYPE_CODES:
        return False
    k, n = w_q.shape
    if k == 0 or x.shape[-1] != k or not w_scale.is_floating_point():
        return False
    if tuple(w_scale.shape) not in ((n,), (1, n)):
        return False
    return tuning.crossover("matmul_int8", "pallas_min_m",
                            math.prod(x.shape[:-1]))


# kernel name -> the wrapper holding its launch count
KERNELS = {"matmul_int8": int8_matmul, "row_quantize": row_quantize}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0
    int8_matmul.sm90_launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in KERNELS.items()}


def register_platform_quantized() -> None:
    """Install the kernels as the ``"cuda"`` helper of matmul_int8."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "cuda" not in reg.get("matmul_int8").platform_impls:
        reg.register_platform("matmul_int8", "cuda", matmul_int8_helper,
                              matmul_int8_usable)
