"""act(x @ w + b) in one pass: the plain version, the hand-written CUDA
kernel as a differentiable ``torch.library`` operator, and its gate.

Counterpart of ``deeplearning4j_tpu/ops/pallas_matmul.py`` — the platform
helper of ``fused_matmul_bias_act``, the SameDiff optimizer's matmul + bias
(+ activation) fusion target:

* :func:`fused_matmul_bias_act_reference` is the plain version, with the
  Pallas kernel's semantics (``pallas_matmul.py:42``): the operands
  upcast to float32 and multiplied in float32, the float32 bias added, the
  activation applied in float32, one cast to ``x.dtype``. It is not the
  generic op (``ops/nn_ops.py``), which rounds after the product and again
  after the bias in a low-precision dtype, as the JAX generic does.
* :func:`fused_matmul` launches a kernel replacing ``_kernel``
  (``pallas_matmul.py:42``, via ``fused_matmul_bias_act_pallas``): the
  product accumulated in float32, bias and activation on the accumulator,
  one write. :func:`matmul_design` picks it statically: ``"sm90"``
  (``csrc/fused_matmul_sm90.cu``, wgmma fed by TMA through an mbarrier
  ring) for bfloat16/float16 that TMA can read, ``"wmma"``
  (``csrc/fused_matmul.cu``'s tensor-core kernel) for the other 16-bit
  cases, ``"sm90_f32"`` (``csrc/fused_matmul_f32_sm90.cu``: the same ring,
  every product split into TF32 parts, on the weight's K-major split copy
  :func:`kmajor_weight`) for float32 that TMA can read, ``"simt"`` (the
  CUDA-core SGEMM of ``csrc/fused_matmul.cu``) for the other float32
  cases. Given CPU tensors it computes the plain version; given CUDA
  tensors it launches or raises — there is no fallback. Its launches are
  counted in ``fused_matmul.launches``, the sm90 design's also in
  ``fused_matmul.sm90_launches`` and the sm90_f32 design's in
  ``fused_matmul.sm90_f32_launches``.
* :func:`fused_matmul_usable` is the JAX ``_usable`` (``:192``) on CUDA
  tensors without its Mosaic tile rule (M % 8, K % 128, N % 128; the
  kernel bounds-checks every edge): rank-2/3 x, 2-D w, float dtypes, no
  transpose flags, a known activation, a rank-1 bias, and M at least the
  tuning table's measured ``pallas_min_m`` (``ops/tuning.py``).
* The ``custom_vjp`` of ``pallas_matmul.py:142`` is the operator's
  registered autograd formula (``ops/library.py``): the kernel forward,
  and ``_fused_bwd`` (``:158``) in PyTorch — the float32 pre-activation
  recomputed, the activation's derivative, then dx, dw and db. Its
  products are plain matmuls, as the JAX backward is plain XLA. A tracer
  (``torch.export``) records the forward as one
  ``dl4j_tpu_torch::fused_matmul`` node and the backward as its aten
  ops.

The port's float32 contract keeps products accurate to float32
(``nn/dtype.precision_scope``, ``torch.backends.cuda.matmul.allow_tf32 =
False``), and the plain version is only a reference when it is computed so.
The ``"sm90_f32"`` kernel meets it on TF32 tensor cores by splitting each
operand into TF32 parts, hi = tf32(v) and lo = tf32(v − hi), and adding
three TF32 products (lo·hi, hi·lo, then hi·hi) — never single-pass TF32,
and held to the float32 check :func:`kernel_tolerance` unchanged, which a
single TF32 pass breaks.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops import _build, capture, library, tuning
from deeplearning4j_tpu_torch.ops.cuda_attention import _on_cuda
from deeplearning4j_tpu_torch.ops.nn_ops import (
    FUSED_MATMUL_ACTIVATIONS, apply_fused_activation,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P)
# x w bias out | m n k dtype act | stream
_SM90_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P)
# x ws bias out | m n k act bn | stream
_F32_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, _I, _I, _I, _I, _P)
_SPLIT_ARGS = (_P, _P, _I, _I, _P)  # w ws | k n | stream
TILE_N = (192, 128)  # the sm90_f32 kernel's tile widths, preferred first
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {a: i for i, a in enumerate(FUSED_MATMUL_ACTIVATIONS)}


def _orient(x, w, transpose_a: bool, transpose_b: bool):
    if transpose_a:
        x = x.transpose(-1, -2)
    if transpose_b:
        w = w.transpose(-1, -2)
    return x, w


def fused_matmul_bias_act_reference(x, w, b=None, *,
                                    activation: str = "none",
                                    transpose_a: bool = False,
                                    transpose_b: bool = False):
    """Plain version: act(x @ w + b) in float32, one cast to x's dtype."""
    x, w = _orient(x, w, transpose_a, transpose_b)
    y = torch.matmul(x.float(), w.float())
    if b is not None:
        y = y + b.float()
    return apply_fused_activation(y, activation).to(x.dtype)


def matmul_design(x2, w, out) -> str:
    """Which kernel computes ``out = act(x2 @ w + b)``: ``"sm90"`` for
    bfloat16/float16 with K and N multiples of 8 and x2, w and out 16-byte
    aligned (TMA's row strides and addresses), ``"wmma"`` for the other
    16-bit cases; ``"sm90_f32"`` for float32 with K a multiple of 4 and x2
    16-byte aligned (TMA reads x2 and the weight's own K-major copy; the
    epilogue masks any N), ``"simt"`` for the other float32 cases. A
    static choice, not a fallback: either kernel raises when its build or
    launch fails."""
    k, n = w.shape
    if x2.dtype == torch.float32:
        return ("sm90_f32" if k % 4 == 0 and x2.data_ptr() % 16 == 0
                else "simt")
    aligned = all(t.data_ptr() % 16 == 0 for t in (x2, w, out))
    return "sm90" if k % 8 == 0 and n % 8 == 0 and aligned else "wmma"


def kmajor_split(w, out=None) -> torch.Tensor:
    """The (2, N, K) K-major split copy of a float32 (K, N) CUDA weight —
    hi = tf32(wᵀ) and lo = tf32(wᵀ − hi), the parts whose three TF32
    products lo·hi + hi·lo + hi·hi the sm90_f32 kernels add for one
    float32 product — by one launch of ``dl4j_tf32_split_weight``
    (``csrc/fused_matmul_f32_sm90.cu``), into ``out`` when given."""
    if w.device.type != "cuda":
        raise ValueError(f"kmajor_split: unsupported device {w.device}")
    w = w.float().contiguous()
    k, n = w.shape
    ws = (torch.empty((2, n, k), dtype=torch.float32, device=w.device)
          if out is None else out)
    if ws.shape != (2, n, k) or not ws.is_contiguous():
        raise ValueError(f"kmajor_split: out {tuple(ws.shape)} is not a "
                         f"contiguous (2, {n}, {k})")
    fn = _build.kernel_fn("fused_matmul_f32_sm90", "dl4j_tf32_split_weight",
                          _SPLIT_ARGS)
    rc = fn(w.data_ptr(), ws.data_ptr(), k, n,
            torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tf32_split_weight: ({k}, {n}) weight, launch "
                           f"returned {rc}")
    return ws


def kmajor_weight(w, split: bool = False):
    """The K-major (N, K) copy of a (K, N) weight that an sm90 GEMM reads
    (8-bit and TF32 wgmma have no transpose) — for ``split``, the float32
    weight's TF32 parts as one (2, N, K) tensor (:func:`kmajor_split`).
    Made once and kept on ``w`` itself, so it lives and dies
    with the weight; remade when ``w`` changes in place (its ``_version``)
    or its storage, shape or strides change. Never keyed on the pointer
    alone: the caching allocator hands a freed weight's address to the
    next tensor. An inference tensor keeps no version counter, so a kept
    copy could go stale unseen: its copy is made at every call. Copies
    made are counted in ``kmajor_weight.copies``. A kept copy is a
    derived buffer of an inference unit's CUDA-graph capture underway
    (``ops/capture.py``): the graph reads it in place, and it is remade
    into the same buffer (:func:`_remake_kmajor`) before a replay once
    ``w`` has changed.

    Under a training unit's warm-up and capture
    (``capture.remakes_inside()``) the copy is made at every call and kept
    nowhere: the remaking launch is recorded in the graph, so each replay
    remakes it from the weight as the replay finds it. A training step
    rewrites its weights in place every replay, so a copy kept across
    replays would always be stale; a derived buffer remade before the
    replay would cost the same launch outside the graph and could not
    serve a graph of several steps, whose later steps read weights the
    earlier ones wrote."""
    def make():
        kmajor_weight.copies += 1
        return kmajor_split(w) if split else w.t().contiguous()

    if w.is_inference() or capture.remakes_inside():
        return make()
    attr = "_dl4j_kmajor_split" if split else "_dl4j_kmajor"
    key = (w._version, w.data_ptr(), tuple(w.shape), w.stride())
    kept = getattr(w, attr, None)
    if kept is not None and kept[0] == key:
        wt = kept[1]
    else:
        wt = make()
        setattr(w, attr, (key, wt))
    capture.note_derived(w, wt, functools.partial(_remake_kmajor,
                                                  attr=attr, split=split))
    return wt


kmajor_weight.copies = 0


def _remake_kmajor(w, wt, *, attr: str, split: bool) -> None:
    """Remake ``w``'s K-major copy into ``wt``, the buffer a captured graph
    reads, and keep it on ``w`` as the current one (counted as a copy)."""
    kmajor_weight.copies += 1
    if split:
        kmajor_split(w, out=wt)
    else:
        wt.copy_(w.t())
    setattr(w, attr, ((w._version, w.data_ptr(), tuple(w.shape),
                       w.stride()), wt))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def fullest_tile_n(m: int, n: int, candidates, sms: int, bm: int = 128):
    """The tile width among ``candidates`` whose waves of one tile an SM
    leave the least of the card idle: the useful share m·n of waves · sms
    · bm · bn (padding past M and N and the last wave's idle SMs both
    count against a width); the first candidate wins a tie. The sm90
    kernels of a persistent grid (``csrc/*_sm90.cu``) take it as their
    BN."""
    def share(bn):
        tiles = -(-m // bm) * -(-n // bn)
        return m * n / (-(-tiles // sms) * sms * bm * bn)

    return max(candidates, key=share)


def fused_matmul(x, w, b=None, *, activation: str = "none",
                 transpose_a: bool = False, transpose_b: bool = False):
    """The CUDA kernel of :func:`fused_matmul_bias_act_reference` — same
    contract; x (M, K) or (B, T, K), w (K, N), b (N,); x and w of one
    dtype among float32, bfloat16 and float16. The operator
    ``dl4j_tpu_torch::fused_matmul``, differentiable (``_fused_bwd``'s
    backward, registered as its autograd formula); the registry's CUDA
    helper of ``fused_matmul_bias_act``."""
    return library.ops().fused_matmul(x, w, b, activation, bool(transpose_a),
                                      bool(transpose_b))


def _fused_matmul(x, w, b, activation: str, transpose_a: bool,
                  transpose_b: bool) -> torch.Tensor:
    """The kernel's launch (the CUDA implementation of the
    ``fused_matmul`` operator): the design by pointer alignment and the
    float32 weight's K-major split copy (:func:`kmajor_weight`, kept on
    the weight tensor the operator was given) are chosen and made here,
    where real pointers exist."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_matmul: unsupported device {x.device}")
    x, w = _orient(x, w, transpose_a, transpose_b)
    if x.ndim not in (2, 3) or w.ndim != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"fused_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (..., M, K) and (K, N)")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"fused_matmul: x and w must share one of float32, "
                         f"bfloat16, float16; got {x.dtype} and {w.dtype}")
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_matmul: unknown activation '{activation}';"
                         f" valid: {list(FUSED_MATMUL_ACTIVATIONS)}")
    k, n = w.shape
    if b is not None and (b.ndim != 1 or b.shape[0] != n):
        raise ValueError(f"fused_matmul: bias {tuple(b.shape)} is not ({n},)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    w_in, w = w, w.contiguous()
    bias = None if b is None else b.to(torch.float32).contiguous()
    if any(t.device != x.device for t in (w, bias) if t is not None):
        raise ValueError("fused_matmul: inputs on different devices")
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:  # nothing to compute: no launch
        return out.reshape(lead + (n,))
    design = matmul_design(x2, w, out)
    bias_ptr = None if bias is None else bias.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    act = _ACT_CODES[activation]
    if design == "sm90_f32":
        ws = kmajor_weight(w_in, split=True)
        bn = fullest_tile_n(m, n, TILE_N, sm_count(x.device.index or 0))
        fn = _build.kernel_fn("fused_matmul_f32_sm90",
                              "dl4j_fused_matmul_f32_sm90", _F32_ARGS)
        rc = fn(x2.data_ptr(), ws.data_ptr(), bias_ptr, out.data_ptr(), m,
                n, k, act, bn, stream)
    else:
        args = (x2.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), m, n,
                k, _DTYPE_CODES[x.dtype], act)
        if design == "sm90":
            fn = _build.kernel_fn("fused_matmul_sm90",
                                  "dl4j_fused_matmul_sm90", _SM90_ARGS)
            rc = fn(*args, stream)
        else:
            fn = _build.kernel_fn("fused_matmul", "dl4j_fused_matmul", _ARGS)
            rc = fn(*args, stream)
    kernel = {"sm90": "fused_matmul_sm90",
              "sm90_f32": "fused_matmul_f32_sm90"}.get(design, "fused_matmul")
    if rc == -1:
        raise ValueError(f"{kernel}: shape ({m},{k})x({k},{n}) not taken "
                         f"by the kernel")
    if rc == -2:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (or libcuda does not export it)")
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {rc}")
    fused_matmul.launches += 1
    fused_matmul.sm90_launches += int(design == "sm90")
    fused_matmul.sm90_f32_launches += int(design == "sm90_f32")
    return out.reshape(lead + (n,))


fused_matmul.launches = 0
fused_matmul.sm90_launches = 0
fused_matmul.sm90_f32_launches = 0


def _act_grad(pre, activation: str):
    """d act(pre) / d pre, from the float32 pre-activation."""
    if activation == "none":
        return torch.ones_like(pre)
    if activation == "relu":
        return (pre > 0).to(pre.dtype)
    if activation == "tanh":
        return 1.0 - torch.tanh(pre) ** 2
    if activation == "gelu_exact":
        cdf = 0.5 * (1.0 + torch.erf(pre * (1.0 / math.sqrt(2.0))))
        pdf = torch.exp(-0.5 * pre * pre) * (1.0 / math.sqrt(2.0 * math.pi))
        return cdf + pre * pdf
    if activation == "gelu":
        with torch.enable_grad():
            p = pre.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(
                F.gelu(p, approximate="tanh").sum(), p)
        return g
    raise ValueError(f"unknown activation '{activation}'")


def _fused_backward(ctx, g):
    """``_fused_bwd`` (``pallas_matmul.py:158``) in PyTorch: the float32
    pre-activation recomputed (no saved (M, N) float32 tensor), the
    activation's derivative, then dx, dw and db as plain matmuls, as the
    JAX backward is plain XLA."""
    x, w, b = ctx.saved_tensors
    activation, transpose_a, transpose_b = ctx.cfg
    xa, wa = _orient(x, w, transpose_a, transpose_b)
    pre = torch.matmul(xa.float(), wa.float())
    if b is not None:
        pre = pre + b.float()
    dpre = g.float() * _act_grad(pre, activation)
    dx = torch.matmul(dpre, wa.float().transpose(-1, -2)).to(x.dtype)
    red = tuple(range(dpre.ndim - 2))
    dw = torch.matmul(xa.float().transpose(-1, -2), dpre)
    if red:
        dw = dw.sum(dim=red)
    dw = dw.to(w.dtype)
    if transpose_a:
        dx = dx.transpose(-1, -2)
    if transpose_b:
        dw = dw.transpose(-1, -2)
    db = None if b is None else dpre.sum(
        dim=tuple(range(dpre.ndim - 1))).to(b.dtype)
    return dx, dw, db, None, None, None


def _fused_setup(ctx, inputs, output):
    x, w, b, activation, transpose_a, transpose_b = inputs
    ctx.save_for_backward(x, w, b)
    ctx.cfg = (activation, transpose_a, transpose_b)


def _fused_matmul_cpu(x, w, b, activation, transpose_a, transpose_b):
    return fused_matmul_bias_act_reference(
        x, w, b, activation=activation, transpose_a=transpose_a,
        transpose_b=transpose_b)


def _fused_matmul_fake(x, w, b, activation, transpose_a, transpose_b):
    x, w = _orient(x, w, transpose_a, transpose_b)
    return x.new_empty(x.shape[:-1] + (w.shape[-1],))


library.define("fused_matmul", "(Tensor x, Tensor w, Tensor? b, "
               "str activation, bool transpose_a, bool transpose_b) -> Tensor",
               cuda=_fused_matmul, cpu=_fused_matmul_cpu,
               fake=_fused_matmul_fake, backward=_fused_backward,
               setup_context=_fused_setup)


def fused_matmul_usable(x, w, b=None, **kw) -> bool:
    """Gate of the CUDA helper: the JAX ``_usable`` decisions on CUDA
    tensors, without the TPU tile rule (the kernel takes any M, K and N);
    M below the table's ``pallas_min_m`` returns
    :data:`~.tuning.CROSSOVER`. Kernel limits the JAX gate does not have
    (mixed or float64 operands) raise in :func:`fused_matmul` instead of
    the op quietly running its generic."""
    if not _on_cuda(x, w):
        return False
    if kw.get("transpose_a") or kw.get("transpose_b"):
        return False
    if kw.get("activation", "none") not in FUSED_MATMUL_ACTIVATIONS:
        return False
    if x.ndim not in (2, 3) or w.ndim != 2:
        return False
    if not (x.is_floating_point() and w.is_floating_point()):
        return False
    if b is not None and getattr(b, "ndim", 0) != 1:
        return False
    return tuning.crossover("fused_matmul_bias_act", "pallas_min_m",
                            math.prod(x.shape[:-1]))


def kernel_tolerance(x, w, plain):
    """How far the kernel may sit from the plain version on the same
    inputs: elementwise ``|kernel − plain| <= atol + rtol·|plain|``.
    Both accumulate the same float32 products of K terms in other orders
    (``atol`` = 2·K·2⁻²⁴·max|x|·max|w|, the float32 summation bound, plus
    1e-6) and apply the same float32 epilogue; the activations' float32
    library calls may differ by a few units in the last place (rtol 1e-6
    in float32). bfloat16/float16 outputs are rounded once from float32 on
    both sides: one unit in the last place (2⁻⁷ / 2⁻¹⁰ of |plain|)."""
    k = x.shape[-1]
    atol = (2.0 * k * 2.0 ** -24 * x.float().abs().max().item()
            * w.float().abs().max().item() + 1e-6)
    rtol = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[plain.dtype]
    return atol, rtol


def register_platform_fused_matmul() -> None:
    """Install the kernel as the ``"cuda"`` helper of
    fused_matmul_bias_act."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "cuda" not in reg.get("fused_matmul_bias_act").platform_impls:
        reg.register_platform("fused_matmul_bias_act", "cuda",
                              fused_matmul, fused_matmul_usable)
