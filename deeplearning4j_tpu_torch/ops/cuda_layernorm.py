"""act(LayerNorm(x)·gain + bias) in one pass: the plain versions, the
hand-written CUDA kernel, its gate and the differentiable
:class:`FusedLayerNormFn`.

Counterpart of ``deeplearning4j_tpu/ops/pallas_layernorm.py`` — the
platform helper of ``fused_layer_norm``, the SameDiff optimizer's
``layer_norm`` → ``gelu`` fusion target:

* :func:`generic_f32` is ``_generic_f32`` (``pallas_layernorm.py:135``):
  the float32 reference math — mean, the centered variance, normalize,
  gain, bias, activation — returned in float32. The backward recomputes
  it. :func:`fused_layer_norm_reference` is the plain version of the
  kernel: the same, cast once to ``x.dtype``, a missing bias a zeros
  bias. The generic registry op (``ops/nn_ops.py`` ``fused_layer_norm``)
  is the other plain version: the op chain it replaces, op by op in x's
  dtype, as the JAX generic does.
* :func:`fused_layer_norm_kernel` launches ``csrc/fused_layer_norm.cu``
  (replacing ``_kernel``, ``pallas_layernorm.py:69``, via
  ``fused_layer_norm_pallas``): statistics and epilogue in float32, one
  write in x's dtype. Given CPU tensors it computes the plain version;
  given CUDA tensors it launches or raises — there is no fallback. Its
  launches are counted in ``fused_layer_norm_kernel.launches``.
* :func:`fused_layer_norm_usable` is the JAX ``_usable`` (``:178``) on
  CUDA tensors without its TPU limits: trailing axis, a known activation,
  floating types, gain and bias of shape (D,). The Mosaic tile rule
  (D % 128, rows % 8) and the TPU-measured ``min_rows`` are left out: the
  kernel takes any rows and any D.
* :class:`FusedLayerNormFn` is the ``custom_vjp`` of ``:146`` as an
  ``autograd.Function``: the kernel forward saving only its inputs, and
  ``_fused_ln_bwd`` (``:156``) — autograd of :func:`generic_f32` on the
  saved inputs, the gradients cast back to the inputs' dtypes.
"""

from __future__ import annotations

import ctypes

import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.cuda_attention import _on_cuda
from deeplearning4j_tpu_torch.ops.nn_ops import (
    FUSED_MATMUL_ACTIVATIONS, apply_fused_activation,
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = (_P, _P, _P, _P, ctypes.c_longlong, _I, ctypes.c_float, _I, _I, _I,
         _P)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ACT_CODES = {a: i for i, a in enumerate(FUSED_MATMUL_ACTIVATIONS)}
# elements of a 16-byte vector per dtype: the kernel's `vec` accesses
_VEC = {torch.float32: 4, torch.bfloat16: 8, torch.float16: 8}


def generic_f32(x, gain, bias, eps: float, activation: str):
    """``_generic_f32``: act(LN(x)·gain + bias) over the trailing axis,
    computed and returned in float32."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    c = xf - mean
    var = torch.mean(c * c, dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + eps) * gain.float()
    y = y + bias.float()
    return apply_fused_activation(y, activation)


def fused_layer_norm_reference(x, gain, bias=None, *, eps: float = 1e-5,
                               activation: str = "none"):
    """Plain version of the kernel: :func:`generic_f32`, one cast to x's
    dtype; a missing bias is a zeros bias."""
    b = bias if bias is not None else torch.zeros(
        x.shape[-1], dtype=x.dtype, device=x.device)
    return generic_f32(x, gain, b, eps, activation).to(x.dtype)


def fused_layer_norm_kernel(x, gain, bias=None, *, eps: float = 1e-5,
                            activation: str = "none"):
    """The CUDA kernel of :func:`fused_layer_norm_reference` — same
    contract; x (..., D) of float32, bfloat16 or float16, gain and bias
    (D,) of any float type. Not differentiable: the registry reaches it
    through :func:`fused_layer_norm_helper`."""
    if x.device.type == "cpu":
        return fused_layer_norm_reference(x, gain, bias, eps=eps,
                                          activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if x.ndim < 1 or x.shape[-1] == 0:
        raise ValueError(f"fused_layer_norm: x {tuple(x.shape)} has no "
                         f"trailing axis to normalize")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_layer_norm: x must be float32, bfloat16 or "
                         f"float16; got {x.dtype}")
    if activation not in _ACT_CODES:
        raise ValueError(f"fused_layer_norm: unknown activation "
                         f"'{activation}'; valid: "
                         f"{list(FUSED_MATMUL_ACTIVATIONS)}")
    d = x.shape[-1]
    for name, t in (("gain", gain), ("bias", bias)):
        if t is not None and (t.shape != (d,) or not t.is_floating_point()):
            raise ValueError(f"fused_layer_norm: {name} {tuple(t.shape)} "
                             f"{t.dtype} is not a float ({d},)")
    g = gain.to(torch.float32).contiguous()
    b = None if bias is None else bias.to(torch.float32).contiguous()
    if any(t.device != x.device for t in (g, b) if t is not None):
        raise ValueError("fused_layer_norm: inputs on different devices")
    x2 = x.reshape(-1, d).contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:  # nothing to compute: no launch
        return out.reshape(x.shape)
    vec = int(d % _VEC[x.dtype] == 0
              and x2.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    fn = _build.kernel_fn("fused_layer_norm", "dl4j_fused_layer_norm", _ARGS)
    rc = fn(x2.data_ptr(), g.data_ptr(), None if b is None else b.data_ptr(),
            out.data_ptr(), rows, d, float(eps), _DTYPE_CODES[x.dtype],
            _ACT_CODES[activation], vec,
            torch.cuda.current_stream(x.device).cuda_stream)
    if rc == -1:
        raise ValueError(f"fused_layer_norm: ({rows}, {d}) not taken by the "
                         f"kernel")
    if rc != 0:
        raise RuntimeError(f"fused_layer_norm: kernel launch failed with "
                           f"cudaError_t {rc}")
    fused_layer_norm_kernel.launches += 1
    return out.reshape(x.shape)


fused_layer_norm_kernel.launches = 0


class FusedLayerNormFn(torch.autograd.Function):
    """The kernel forward with ``_fused_ln_bwd``'s backward
    (``pallas_layernorm.py:156``): nothing but the inputs is saved; the
    backward recomputes :func:`generic_f32` under autograd."""

    @staticmethod
    def forward(ctx, x, gain, bias, eps, activation):
        ctx.save_for_backward(x, gain, bias)
        ctx.cfg = (eps, activation)
        return fused_layer_norm_kernel(x, gain, bias, eps=eps,
                                       activation=activation)

    @staticmethod
    def backward(ctx, g):
        x, gain, bias = ctx.saved_tensors
        eps, activation = ctx.cfg
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (x, gain, bias)]
            y = generic_f32(*leaves, eps, activation)
            dx, dg, db = torch.autograd.grad(y, leaves, g.float())
        return (dx.to(x.dtype), dg.to(gain.dtype), db.to(bias.dtype), None,
                None)


def fused_layer_norm_helper(x, gain, bias=None, *, axis: int = -1,
                            eps: float = 1e-5, activation: str = "none"):
    """The registered CUDA platform impl: the differentiable kernel, a
    missing bias a zeros bias of x's dtype (``:171``)."""
    b = bias if bias is not None else torch.zeros(
        x.shape[-1], dtype=x.dtype, device=x.device)
    return FusedLayerNormFn.apply(x, gain, b, eps, activation)


def fused_layer_norm_usable(x, gain, bias=None, **kw) -> bool:
    """Gate of the CUDA helper: the JAX ``_usable`` decisions on CUDA
    tensors, without the TPU tile rule and ``min_rows`` (the kernel takes
    any rows and any D). A kernel limit the JAX gate does not have
    (float64 x) raises in :func:`fused_layer_norm_kernel` instead of the op
    quietly running its generic."""
    if not _on_cuda(x, gain, *(() if bias is None else (bias,))):
        return False
    nd = x.ndim
    if nd < 2 or kw.get("axis", -1) not in (-1, nd - 1):
        return False
    if kw.get("activation", "none") not in FUSED_MATMUL_ACTIVATIONS:
        return False
    if not all(t.is_floating_point()
               for t in (x, gain) + (() if bias is None else (bias,))):
        return False
    if gain.ndim != 1 or gain.shape[0] != x.shape[-1]:
        return False
    return bias is None or (bias.ndim == 1 and bias.shape[0] == x.shape[-1])


def kernel_tolerance(dtype: torch.dtype):
    """``(atol, rtol)`` of the kernel against
    :func:`fused_layer_norm_reference` on the same inputs, elementwise
    ``|kernel − plain| <= atol + rtol·|plain|``. Both compute the same
    float32 statistics summed in another order (a few units in the last
    place of the mean and variance at D ≤ 4096: 1e-5 relative) and the
    same float32 epilogue, whose library calls may differ by a few units
    in the last place. bfloat16/float16 outputs are rounded once from
    float32 on both sides: one unit in the last place (2⁻⁷ / 2⁻¹⁰ of
    |plain|). 1e-5 absolute covers outputs near zero."""
    rtol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7,
            torch.float16: 2.0 ** -10}[dtype]
    return 1e-5, rtol


def register_platform_fused_layernorm() -> None:
    """Install the kernel as the ``"cuda"`` helper of fused_layer_norm."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "cuda" not in reg.get("fused_layer_norm").platform_impls:
        reg.register_platform("fused_layer_norm", "cuda",
                              fused_layer_norm_helper,
                              fused_layer_norm_usable)
