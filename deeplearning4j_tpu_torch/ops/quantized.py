"""Int8 quantized matmul — the cheap high-QPS serving path (plain PyTorch).

Counterpart of ``deeplearning4j_tpu/ops/quantized.py``: weights are
quantized ONCE offline to symmetric int8 with a per-output-column float32
scale (``quantize_int8``), activations are quantized dynamically per row
at call time, and ``matmul_int8`` runs the int8×int8 dot with an exact
integer accumulation before de-scaling back to the activation dtype::

    w_q, w_scale = quantize_int8(w, axis=0)          # offline, per column
    y = matmul_int8(x, w_q, w_scale)                 # serving hot path

The arithmetic is the reference's, step for step, because the CUDA kernel
(:mod:`.cuda_quantized`) is held to it bit for bit: ``amax`` in x's dtype
floored at 1e-12, then ``float32 / 127``; ``x / scale`` in x's dtype (a
bfloat16 x divides by the bfloat16-rounded scale); round half to even;
clip to ±127; an exact integer dot; the de-scale ``acc · row scale ·
column scale`` in float32, in that order; one cast to x's dtype.

What differs from the JAX package: the integer dot, and one division.
XLA's int8 ``dot_general`` accumulates in int32; on the card
``torch.matmul`` has no integer path, so the plain version multiplies the
int8 values in float64, which is exact for any K this repository meets
(|acc| <= K·127² < 2^53), on the CPU and on the card alike. And
``amax / 127`` divides by a tensor, not a Python scalar: PyTorch's CUDA
kernel multiplies by the reciprocal of a scalar divisor, which is not
always the IEEE quotient XLA (and the kernel) compute. Gradients are
straight-through on the activation quantization (``_mm8_bwd``):
``dx = g @ dequantize(w)ᵀ``, no gradient for the int8 weights, zeros for
the scale.
"""

from __future__ import annotations

from typing import Callable

import torch

from deeplearning4j_tpu_torch.ops.registry import op

_QMAX = 127.0


def _symmetric_int8(x, amax):
    """``(q, scale)`` from the absolute maximum ``amax`` (x's dtype,
    broadcastable onto x): the reference's scale and rounding."""
    floor = torch.full((), 1e-12, dtype=amax.dtype, device=amax.device)
    # divided by a tensor on amax's device: PyTorch's CUDA division by a
    # Python scalar multiplies by its reciprocal, one unit off IEEE at times
    qmax = torch.full((), _QMAX, dtype=torch.float32, device=amax.device)
    scale = torch.maximum(amax, floor).to(torch.float32) / qmax
    q = torch.clamp(torch.round(x / scale.to(x.dtype)), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


@op("quantize_int8")
def quantize_int8(x, *, axis=None):
    """Symmetric int8 quantization: ``(q, scale)`` with ``x ≈ q * scale``.
    ``axis``: reduction axis/axes the scale is SHARED over (None = one
    per-tensor scale; ``axis=0`` on a (K, N) weight gives one scale per
    output column, kept as (1, N) — the matmul_int8 layout)."""
    if axis is None:
        amax = torch.amax(torch.abs(x))
    else:
        dims = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    return _symmetric_int8(x, amax)


@op("dequantize_int8")
def dequantize_int8(q, scale):
    """Densify: ``q * scale`` in float32 (broadcasts the saved scale
    layout)."""
    return q.to(torch.float32) * scale


def _row_quantize(x):
    """Dynamic per-row activation quantization ((…, K) -> int8 + (…, 1)
    float32 row scales), the hot path's first step."""
    return _symmetric_int8(x, torch.amax(torch.abs(x), dim=-1, keepdim=True))


def _int8_descale(xq, xs, w_q, w_scale, dtype: torch.dtype):
    """``(xq @ w_q) · xs · w_scale`` cast to ``dtype``: the exact integer
    dot (float64 products of int8 values), then the float32 de-scale in
    the reference's order."""
    acc = torch.matmul(xq.to(torch.float64), w_q.to(torch.float64))
    y = acc.to(torch.float32) * xs * w_scale.reshape(1, -1)
    return y.to(dtype)


def _matmul_int8_raw(x, w_q, w_scale):
    xq, xs = _row_quantize(x)
    return _int8_descale(xq, xs, w_q, w_scale, x.dtype)


class Int8MatmulFn(torch.autograd.Function):
    """``_mm8``'s custom VJP: the forward ``forward(x, w_q, w_scale)`` (the
    plain version here, the CUDA kernel as the ``"cuda"`` helper) with the
    straight-through backward ``_mm8_bwd``."""

    @staticmethod
    def forward(ctx, x, w_q, w_scale, forward: Callable):
        ctx.save_for_backward(w_q, w_scale)
        ctx.x_dtype = x.dtype
        return forward(x, w_q, w_scale)

    @staticmethod
    def backward(ctx, g):
        w_q, w_scale = ctx.saved_tensors
        w_deq = w_q.to(torch.float32) * w_scale.reshape(1, -1)
        dx = torch.matmul(g.to(torch.float32), w_deq.t()).to(ctx.x_dtype)
        # the int8 weights take no gradient; the frozen serving scale zeros
        return dx, None, torch.zeros_like(w_scale), None


@op("matmul_int8")
def matmul_int8(x, w_q, w_scale):
    """``x @ dequantize(w_q, w_scale)`` computed in int8.

    x: (…, M, K) float; w_q: (K, N) int8; w_scale: (N,) or (1, N) float32
    per column. Activations quantize dynamically per row (straight-through
    for gradients); the int8×int8 dot accumulates exactly and de-scales by
    ``row_scale · column_scale``."""
    return Int8MatmulFn.apply(x, w_q, w_scale, _matmul_int8_raw)
