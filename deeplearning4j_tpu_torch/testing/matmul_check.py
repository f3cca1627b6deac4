"""Faulted plain versions of the tensor-core ("sm90") GEMM kernels, for
their checks: the fused matmul (16-bit and float32), the BN-apply → matmul
→ BN-statistics kernel and the int8 GEMM.

``csrc/fused_matmul_sm90.cu`` walks K in slabs of :data:`SLAB` columns
(``csrc/fused_matmul_f32_sm90.cu`` in slabs of :data:`F32_SLAB`) through a
ring of shared-memory stages. The faults such a design could bring are a
slab that never reaches the product (the last, ragged one) and a slab
that is accumulated twice (a consumer waiting on the wrong phase of its
stage's barrier); the float32 design could also run one TF32 pass where
it should run three (``testing/split_f32.py``). :func:`fused_matmul_variant`
computes the plain version (``cuda_matmul.fused_matmul_bias_act_reference``)
with one of these faults; each must exceed ``cuda_matmul.kernel_tolerance``,
which shows that the kernel's check still catches them.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops.nn_ops import apply_fused_activation
from deeplearning4j_tpu_torch.testing import split_f32

SLAB = 64  # K columns of one shared-memory stage
F32_SLAB = 32  # the float32 design's: one 128-byte span of float32
FAULTS = ("last_slab_dropped", "slab_added_twice")
F32_FAULTS = ("single_pass_tf32",) + FAULTS


def fused_matmul_variant(x, w, b=None, *, activation: str = "none",
                         fault: str, slab: int = SLAB) -> torch.Tensor:
    """act(x @ w + b) in float32, one cast to x's dtype, with ``fault``
    (one of :data:`F32_FAULTS`): the last K slab of ``slab`` columns left
    out of the product, the first K slab added to it a second time, or the
    product taken as one TF32 pass (operands rounded to TF32, float32
    sums)."""
    assert fault in F32_FAULTS, fault
    xf, wf = x.float(), w.float()
    k = wf.shape[0]
    if fault == "single_pass_tf32":
        y = split_f32.split_product(xf, wf, passes="single")
    elif fault == "last_slab_dropped":
        keep = (k - 1) // slab * slab
        y = torch.matmul(xf[..., :keep], wf[:keep])
    else:
        y = torch.matmul(xf, wf) + torch.matmul(xf[..., :slab], wf[:slab])
    if b is not None:
        y = y + b.float()
    return apply_fused_activation(y, activation).to(x.dtype)


# ------------------------------------------------ bn_matmul_stats (convbn)
# csrc/bn_matmul_stats_sm90.cu: 64-column K slabs, the prologue rewritten
# in shared memory between the TMA landing and the product (a missing
# proxy fence lets the tensor cores read the bytes from before it), and
# per-128-row-block partial sums of the statistics.

CONVBN_SLAB = 64
CONVBN_FAULTS = ("prologue_skipped", "last_slab_dropped",
                 "block_counted_twice")


def convbn_faults(fuse_prologue: bool):
    """The faults that can show on a call: a call without the prologue
    cannot skip it."""
    return tuple(f for f in CONVBN_FAULTS
                 if fuse_prologue or f != "prologue_skipped")


def bn_matmul_stats_variant(x, scale, shift, w, stat_shift, *, relu: bool,
                            fuse_prologue: bool, fault: str):
    """``(z, parts, mean, var)`` of the plain version with ``fault``
    (one of :data:`CONVBN_FAULTS`): the product of the raw x (the prologue
    skipped), the last K slab left out of the product, or the last
    128-row block's partial sums counted twice."""
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc

    assert fault in convbn_faults(fuse_prologue), fault
    if fuse_prologue and fault != "prologue_skipped":
        y = x.float() * scale.float() + shift.float()
        if relu:
            y = torch.clamp_min(y, 0.0)
        y = y.to(x.dtype)
    else:
        y = x
    k = w.shape[0]
    keep = (k - 1) // CONVBN_SLAB * CONVBN_SLAB if (
        fault == "last_slab_dropped") else k
    z = torch.matmul(y[:, :keep].float(), w[:keep].float()).to(x.dtype)
    parts = cc.reference_partials(z, stat_shift)
    if fault == "block_counted_twice":
        parts[:, -1] *= 2.0
    return (z, parts) + cc.reduce_partials(parts, stat_shift)


def convbn_share(got, plain, args, *, relu: bool, fuse_prologue: bool):
    """The worst |got − plain| as a share of its tolerance, over z, mean
    and var (``cuda_convbn.kernel_tolerance``) and the per-block partial
    sums (``cuda_convbn.partials_tolerance``). ``got`` and ``plain`` are
    ``(z, parts, mean, var)``; ``args`` the call's
    ``(x, scale, shift, w, stat_shift)``."""
    from deeplearning4j_tpu_torch.ops import cuda_convbn as cc

    z, parts, mean, var = got
    zr, pr, mr, vr = plain
    z_atol, z_rtol, m_tol, v_tol = cc.kernel_tolerance(
        *args, zr, relu=relu, fuse_prologue=fuse_prologue)
    zerr = (z.float() - zr.float()).abs()
    return max((zerr / (z_atol + z_rtol * zr.float().abs())).max().item(),
               ((mean - mr).abs() / m_tol).max().item(),
               ((var - vr).abs() / v_tol).max().item(),
               ((parts - pr).abs()
                / cc.partials_tolerance(zr, args[4])).max().item())


# --------------------------------------------------------------- int8 GEMM
# csrc/matmul_int8_sm90.cu: 128-deep K slabs (one 128-byte swizzle span of
# int8) and a de-scale that indexes the row and column scales by the
# accumulator register's (row, column). Its check is bit-exactness.

INT8_SLAB = 128
INT8_FAULTS = ("last_slab_dropped", "scales_wrong_axis")


def int8_matmul_variant(xq, xs, w_q, w_scale, dtype, *, fault: str):
    """The plain GEMM (``quantized._int8_descale``) with ``fault`` (one of
    :data:`INT8_FAULTS`): the last K slab left out of the dot, or each
    scale read along the other axis — the row scale by the output column
    and the column scale by the output row (indices wrapped to their
    lengths)."""
    assert fault in INT8_FAULTS, fault
    m, k = xq.shape
    n = w_q.shape[1]
    keep = (k - 1) // INT8_SLAB * INT8_SLAB if (
        fault == "last_slab_dropped") else k
    acc = torch.matmul(xq[:, :keep].to(torch.float64),
                       w_q[:keep].to(torch.float64)).to(torch.float32)
    rs = xs.reshape(m).float()
    cs = w_scale.reshape(n).float()
    if fault == "scales_wrong_axis":
        dev = rs.device
        rows = torch.arange(m, device=dev) % n
        cols = torch.arange(n, device=dev) % m
        return (acc * rs[cols].reshape(1, n) * cs[rows].reshape(m, 1)).to(
            dtype)
    return (acc * rs.reshape(m, 1) * cs.reshape(1, n)).to(dtype)
