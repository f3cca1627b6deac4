"""Fused BN-apply → 1×1 conv (matmul) → BN statistics: the
``fused_bn_matmul_stats`` op, its plain PyTorch version, its hand-written
CUDA kernel, and the differentiable ``fused_matmul_bn``.

Counterpart of ``deeplearning4j_tpu/ops/pallas_convbn.py``::

    z = relu(x · scale + shift) @ W        # prologue: previous BN's affine
    mean, var = shifted batch moments of z # epilogue: this BN's statistics

* :func:`reference_bn_matmul_stats` is the plain version
  (``pallas_convbn.py:231``): the prologue in float32 rounded to x's dtype,
  the product accumulated in float32 and rounded to x's dtype, and the
  moments — shifted by the running mean ``stat_shift`` — taken from the
  ROUNDED z.
* :func:`bn_matmul_stats` launches a kernel replacing ``_kernel``
  (``pallas_convbn.py:49``, via ``fused_bn_matmul_stats``): one pass reads
  x once and writes z once, taking the moments from the float32
  accumulator as the Pallas kernel does, as per-row-block partial sums
  (:func:`bn_matmul_stats_partials`) that the wrapper reduces in float32.
  :func:`convbn_design` picks the kernel statically: ``"sm90"``
  (``csrc/bn_matmul_stats_sm90.cu``, wgmma fed by TMA through an mbarrier
  ring, the prologue rewritten in shared memory) where TMA can read x and
  w, ``"wmma"`` (``csrc/bn_matmul_stats.cu``) for pointers off 16-byte
  alignment. Given CPU tensors it computes the plain version; given CUDA
  tensors it launches or raises. Its launches are counted in
  ``bn_matmul_stats.launches``, the sm90 design's also in
  ``bn_matmul_stats.sm90_launches``, and each launch's (M, K, N,
  prologue, design) in the ``bn_matmul_stats.census`` Counter.
* :func:`bn_matmul_stats_usable` is the JAX ``_pallas_ok`` minus its
  backend and environment checks: CUDA tensors, bfloat16 x, M % 128,
  K % 64 and N % 64.
* :func:`fused_matmul_bn` is the ``custom_vjp`` of ``pallas_convbn.py:163``
  as an ``autograd.Function``: z, mean and var are differentiable
  (mean/var feed the consumer's normalize affine), ``stat_shift`` is not.
  The backward is ``_fused_bwd`` (``pallas_convbn.py:192``) in PyTorch; its
  two products are plain matmuls, as the JAX package computes them outside
  any Pallas kernel.

Products of bfloat16 operands are taken as float32 matmuls of the upcast
operands (``_dot``): every bfloat16 product is exact in float32 (and in
TF32), so this is the float32 accumulation of ``preferred_element_type=
float32`` on the CPU and on the card alike.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from deeplearning4j_tpu_torch.ops import _build
from deeplearning4j_tpu_torch.ops.cuda_matmul import fullest_tile_n, sm_count
from deeplearning4j_tpu_torch.ops.registry import exec_op, op

_P = ctypes.c_void_p
_I = ctypes.c_int
# x scale shift w stat_shift z csum csq | m k n prologue relu vec_x vec_w
_ARGS = (_P,) * 8 + (ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _P)
# x scale shift w stat_shift z csum csq | m k n prologue relu bn | stream
_SM90_ARGS = (_P,) * 8 + (ctypes.c_longlong, _I, _I, _I, _I, _I, _P)
BLOCK_M = 128  # rows of one block of the kernel: one partial-sum row each
TILE_N = (128, 64)  # the sm90 kernel's tile widths, preferred first


def _dot(a, b):
    """a @ b accumulated in float32 (float32 result)."""
    return torch.matmul(a.float(), b.float())


def reference_bn_matmul_stats(x, scale, shift, w, stat_shift, *,
                              relu: bool = True, fuse_prologue: bool = True):
    """Plain version: the same math as the unfused chain.
    Returns (z in x's dtype, mean (N,) f32, biased var (N,) f32)."""
    if fuse_prologue:
        y = x.float() * scale.float() + shift.float()
        if relu:
            y = torch.clamp_min(y, 0.0)
        y = y.to(x.dtype)
    else:
        y = x
    z = _dot(y, w).to(x.dtype)
    sf = stat_shift.float()
    c = z.float() - sf
    m1 = torch.mean(c, dim=0)
    m2 = torch.mean(c * c, dim=0)
    return z, m1 + sf, torch.clamp_min(m2 - torch.square(m1), 0.0)


# the registry op; its generic impl is the plain version
op("fused_bn_matmul_stats")(reference_bn_matmul_stats)


def convbn_design(x, w) -> str:
    """Which kernel computes :func:`bn_matmul_stats` of the contiguous
    ``x`` and ``w``: ``"sm90"`` where both are 16-byte aligned (TMA's
    addresses; the gate's K % 64 and N % 64 give 16-byte row strides),
    ``"wmma"`` otherwise (its element loads take any bfloat16 pointer). A
    static choice, not a fallback: either kernel raises when its build or
    launch fails."""
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "sm90" if aligned else "wmma"


def convbn_tile_n(m: int, n: int, sms: int) -> int:
    """The sm90 kernel's tile width for an (M, N) output on ``sms`` SMs:
    128 or 64, whichever leaves the fuller waves (``fullest_tile_n``)."""
    return fullest_tile_n(m, n, TILE_N, sms, bm=BLOCK_M)


def bn_matmul_stats_partials(x, scale, shift, w, stat_shift, *,
                             relu: bool = True, fuse_prologue: bool = True):
    """The kernel's own outputs: ``(z, parts)`` with parts (2, M/128, N)
    float32, ``parts[0]`` the sums over each 128-row block of (acc − s)
    and ``parts[1]`` of (acc − s)², acc the float32 accumulator before z
    is rounded. Given CPU tensors, the plain version's
    (:func:`reference_partials` of the plain z). x and w bfloat16,
    M % 128, K % 64, N % 64."""
    if x.device.type == "cpu":
        z = reference_bn_matmul_stats(x, scale, shift, w, stat_shift,
                                      relu=relu,
                                      fuse_prologue=fuse_prologue)[0]
        return z, reference_partials(z, stat_shift)
    if x.device.type != "cuda":
        raise ValueError(f"bn_matmul_stats: unsupported device {x.device}")
    if x.ndim != 2 or w.ndim != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"bn_matmul_stats: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if m % BLOCK_M or k % 64 or n % 64:
        raise ValueError(f"bn_matmul_stats: shape ({m},{k})x({k},{n}) is not "
                         f"a multiple of (128, 64, 64)")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"bn_matmul_stats: x and w must be bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    x = x.contiguous()
    w = w.contiguous()
    f32 = dict(dtype=torch.float32, device=x.device)
    scale = scale.to(**f32).contiguous()
    shift = shift.to(**f32).contiguous()
    sf = stat_shift.to(**f32).contiguous()
    if any(t.device != x.device for t in (w, scale, shift, sf)):
        raise ValueError("bn_matmul_stats: inputs on different devices")
    if scale.shape != (k,) or shift.shape != (k,) or sf.shape != (n,):
        raise ValueError("bn_matmul_stats: scale/shift must be (K,) and "
                         "stat_shift (N,)")
    z = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    parts = torch.empty((2, m // BLOCK_M, n), **f32)
    design = convbn_design(x, w)
    args = (x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w.data_ptr(),
            sf.data_ptr(), z.data_ptr(), parts[0].data_ptr(),
            parts[1].data_ptr(), m, k, n, int(bool(fuse_prologue)),
            int(bool(relu)))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if design == "sm90":
        bn = convbn_tile_n(m, n, sm_count(x.device.index or 0))
        fn = _build.kernel_fn("bn_matmul_stats_sm90",
                              "dl4j_bn_matmul_stats_sm90", _SM90_ARGS)
        rc = fn(*args, bn, stream)
    else:
        fn = _build.kernel_fn("bn_matmul_stats", "dl4j_bn_matmul_stats",
                              _ARGS)
        rc = fn(*args, int(x.data_ptr() % 16 == 0),
                int(w.data_ptr() % 16 == 0), stream)
    kernel = "bn_matmul_stats" + ("_sm90" if design == "sm90" else "")
    if rc == -1:
        raise ValueError(f"{kernel}: shape not taken by the kernel")
    if rc == -2:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (or libcuda does not export it)")
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {rc}")
    bn_matmul_stats.launches += 1
    bn_matmul_stats.sm90_launches += int(design == "sm90")
    bn_matmul_stats.census[(m, k, n, bool(fuse_prologue), design)] += 1
    return z, parts


def bn_matmul_stats(x, scale, shift, w, stat_shift, *, relu: bool = True,
                    fuse_prologue: bool = True):
    """The CUDA kernel of :func:`reference_bn_matmul_stats` — same
    contract; x and w bfloat16, M % 128, K % 64, N % 64."""
    if x.device.type == "cpu":
        return reference_bn_matmul_stats(x, scale, shift, w, stat_shift,
                                         relu=relu,
                                         fuse_prologue=fuse_prologue)
    z, parts = bn_matmul_stats_partials(x, scale, shift, w, stat_shift,
                                        relu=relu,
                                        fuse_prologue=fuse_prologue)
    return (z,) + reduce_partials(parts, stat_shift)


def reduce_partials(parts, stat_shift):
    """``(mean, biased var)`` (N,) float32 from the (2, blocks, N) partial
    sums of (acc − s) and (acc − s)² over M = 128 · blocks rows: the
    first moments m1, m2 of (acc − s), mean m1 + s and var m2 − m1²
    (floored at 0). Five launches on the card: one sum over both."""
    m = parts.shape[1] * BLOCK_M
    sf = stat_shift.to(dtype=torch.float32, device=parts.device)
    m12 = torch.sum(parts, dim=1) / m
    var = torch.addcmul(m12[1], m12[0], m12[0], value=-1.0)
    return m12[0] + sf, var.clamp_min_(0.0)


bn_matmul_stats.launches = 0
bn_matmul_stats.sm90_launches = 0
bn_matmul_stats.census = collections.Counter()


def reset_launch_counts() -> None:
    bn_matmul_stats.launches = 0
    bn_matmul_stats.sm90_launches = 0
    bn_matmul_stats.census.clear()


def bn_matmul_stats_usable(x, scale, shift, w, stat_shift, **kw) -> bool:
    """Gate of the CUDA helper: ``_pallas_ok`` on CUDA tensors — bfloat16
    activations and block-divisible shapes."""
    if not all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in (x, w)):
        return False
    if x.ndim != 2 or w.ndim != 2:
        return False
    m, k = x.shape
    return (x.dtype == torch.bfloat16 and m % 128 == 0 and k % 64 == 0
            and w.shape[1] % 64 == 0)


def kernel_tolerance(x, scale, shift, w, stat_shift, z, *, relu=True,
                     fuse_prologue=True):
    """How far the kernel may sit from the plain version on the same
    inputs, given the plain z. Returns (z_atol, z_rtol, mean_tol (N,),
    var_tol (N,)), elementwise |kernel − plain| <= atol + rtol·|plain|.

    * z: both accumulate the same products in float32, in other orders,
      and round once to bfloat16: one bf16 unit in the last place
      (2^-7·|z|), plus the float32 accumulation error of K terms
      (K·2^-24·max|y|·max|w|, y the prologued operand) where z is near 0.
    * mean/var: the kernel takes them from the float32 accumulator a, the
      plain version from z = bf16(a), |z − a| <= u·|z| with u = 2^-8 (half
      a unit). With c = z − s: |Δmean| <= u·E|z| and
      |Δvar| <= 2u·E[|c||z|] + 2u·|E c|·E|z| + u²(E[z²] + (E|z|)²), per
      column, plus 1e-5 of E|c| (resp. E[c²]) and 1e-6 for the two
      float32 summation orders."""
    k = x.shape[1]
    y = x.float()
    if fuse_prologue:
        y = y * scale.float() + shift.float()
        if relu:
            y = torch.clamp_min(y, 0.0)
    z_atol = k * 2.0 ** -24 * y.abs().max().item() * w.float().abs().max().item()
    u = 2.0 ** -8
    zf = z.float()
    c = zf - stat_shift.float()
    az = zf.abs()
    e_az = az.mean(0)
    mean_tol = u * e_az + 1e-5 * c.abs().mean(0) + 1e-6
    var_tol = (2 * u * (c.abs() * az).mean(0) + 2 * u * c.mean(0).abs() * e_az
               + u * u * ((zf * zf).mean(0) + e_az * e_az)
               + 1e-5 * (c * c).mean(0) + 1e-6)
    return z_atol + 1e-6, 2.0 ** -7, mean_tol, var_tol


def reference_partials(z, stat_shift):
    """``parts`` (2, M/128, N) of a z (M, N): the sums over each 128-row
    block of (z − s) and (z − s)² in float32 — the plain counterpart of
    the kernel's partial sums, which take (acc − s) before the
    rounding."""
    m, n = z.shape
    c = (z.float() - stat_shift.float()).reshape(m // BLOCK_M, BLOCK_M, n)
    return torch.stack((c.sum(1), (c * c).sum(1)))


def partials_tolerance(z, stat_shift):
    """How far the kernel's partial sums may sit from
    :func:`reference_partials` of the plain z, per block and column:
    ``kernel_tolerance``'s derivation per 128-row block
    (``|acc − z| <= u·|z|``, u = 2^-8; with c = z − s:
    |Δ(c)| <= u|z| and |Δ(c²)| <= 2u|c||z| + u²z²) summed over the
    block, plus 1e-5 of the block's sum of |c| (resp. c²) and 1e-6 for
    the float32 summation orders. The mean and variance checks average
    over all M rows, where one wrong block of M/128 hides; this check sees
    each block. Returns the (2, M/128, N) tolerance of ``parts``."""
    m, n = z.shape
    u = 2.0 ** -8
    zf = z.float().reshape(m // BLOCK_M, BLOCK_M, n)
    c = zf - stat_shift.float()
    az = zf.abs()
    sum_tol = (u * az + 1e-5 * c.abs()).sum(1)
    sq_tol = (2 * u * c.abs() * az + u * u * az * az + 1e-5 * c * c).sum(1)
    return torch.stack((sum_tol, sq_tol)) + 1e-6


class _FusedMatmulBN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, w, stat_shift, prologue, relu):
        z, mean, var = exec_op("fused_bn_matmul_stats", x, a, b, w,
                               stat_shift, relu=relu, fuse_prologue=prologue)
        ctx.save_for_backward(x, a, b, w, z, mean)
        ctx.prologue, ctx.relu = prologue, relu
        ctx.set_materialize_grads(False)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, dmean, dvar):
        x, a, b, w, z, mean = ctx.saved_tensors
        m = x.shape[0]
        # fold the stats cotangents into dz: d mean/dz = 1/M,
        # d var/dz = 2(z - mean)/M per column
        dz_eff = (torch.zeros(z.shape, dtype=torch.float32, device=z.device)
                  if dz is None else dz.float())
        if dmean is not None:
            dz_eff = dz_eff + dmean / m
        if dvar is not None:
            dz_eff = dz_eff + dvar * (2.0 / m) * (z.float() - mean)
        if ctx.prologue:
            u = x.float() * a.float() + b.float()
            y = torch.clamp_min(u, 0.0) if ctx.relu else u
            yl = y.to(x.dtype)
        else:
            yl = x
        dzl = dz_eff.to(x.dtype)
        dw = _dot(yl.t(), dzl).to(w.dtype)
        dy = _dot(dzl, w.t())
        if not ctx.prologue:
            return dy.to(x.dtype), None, None, dw, None, None, None
        du = torch.where(u > 0, dy, torch.zeros_like(dy)) if ctx.relu else dy
        da = torch.sum(du * x.float(), dim=0).to(a.dtype)
        db = torch.sum(du, dim=0).to(b.dtype)
        dx = (du * a.float()).to(x.dtype)
        return dx, da, db, dw, None, None, None


def fused_matmul_bn(x, a, b, w, stat_shift, prologue: bool, relu: bool):
    """Differentiable [affine+relu] → matmul → shifted BN statistics:
    ``(z, mean, var)``. The forward runs the ``fused_bn_matmul_stats`` op
    (the CUDA kernel where its gate takes the shape); ``stat_shift`` only
    stabilizes the moments and gets no gradient."""
    return _FusedMatmulBN.apply(x, a, b, w, stat_shift.detach(), prologue,
                                relu)


def register_platform_convbn() -> None:
    """Install the kernel as the ``"cuda"`` helper of
    fused_bn_matmul_stats."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "cuda" not in reg.get("fused_bn_matmul_stats").platform_impls:
        reg.register_platform("fused_bn_matmul_stats", "cuda",
                              bn_matmul_stats, bn_matmul_stats_usable)
