"""A plain transcription of the float32 tensor-core kernels' arithmetic:
every float32 product as three products of TF32 parts
(``csrc/fused_matmul_f32_sm90.cu``, ``csrc/flash_attn_fwd_f32_sm90.cu``,
``csrc/flash_attn_dq_f32_sm90.cu``, ``csrc/flash_attn_dkv_f32_sm90.cu``;
``csrc/sm90.cuh`` ``tf32_split``).

TF32 keeps float32's sign and exponent and 10 mantissa bits. An operand v
is split as hi = tf32(v) and lo = tf32(v − hi)
(:func:`tf32_split`: half a unit added to the magnitude, then the 13
dropped bits masked off — to nearest, ties away from zero, as ``cvt.rna``
rounds), and a product a·b becomes a_lo·b_hi + a_hi·b_lo +
a_hi·b_hi, each pass summed in float32, the two small passes first. Here a
pass is a float32 matmul of the parts: a product of two TF32 values (11-bit
significands) is exact in float32, and the sums run in the kernels' order
of passes, K slabs and key tiles — not in the tensor cores' order within
one k-step, which no transcription can know.

:data:`PASSES` names the variants: ``"split"`` (the kernels),
``"single"`` (one TF32 pass, hi·hi — a kernel that forgot the split) and
``"lo_dropped"`` (the a_lo·b_hi pass left out). The float32 checks the
kernels are held to (``cuda_matmul.kernel_tolerance``; the flash forward's
:data:`F32_ATOL` and :data:`F32_LSE_TOL`; the backward's ``chip_smoke``
``BWD_ATOL`` and ``BWD_RTOL``) admit the first and refuse the other two.

The register mappings of ``sm90.cuh`` are transcribed as well
(:func:`acc_row`, :func:`acc_col`, :func:`tf32_a_row`, :func:`tf32_a_col`,
:func:`group_key`), so that :func:`register_pv` can compute a product the
way the flash kernels feed it to the tensor cores: an accumulator's
registers as the TF32 A fragment, the B operand's contraction index
permuted within each group of 8 — P·V in the forward, dS·K in dq, P̃ᵀ·dO
and dSᵀ·Q in dk/dv.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_attention as ca
from deeplearning4j_tpu_torch.ops.nn_ops import apply_fused_activation

PASSES = {"split": (("lo", "hi"), ("hi", "lo"), ("hi", "hi")),
          "single": (("hi", "hi"),),
          "lo_dropped": (("hi", "lo"), ("hi", "hi"))}
MATMUL_SLAB = 32   # K values a stage of the fused matmul: one 128-byte span
FLASH_KEYS = 64    # keys a tile of the flash forward at D <= 64 (32 above)
# keys a tile of the float32 dq, and queries a tile of its dk/dv: one
# 128-byte span of the transposed copy (Kᵀ; Qᵀ and dOᵀ)
FLASH_BWD_TILE = 32
# the float32 flash forward's check on the card (chip_smoke ATOL["float32"]
# and TOL_LSE): out within 1e-4 absolute, lse within 1e-4
F32_ATOL = 1e-4
F32_LSE_TOL = 1e-4
_PART = {"hi": 0, "lo": 1}


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 — 10 mantissa bits, to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds — by adding half a
    unit of the 13 dropped bits to the magnitude and clearing them."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor) -> torch.Tensor:
    """``(2, *t.shape)`` float32: hi = ``tf32_round(t)`` and lo =
    ``tf32_round(t - hi)`` (the subtraction is exact) — the parts whose
    three TF32 products lo·hi + hi·lo + hi·hi the sm90_f32 kernels add for
    one float32 product (``cuda_matmul.kmajor_split`` gives a weight's on
    the card)."""
    t = t.float()
    hi = tf32_round(t)
    return torch.stack((hi, tf32_round(t - hi)))


def split_product(a: torch.Tensor, b: torch.Tensor, passes: str = "split",
                  slab: Optional[int] = None) -> torch.Tensor:
    """``a @ b`` in float32 as the kernels form it from TF32 parts: for
    each K slab of ``slab`` values (the whole K when None), each pass of
    :data:`PASSES`\\ [``passes``] added to the float32 sum in turn."""
    pa, pb = tf32_split(a), tf32_split(b)
    k = a.shape[-1]
    step = k if slab is None else slab
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32,
                      device=a.device)
    for k0 in range(0, max(k, 1), max(step, 1)):
        cols = slice(k0, k0 + step)
        for x, y in PASSES[passes]:
            acc = acc + torch.matmul(pa[_PART[x]][..., cols],
                                     pb[_PART[y]][..., cols, :])
    return acc


def fused_matmul_split(x, w, b=None, *, activation: str = "none",
                       passes: str = "split",
                       slab: Optional[int] = MATMUL_SLAB) -> torch.Tensor:
    """act(x @ w + b) as ``csrc/fused_matmul_f32_sm90.cu`` computes it:
    the product from TF32 parts, 32-deep slabs, the float32 bias and
    activation on the sum, float32 out."""
    y = split_product(x.float(), w.float(), passes, slab)
    if b is not None:
        y = y + b.float()
    return apply_fused_activation(y, activation)


def flash_forward_split(q, k, v, kv_mask=None, seed=None, *,
                        scale: Optional[float] = None, causal: bool = False,
                        dropout_rate: float = 0.0, passes: str = "split"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` of the float32 forward as
    ``csrc/flash_attn_fwd_f32_sm90.cu`` computes it: tiles of
    :data:`FLASH_KEYS` keys (32 past D 64), S and P·V from TF32 parts, the
    -1e30 key-mask fill and -inf past Tk and past the causal diagonal, the
    online max and sum (the sum of the un-dropped p), dropout by
    ``keep_mask`` on the unnormalized p, and out / max(l, 1e-30)."""
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    keys = FLASH_KEYS if d <= 64 else FLASH_KEYS // 2
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    bh, t_q, _ = q.shape
    t_k = k.shape[1]
    qf, kf, vf = q.float(), k.float(), v.float()
    rows = torch.arange(t_q, device=q.device)[:, None]
    m = torch.full((bh, t_q), -math.inf, device=q.device)
    l = torch.zeros((bh, t_q), device=q.device)
    o = torch.zeros((bh, t_q, d), device=q.device)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate else 0.0
    for k0 in range(0, t_k, keys):
        cols = torch.arange(k0, min(k0 + keys, t_k), device=q.device)
        s = split_product(qf, kf[:, cols].transpose(-1, -2), passes) * scale
        if kv_mask is not None:
            s = s.masked_fill(kv_mask.reshape(bh, 1, t_k)[..., cols] <= 0.5,
                              ca._MASKED)
        if causal:
            s = s.masked_fill((cols[None, :] > rows)[None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - mu)
        p = torch.exp(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        if dropout_rate:
            keep = ca.keep_mask(seed.reshape(-1)[0],
                                torch.arange(bh, device=q.device)[:, None,
                                                                  None],
                                rows[None], cols[None, None, :],
                                dropout_rate)
            p = torch.where(keep, p * inv_keep, torch.zeros_like(p))
        o = o * alpha[..., None] + split_product(p, vf[:, cols], passes)
        m = m_new
    ls = l.clamp_min(1e-30)
    return o / ls[..., None], m + torch.log(ls)


def _bwd_tile(q, k, v, kv_mask, keep, dout, lse, delta, rows, cols, *,
              scale: float, causal: bool, inv_keep: float, passes: str):
    """(P̃, dS) float32 of the (rows, cols) tile as the float32 backward
    kernels form them: S and dP from TF32 parts, the -1e30 key-mask fill,
    P = exp(S·scale - lse) and 0 past the causal diagonal, dP and P̃
    dropped by ``keep``, dS = P⊙(dP - Δ) unscaled."""
    bh = q.shape[0]
    s = split_product(q[:, rows], k[:, cols].transpose(-1, -2),
                      passes) * scale
    dp = split_product(dout[:, rows], v[:, cols].transpose(-1, -2), passes)
    if kv_mask is not None:
        s = s.masked_fill(kv_mask.reshape(bh, 1, -1)[..., cols] <= 0.5,
                          ca._MASKED)
    p = torch.exp(s - lse[:, rows, None])
    if causal:
        p = p.masked_fill(cols[None, None, :] > rows[None, :, None], 0.0)
    pt = p
    if keep is not None:
        kt = keep[:, rows][..., cols]
        pt = torch.where(kt, p * inv_keep, torch.zeros_like(p))
        dp = torch.where(kt, dp * inv_keep, torch.zeros_like(dp))
    return pt, p * (dp - delta[:, rows, None])


def _bwd_setup(q, k, seed, dropout_rate: float):
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    keep = None
    if dropout_rate:
        keep = ca._tile_keep(seed, q.shape[0], q.shape[1], k.shape[1],
                             dropout_rate, q.device)
    inv_keep = 1.0 / (1.0 - dropout_rate) if dropout_rate else 0.0
    return keep, inv_keep


def flash_dq_split(q, k, v, kv_mask, seed, dout, lse, delta, *,
                   scale: float, causal: bool = False,
                   dropout_rate: float = 0.0,
                   passes: str = "split") -> torch.Tensor:
    """dq of the float32 backward as ``csrc/flash_attn_dq_f32_sm90.cu``
    computes it: tiles of :data:`FLASH_BWD_TILE` keys, S and dP from TF32
    parts, dS float32, each tile's dS·K summed from zero (its passes in
    turn) and added to dq's float32 sum, scaled once at the end."""
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    keep, inv_keep = _bwd_setup(q, k, seed, dropout_rate)
    t_q, t_k = q.shape[1], k.shape[1]
    rows = torch.arange(t_q, device=q.device)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, t_k, FLASH_BWD_TILE):
        cols = torch.arange(k0, min(k0 + FLASH_BWD_TILE, t_k),
                            device=q.device)
        _, ds = _bwd_tile(qf, kf, vf, kv_mask, keep, df, lse, delta, rows,
                          cols, scale=scale, causal=causal,
                          inv_keep=inv_keep, passes=passes)
        acc = acc + split_product(ds, kf[:, cols], passes)
    return acc * scale


def flash_dkv_split(q, k, v, kv_mask, seed, dout, lse, delta, *,
                    scale: float, causal: bool = False,
                    dropout_rate: float = 0.0, passes: str = "split"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of the float32 backward as
    ``csrc/flash_attn_dkv_f32_sm90.cu`` computes them: tiles of
    :data:`FLASH_BWD_TILE` queries, Sᵀ and dPᵀ from TF32 parts, P̃ᵀ and dSᵀ
    float32, each tile's P̃ᵀ·dO and dSᵀ·Q summed from zero (their passes in
    turn) and added to dv's and dk's float32 sums, dk scaled once at the
    end."""
    qf, kf, vf, df = q.float(), k.float(), v.float(), dout.float()
    keep, inv_keep = _bwd_setup(q, k, seed, dropout_rate)
    t_q, t_k = q.shape[1], k.shape[1]
    cols = torch.arange(t_k, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    for i0 in range(0, t_q, FLASH_BWD_TILE):
        rows = torch.arange(i0, min(i0 + FLASH_BWD_TILE, t_q),
                            device=q.device)
        pt, ds = _bwd_tile(qf, kf, vf, kv_mask, keep, df, lse, delta, rows,
                           cols, scale=scale, causal=causal,
                           inv_keep=inv_keep, passes=passes)
        dv = dv + split_product(pt.transpose(-1, -2), df[:, rows], passes)
        dk = dk + split_product(ds.transpose(-1, -2), qf[:, rows], passes)
    return dk * scale, dv


# ------------------------------------------- sm90.cuh's register mappings


def acc_row(i: int, warp: int, lane: int) -> int:
    """Row of float32 accumulator register ``i`` (``sm90::acc_row``)."""
    return 16 * warp + lane // 4 + 8 * ((i >> 1) & 1)


def acc_col(i: int, lane: int) -> int:
    """Column of float32 accumulator register ``i`` (``sm90::acc_col``)."""
    return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)


def tf32_a_row(r: int, warp: int, lane: int) -> int:
    """Row of register ``r`` of a TF32 m64nNk8 A fragment."""
    return 16 * warp + lane // 4 + 8 * (r & 1)


def tf32_a_col(r: int, lane: int) -> int:
    """Column of register ``r`` of a TF32 m64nNk8 A fragment."""
    return lane % 4 + 4 * (r >> 1)


def group_key(p: int) -> int:
    """The row at position ``p`` of the flash kernels' transposed copies
    (Vᵀ, Kᵀ, Qᵀ, dOᵀ): each group of 8 in the order 0, 2, 4, 6, 1, 3, 5, 7
    (``csrc/flash_f32.cuh`` ``group_key``)."""
    return (p & ~7) | ((p & 3) << 1) | ((p >> 2) & 1)


def kernel_a_register(kk: int, r: int) -> int:
    """The accumulator register the flash kernels hand as A register ``r``
    of k-step ``kk``: 4kk, 4kk + 2, 4kk + 1, 4kk + 3."""
    return 4 * kk + (r & 1) * 2 + (r >> 1)


def register_pv(p: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """``(A, A @ B)`` for one warpgroup's 64-row accumulator tile ``p``
    handed over as the A operand of ``p @ v``: A is the matrix the tensor
    cores read when every thread hands its accumulator registers as the
    TF32 A fragment in the kernels' order (:func:`kernel_a_register`), B is
    ``v`` with its rows (the contraction index) in the transposed copy's
    order (:func:`group_key`). ``A @ B`` must be ``p @ v``; A's entries not
    written by any thread stay NaN. P·V (64 queries × keys, V), dS·K (64
    queries × keys, K), P̃ᵀ·dO and dSᵀ·Q (64 keys × queries, dO and Q)
    are all this product."""
    rows, keys = p.shape
    assert rows == 64 and keys % 8 == 0
    a = torch.full_like(p, math.nan)
    for kk in range(keys // 8):
        for warp in range(4):
            for lane in range(32):
                for r in range(4):
                    i = kernel_a_register(kk, r)
                    a[tf32_a_row(r, warp, lane),
                      8 * kk + tf32_a_col(r, lane)] = p[
                          acc_row(i, warp, lane), acc_col(i, lane)]
    b = v[[group_key(j) for j in range(keys)]]
    return a, a @ b
