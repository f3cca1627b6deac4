"""How the tensor-core flash kernels are held against their plain versions.

The plain versions (``ops/cuda_attention.py``) keep P and dS in float32.
The TPU kernels do not: ``pallas_attention.py`` ``_mm`` casts the float32
operand of a mixed product down to the input dtype, so the forward rounds
p before ``p @ v``, dk/dv round ``scale·ds`` and ``p̃`` before ``dsᵀ·q``
and ``p̃ᵀ·dO``, and dq rounds the unscaled ``ds`` before ``ds @ k`` (the
scale multiplies the float32 sum afterwards). The ``"sm90"`` kernels
(:func:`~deeplearning4j_tpu_torch.ops.cuda_attention.flash_design`) do the
same: P and dS become the 16-bit A operand of a wgmma. Their check against
the plain version therefore adds, per output element, the rounding of that
operand:

* out: ``|kernel - plain| <= ATOL + RTOL·|plain| + u·(|P̃|·|V|)``;
* dv:  the same with ``u·(|P̃ᵀ|·|dO|)``;
* dk:  the same with ``u·scale·(|dSᵀ|·|Q|)``;
* dq:  the same with ``u·scale·(|dS|·|K|)``;

where ``|A|·|B|`` is the product of the plain version's absolute values in
float32 and ``u`` is :data:`ROUNDING`: the dtype's unit roundoff (2^-8 in
bfloat16, 2^-11 in float16) with a margin of 2. The term is 0 for the
``"simt"`` kernels, whose check does not change.

:func:`forward_variant`, :func:`dkv_variant` and :func:`dq_variant` are
plain versions that can round those operands as the kernels do (which must
pass the bound) or carry one fault of the kind the redesign could bring
(which must fail it): the keep mask shifted by one key column, the last
streamed tile dropped, and — in the forward — the rescale of the running
sums skipped for one tile.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import cuda_attention as ca

# u: twice the unit roundoff of the rounded operand's dtype
ROUNDING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
# the kernels' tiles: keys per forward and dq tile, queries per dk/dv tile
FORWARD_TILE = 64
DKV_TILE = 64
DQ_TILE = 64
FAULTS = ("keep_shifted", "last_tile_dropped", "rescale_skipped")
DKV_FAULTS = ("keep_shifted", "last_tile_dropped")
DQ_FAULTS = ("keep_shifted", "last_tile_dropped")


def rounding_unit(dtype: torch.dtype, design: str) -> float:
    """``u`` of the check: :data:`ROUNDING` for the ``"sm90"`` design, 0
    for ``"simt"``."""
    return ROUNDING[dtype] if design == "sm90" else 0.0


def _keep(seed, shape, rate: float, shift: int, device) -> torch.Tensor:
    bh, t_q, t_k = shape
    return ca.keep_mask(seed.reshape(-1)[0],
                        torch.arange(bh, device=device)[:, None, None],
                        torch.arange(t_q, device=device)[None, :, None],
                        torch.arange(t_k, device=device)[None, None, :]
                        + shift, rate)


def _drop(x, keep, rate: float) -> torch.Tensor:
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def forward_slack(q, k, v, kv_mask=None, seed=None, *, scale: float,
                  causal: bool = False, dropout_rate: float = 0.0,
                  unit: float) -> torch.Tensor:
    """``unit·(|P̃|·|V|)`` (BH, Tq, D) in float32, P̃ the plain version's
    dropped, normalized probabilities."""
    if unit == 0.0:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    p = torch.softmax(ca._scores(q, k, kv_mask, scale, causal), dim=-1)
    pt = ca._dropped(p, seed, dropout_rate)
    return unit * torch.matmul(pt.abs(), v.float().abs())


def dkv_slack(q, k, v, kv_mask, seed, dout, lse, delta, *, scale: float,
              causal: bool = False, dropout_rate: float = 0.0,
              unit: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(unit·scale·(|dSᵀ|·|Q|), unit·(|P̃ᵀ|·|dO|))`` in float32, from the
    plain version's terms."""
    if unit == 0.0:
        z = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        return z, z
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    _, pt, ds = ca._bwd_terms(q, k, v, kv_mask, seed, dout, lse, delta,
                              scale, causal, dropout_rate)
    dk = unit * scale * torch.matmul(ds.abs().transpose(-1, -2),
                                     q.float().abs())
    dv = unit * torch.matmul(pt.abs().transpose(-1, -2), dout.float().abs())
    return dk, dv


def dq_slack(q, k, v, kv_mask, seed, dout, lse, delta, *, scale: float,
             causal: bool = False, dropout_rate: float = 0.0,
             unit: float) -> torch.Tensor:
    """``unit·scale·(|dS|·|K|)`` (BH, Tq, D) in float32, from the plain
    version's float32 dS (unscaled, as the kernels round it)."""
    if unit == 0.0:
        return torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    _, _, ds = ca._bwd_terms(q, k, v, kv_mask, seed, dout, lse, delta,
                             scale, causal, dropout_rate)
    return unit * scale * torch.matmul(ds.abs(), k.float().abs())


def excess(got, ref, slack, atol: float, rtol: float) -> Tuple[float, float]:
    """(max |got - ref|, the largest share of the bound ``atol + rtol·|ref|
    + slack`` any element uses): the check passes at a share <= 1."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    lim = atol + rtol * ref.abs() + slack
    return err.max().item(), (err / lim).max().item()


def forward_variant(q, k, v, kv_mask=None, seed=None, *,
                    scale: Optional[float] = None, causal: bool = False,
                    dropout_rate: float = 0.0,
                    round_to: Optional[torch.dtype] = None,
                    fault: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward computed tile by tile as the kernels do (online
    softmax over tiles of :data:`FORWARD_TILE` keys, the denominator taking
    the un-dropped p). ``round_to`` rounds each tile's P̃ to that dtype
    before P̃·V, as the sm90 kernel does; ``fault`` is one of
    :data:`FAULTS`. Returns ``(out in q's dtype, lse)``."""
    assert fault is None or fault in FAULTS, fault
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    s = ca._scores(q, k, kv_mask, scale, causal)
    bh, t_q, t_k = s.shape
    keep = None
    if dropout_rate > 0.0:
        keep = _keep(seed, s.shape, dropout_rate,
                     1 if fault == "keep_shifted" else 0, q.device)
    vf = v.float()
    m = torch.full((bh, t_q), -math.inf, device=q.device)
    l = torch.zeros((bh, t_q), device=q.device)
    acc = torch.zeros((bh, t_q, q.shape[-1]), device=q.device)
    n_tiles = -(-t_k // FORWARD_TILE)
    if fault == "last_tile_dropped":
        n_tiles -= 1
    for j in range(n_tiles):
        cols = slice(j * FORWARD_TILE, (j + 1) * FORWARD_TILE)
        sj = s[..., cols]
        m_new = torch.maximum(m, sj.amax(-1))
        alpha = torch.exp(m - m_new)
        if fault == "rescale_skipped" and j == 1:
            alpha = torch.ones_like(alpha)
        p = torch.exp(sj - m_new[..., None])
        l = l * alpha + p.sum(-1)
        p = _drop(p, None if keep is None else keep[..., cols], dropout_rate)
        if round_to is not None:
            p = p.to(round_to).float()
        acc = acc * alpha[..., None] + torch.matmul(p, vf[:, cols])
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def dkv_variant(q, k, v, kv_mask, seed, dout, lse, delta, *, scale: float,
                causal: bool = False, dropout_rate: float = 0.0,
                round_to: Optional[torch.dtype] = None,
                fault: Optional[str] = None,
                tile: int = DKV_TILE) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain dk/dv with ``scale`` folded into dS before the product, as
    the TPU and sm90 kernels do. ``round_to`` rounds P̃ and dS to that dtype
    before ``P̃ᵀ·dO`` and ``dSᵀ·Q``; ``fault`` is one of
    :data:`DKV_FAULTS` (the last streamed tile is the last ``tile``
    queries: :data:`DKV_TILE` for the sm90 kernel, 32 for the float32 one).
    Returns ``(dk, dv)`` in k's and v's dtypes."""
    assert fault is None or fault in DKV_FAULTS, fault
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    p = torch.exp(ca._scores(q, k, kv_mask, scale, causal) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    keep = None
    if dropout_rate > 0.0:
        keep = _keep(seed, p.shape, dropout_rate,
                     1 if fault == "keep_shifted" else 0, q.device)
    pt = _drop(p, keep, dropout_rate)
    ds = p * (_drop(dp, keep, dropout_rate) - delta[..., None]) * scale
    if fault == "last_tile_dropped":
        t_q = q.shape[1]
        first = (t_q - 1) // tile * tile
        pt, ds = pt.clone(), ds.clone()
        pt[:, first:] = 0.0
        ds[:, first:] = 0.0
    if round_to is not None:
        pt, ds = pt.to(round_to).float(), ds.to(round_to).float()
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(pt.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def dq_variant(q, k, v, kv_mask, seed, dout, lse, delta, *, scale: float,
               causal: bool = False, dropout_rate: float = 0.0,
               round_to: Optional[torch.dtype] = None,
               fault: Optional[str] = None,
               tile: int = DQ_TILE) -> torch.Tensor:
    """The plain dq with dS rounded, unscaled, to ``round_to`` before
    ``dS·K`` and the scale applied to the float32 sum, as the TPU and sm90
    kernels do; ``fault`` is one of :data:`DQ_FAULTS` (the last streamed
    tile is the last ``tile`` keys: :data:`DQ_TILE` for the sm90 kernel,
    32 for the float32 one). Returns dq in q's dtype."""
    assert fault is None or fault in DQ_FAULTS, fault
    seed = ca._norm_seed(seed, dropout_rate, q.device)
    p = torch.exp(ca._scores(q, k, kv_mask, scale, causal) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    keep = None
    if dropout_rate > 0.0:
        keep = _keep(seed, p.shape, dropout_rate,
                     1 if fault == "keep_shifted" else 0, q.device)
    ds = p * (_drop(dp, keep, dropout_rate) - delta[..., None])
    if fault == "last_tile_dropped":
        t_k = k.shape[1]
        ds = ds.clone()
        ds[..., (t_k - 1) // tile * tile:] = 0.0
    if round_to is not None:
        ds = ds.to(round_to).float()
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)
