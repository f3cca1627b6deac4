"""Hand-written CUDA attention kernels, and their plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py``:

* :func:`flash_attention` — FlashAttention-2 over ``(BH, T, D)`` tensors
  with a key mask, start-aligned causal masking and in-kernel attention
  dropout, returning ``(out, lse)`` as ``_flash_fwd`` does. It is
  differentiable: :class:`FlashAttentionFn` is the counterpart of the JAX
  ``flash_attention`` custom VJP. On the card its forward launches
  ``_attn_kernel``'s counterpart and its backward :func:`flash_attention_dq`
  and :func:`flash_attention_dkv` (``_dq_kernel``'s and ``_dkv_kernel``'s).
  :func:`flash_design` picks each kernel's source by dtype and head dim:
  bfloat16 and float16 with D <= 128 take the tensor-core kernels
  ``csrc/flash_attn_fwd_sm90.cu``, ``csrc/flash_attn_dq_sm90.cu`` and
  ``csrc/flash_attn_dkv_sm90.cu`` (``"sm90"``); the float32 forward with
  D <= 128 and the float32 dq and dk/dv with D <= 64 take
  ``csrc/flash_attn_fwd_f32_sm90.cu``, ``csrc/flash_attn_dq_f32_sm90.cu``
  and ``csrc/flash_attn_dkv_f32_sm90.cu`` (``"sm90_f32"``: every product
  split into TF32 parts, accurate to float32); the rest the CUDA-core
  kernels ``csrc/flash_attn_fwd.cu`` and ``csrc/flash_attn_bwd.cu``
  (``"simt"``).
* :func:`keep_mask` — the dropout keep mask, ``_keep_mask``'s hash bit for
  bit, so the plain versions drop exactly what the kernels (and the TPU
  kernels) drop for the same seed.
* :func:`paged_decode_attention` — one query per slot against the
  block-paged KV cache (``csrc/paged_decode.cu``, replacing
  ``_paged_decode_kernel``), the contract of ``paged_decode_attention_xla``:
  split-KV over the slot's pages by the plan of :func:`paged_plan`, the
  splits combined in the same launch.

Beside each kernel wrapper stands its plain PyTorch version
(:func:`flash_attention_reference`, :func:`flash_attention_dq_reference`,
:func:`flash_attention_dkv_reference`,
:func:`paged_decode_attention_reference`). A wrapper given CPU tensors
computes the plain version; given CUDA tensors it launches its kernel or
raises — it never falls back. Each kernel's launches are counted on its
wrapper's ``.launches`` (the forward's on :func:`flash_attention`); the
16-bit tensor-core designs' also on ``.sm90_launches`` of the same
wrappers, the float32 ones' on ``.sm90_f32_launches``.

:func:`register_platform_attention` installs the kernels under the
``"cuda"`` platform of the op registry, behind usable gates that mirror
the JAX package's ``usable`` / ``_paged_usable`` without the TPU-measured
``flash_min_t`` crossover: on the card every call the JAX gate would send
to its kernel launches this one, dropout included. The kernels take
float32, bfloat16 and float16 and every head dim the JAX gates take (a
multiple of 8) up to :data:`MAX_HEAD_DIM`; past that the gates refuse and
the op runs its plain version (the wrappers, called directly, raise).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import _build

# every kernel takes every head dim D with D % 8 == 0 up to this
MAX_HEAD_DIM = 256
# the tensor-core forward, dq and dk/dv take 16-bit inputs, and the
# float32 tensor-core forward float32 ones, up to this head dim
SM90_MAX_HEAD_DIM = 128
# the float32 tensor-core dq and dk/dv up to this one: at D 128 their
# float32 operands in two parts do not fit a block's shared memory at the
# tiles the 64-dim kernels use
SM90_F32_BWD_MAX_HEAD_DIM = 64
_SM90_DTYPES = (torch.bfloat16, torch.float16)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASKED = -1e30  # the kernels' (and the TPU kernels') mask fill
_U32 = 0xFFFFFFFF

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# q k v mask out lse | bh tq tk d scale causal | seed rate inv_keep dtype st
_FLASH_ARGS = (_P,) * 6 + (_I,) * 4 + (_F, _I, _P, _F, _F, _I, _P)
# q k v mask dout lse delta seed dq | bh tq tk d scale causal | rate ...
_DQ_ARGS = (_P,) * 9 + (_I,) * 4 + (_F, _I, _F, _F, _I, _P)
# ... seed dk dv | bh tq tk d scale causal | rate inv_keep dtype stream
_DKV_ARGS = (_P,) * 10 + (_I,) * 4 + (_F, _I, _F, _F, _I, _P)
# q k v mask vt out lse | bh tq tk d scale causal | seed rate inv_keep stream
_FLASH_F32_ARGS = (_P,) * 7 + (_I,) * 4 + (_F, _I, _P, _F, _F, _P)
# q k v pt sl out ws counters | S H D page max_pages num_pages | scale |
# tp hb nst pps dtype | stream
_PAGED_ARGS = (_P,) * 8 + (_I,) * 6 + (_F,) + (_I,) * 5 + (_P,)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _require_head_dim(d: int, kernel: str) -> None:
    _require(d % 8 == 0 and 0 < d <= MAX_HEAD_DIM,
             f"{kernel}: head dim {d} is not a multiple of 8 in "
             f"[8, {MAX_HEAD_DIM}], the head dims the kernel is built for")


def _check_launch(rc: int, kernel: str) -> None:
    if rc == -1:
        raise ValueError(f"{kernel}: unsupported dtype or head dim")
    if rc == -2:
        raise RuntimeError(f"{kernel}: cuTensorMapEncodeTiled refused a "
                           f"tensor map (or libcuda does not export it)")
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {rc}")


# ---------------------------------------------------------------------------
# attention dropout: the keep mask
# ---------------------------------------------------------------------------


def keep_mask(seed, bh, rows, cols, rate: float) -> torch.Tensor:
    """True where attention probability ``(rows, cols)`` of batch·head
    ``bh`` survives dropout at ``rate`` — ``_keep_mask``'s counter-based
    hash of ``(seed, bh, absolute row, absolute column)``, bit for bit.

    The TPU computes it in int32 arithmetic that wraps, with logical right
    shifts; here it runs in int64 holding the unsigned 32-bit value, cut
    to 32 bits after every add and multiply. The uniform ``(h & 0xFFFFFF)
    · 2^-24`` is compared with the rate in float32, as there. Arguments
    are ints or integer tensors that broadcast together (``seed`` may be
    the kernels' int32 device tensor)."""
    dev = next((a.device for a in (seed, bh, rows, cols)
                if isinstance(a, torch.Tensor)), None)

    def u32(x):
        return torch.as_tensor(x, device=dev).to(torch.int64) & _U32

    h = u32(seed)
    h = (h + (u32(bh) * 7919 & _U32)) & _U32
    h = (h + (u32(rows) * 1103515245 & _U32)) & _U32
    h = (h + (u32(cols) * 1299709 & _U32)) & _U32
    h = h ^ (h >> 13)
    h = (h * 1274126177) & _U32
    h = h ^ (h >> 16)
    u = (h & 0xFFFFFF).to(torch.float32) * (1.0 / (1 << 24))
    # the float32 rate as a Python float (exact in both): no host tensor
    return u >= float(np.float32(rate))


def _tile_keep(seed, bh: int, t_q: int, t_k: int, rate: float, device):
    """The (BH, Tq, Tk) keep mask of a whole attention call."""
    return keep_mask(seed.reshape(-1)[0],
                     torch.arange(bh, device=device)[:, None, None],
                     torch.arange(t_q, device=device)[None, :, None],
                     torch.arange(t_k, device=device)[None, None, :], rate)


def _norm_seed(seed, dropout_rate: float, device) -> Optional[torch.Tensor]:
    """The kernels' seed: one int32 on ``device`` (``_norm_seed``), None at
    rate 0."""
    if dropout_rate <= 0.0:
        return None
    if seed is None:
        raise ValueError("flash attention dropout_rate > 0 needs a seed")
    seed = torch.as_tensor(seed, device=device)
    return seed.reshape(-1)[:1].to(device=device,
                                   dtype=torch.int32).contiguous()


def rng_to_seed(rng: torch.Generator) -> torch.Tensor:
    """One int32 kernel seed drawn from ``rng`` on the generator's device
    (the counterpart of ``rng_to_seed``): a device draw, so the host does
    not wait for the card."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,), generator=rng,
                         device=rng.device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# flash attention: plain versions
# ---------------------------------------------------------------------------


def _scores(q, k, kv_mask, scale: float, causal: bool) -> torch.Tensor:
    """float32 scaled scores, -1e30 where masked (key mask; causal aligned
    as the kernels are for ``t_q == t_kv``)."""
    bh, t_q, _ = q.shape
    t_k = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(kv_mask.reshape(bh, 1, t_k) <= 0.5, _MASKED)
    if causal:
        tri = torch.ones((t_q, t_k), dtype=torch.bool,
                         device=q.device).tril(diagonal=t_k - t_q)
        s = s.masked_fill(~tri, _MASKED)
    return s


def _dropped(x, seed, rate: float) -> torch.Tensor:
    """``x`` (BH, Tq, Tk) with the dropped entries 0 and the kept ones
    scaled by 1/(1-rate)."""
    if rate <= 0.0:
        return x
    keep = _tile_keep(seed, x.shape[0], x.shape[1], x.shape[2], rate,
                      x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def flash_attention_reference(q, k, v, kv_mask=None, seed=None, *,
                              scale: Optional[float] = None,
                              causal: bool = False,
                              dropout_rate: float = 0.0
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: the O(T^2) materialized softmax
    in float32 (``_reference_attention``'s math, -1e30 mask fill), then
    dropout of the normalized probabilities by :func:`keep_mask` and
    scaling of the kept ones by 1/(1-rate), as ``_attn_kernel`` does (its
    denominator sums the un-dropped p). Returns ``(out in q's dtype, lse
    float32)``; differentiable by autograd."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seed = _norm_seed(seed, dropout_rate, q.device)
    s = _scores(q, k, kv_mask, scale, causal)
    lse = torch.logsumexp(s, dim=-1)
    p = _dropped(torch.softmax(s, dim=-1), seed, dropout_rate)
    return torch.matmul(p, v.float()).to(q.dtype), lse


def _bwd_terms(q, k, v, kv_mask, seed, dout, lse, delta, scale, causal,
               rate):
    """(p, p after dropout, ds) of the backward, float32 (BH, Tq, Tk)."""
    p = torch.exp(_scores(q, k, kv_mask, scale, causal) - lse[..., None])
    dp = _dropped(torch.matmul(dout.float(), v.float().transpose(-1, -2)),
                  seed, rate)
    return p, _dropped(p, seed, rate), p * (dp - delta[..., None])


def flash_attention_dq_reference(q, k, v, kv_mask, seed, dout, lse, delta,
                                 *, scale: float, causal: bool = False,
                                 dropout_rate: float = 0.0) -> torch.Tensor:
    """Plain version of the dq kernel (``_dq_kernel``): ``p = exp(s -
    lse)``, ``dp = dO·Vᵀ`` dropped and scaled by the forward's keep mask,
    ``ds = p·(dp - Δ)``, ``dq = scale·ds·K``; in q's dtype."""
    seed = _norm_seed(seed, dropout_rate, q.device)
    _, _, ds = _bwd_terms(q, k, v, kv_mask, seed, dout, lse, delta, scale,
                          causal, dropout_rate)
    return (torch.matmul(ds, k.float()) * scale).to(q.dtype)


def flash_attention_dkv_reference(q, k, v, kv_mask, seed, dout, lse, delta,
                                  *, scale: float, causal: bool = False,
                                  dropout_rate: float = 0.0
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dk/dv kernel (``_dkv_kernel``): ``dk =
    scale·dsᵀ·Q``, ``dv = p̃ᵀ·dO`` with p̃ the dropped probabilities; in
    k's and v's dtypes."""
    seed = _norm_seed(seed, dropout_rate, q.device)
    _, pt, ds = _bwd_terms(q, k, v, kv_mask, seed, dout, lse, delta, scale,
                           causal, dropout_rate)
    dk = torch.matmul(ds.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(pt.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(dout, out) -> torch.Tensor:
    """Δ = rowsum(dO·O) in float32, (BH, Tq) — a torch reduction, as the
    JAX ``_flash_bwd`` computes it outside its kernels."""
    return (dout.float() * out.float()).sum(-1)


def flash_attention_backward_reference(q, k, v, kv_mask, seed, out, lse,
                                       dout, *, scale: Optional[float] = None,
                                       causal: bool = False,
                                       dropout_rate: float = 0.0):
    """Plain backward of :func:`flash_attention`: ``(dq, dk, dv)`` from the
    forward's ``out`` and ``lse`` — what ``_flash_bwd`` computes."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    delta = attention_delta(dout, out)
    kw = dict(scale=scale, causal=causal, dropout_rate=dropout_rate)
    dq = flash_attention_dq_reference(q, k, v, kv_mask, seed, dout, lse,
                                      delta, **kw)
    dk, dv = flash_attention_dkv_reference(q, k, v, kv_mask, seed, dout, lse,
                                           delta, **kw)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# flash attention: the kernel wrappers
# ---------------------------------------------------------------------------


FLASH_KERNELS = ("fwd", "dq", "dkv")


def flash_design(dtype: torch.dtype, d: int, kernel: str) -> str:
    """Which design of flash ``kernel`` (``"fwd"``, ``"dq"`` or ``"dkv"``)
    runs ``dtype`` at head dim ``d``: ``"sm90"`` (wgmma products fed by
    TMA, P and dS rounded to the input type in registers) for bfloat16 and
    float16 with D <= 128; ``"sm90_f32"`` (wgmma products, each split into
    TF32 parts: accurate to float32) for the float32 forward with D <= 128
    and the float32 dq and dk/dv with D <= 64
    (:data:`SM90_F32_BWD_MAX_HEAD_DIM`: at D 128 their operands' two parts
    do not fit the kernels' shared memory, and 64 < D <= 128 keeps the CUDA
    cores); ``"simt"`` (CUDA cores in float32) for everything else. A
    static choice, not a fallback: either design raises when its build or
    launch fails. Every design gives keys past the causal diagonal p = 0;
    the plain versions' -1e30 fill gives them p = 1 in a row whose visible
    keys are all masked, the one place where they part."""
    if kernel not in FLASH_KERNELS:
        raise ValueError(f"flash_design: kernel {kernel!r} is not one of "
                         f"{FLASH_KERNELS}")
    if d <= SM90_MAX_HEAD_DIM:
        if dtype in _SM90_DTYPES:
            return "sm90"
        if dtype == torch.float32 and (
                kernel == "fwd" or d <= SM90_F32_BWD_MAX_HEAD_DIM):
            return "sm90_f32"
    return "simt"


def _require_tma_aligned(kernel: str, *ts) -> None:
    _require(all(t.data_ptr() % 16 == 0 for t in ts),
             f"{kernel}: the tensor-core kernel reads its tiles with TMA and "
             f"needs 16-byte aligned q, k, v and dout (the float32 forward: "
             f"q and k)")


def _check_qkv(q, k, v, kernel: str) -> None:
    _require(q.device.type == "cuda",
             f"{kernel}: unsupported device {q.device}")
    _require(q.ndim == 3 and k.ndim == 3 and v.ndim == 3,
             f"{kernel}: q, k, v must be (BH, T, D)")
    bh, _, d = q.shape
    t_k = k.shape[1]
    _require(k.shape == (bh, t_k, d) and v.shape == (bh, t_k, d),
             f"{kernel}: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
             f"{tuple(v.shape)} disagree")
    _require(q.dtype in _DTYPE_CODES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"{kernel}: dtypes must be one of float32/bfloat16/float16 and "
             f"agree, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require_head_dim(d, kernel)
    _require(all(t.device == q.device and t.is_contiguous()
                 for t in (k, v, q)),
             f"{kernel}: q, k, v must be contiguous on one device")


def _kernel_mask(kv_mask, bh: int, t_k: int, device, kernel: str):
    if kv_mask is None:
        return None
    kv_mask = kv_mask.reshape(bh, t_k).to(torch.float32).contiguous()
    _require(kv_mask.device == device, f"{kernel}: kv_mask on another device")
    return kv_mask


def _inv_keep(rate: float) -> float:
    return float(np.float32(1.0) / np.float32(1.0 - rate)) if rate else 0.0


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _flash_fwd(q, k, v, kv_mask, seed, scale: float, causal: bool,
               dropout_rate: float):
    """The forward kernel (CPU tensors: its plain version)."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, seed, scale=scale,
                                         causal=causal,
                                         dropout_rate=dropout_rate)
    _check_qkv(q, k, v, "flash_attn_fwd")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    kv_mask = _kernel_mask(kv_mask, bh, t_k, q.device, "flash_attn_fwd")
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    design = flash_design(q.dtype, d, "fwd")
    kernel = {"sm90": "flash_attn_fwd_sm90",
              "sm90_f32": "flash_attn_fwd_f32_sm90"}.get(design,
                                                         "flash_attn_fwd")
    tail = (float(scale), int(bool(causal)), _ptr(seed), float(dropout_rate),
            _inv_keep(dropout_rate))
    if design == "sm90_f32":
        # TMA reads q and k; the kernel's pre-pass writes Vᵀ (keys rounded
        # up to 8) into this scratch
        _require_tma_aligned(kernel, q, k)
        vt = torch.empty((bh, d, -(-t_k // 8) * 8), dtype=torch.float32,
                         device=q.device)
        fn = _build.kernel_fn(kernel, "dl4j_flash_attn_fwd_f32_sm90",
                              _FLASH_F32_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
                vt.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, t_q, t_k,
                d, *tail, _stream(q))
    else:
        if design == "sm90":
            _require_tma_aligned(kernel, q, k, v)
        fn = _build.kernel_fn(kernel, "dl4j_" + kernel, _FLASH_ARGS)
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
                out.data_ptr(), lse.data_ptr(), bh, t_q, t_k, d, *tail,
                _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(rc, kernel)
    flash_attention.launches += 1
    flash_attention.sm90_launches += int(design == "sm90")
    flash_attention.sm90_f32_launches += int(design == "sm90_f32")
    return out, lse


def _check_bwd(q, k, v, dout, lse, delta, kernel: str) -> None:
    _check_qkv(q, k, v, kernel)
    bh, t_q, _ = q.shape
    _require(dout.shape == q.shape and dout.dtype == q.dtype
             and dout.device == q.device and dout.is_contiguous(),
             f"{kernel}: dout must match q in shape, dtype and device and "
             f"be contiguous")
    for name, t in (("lse", lse), ("delta", delta)):
        _require(t.shape == (bh, t_q) and t.dtype == torch.float32
                 and t.device == q.device and t.is_contiguous(),
                 f"{kernel}: {name} must be a contiguous float32 (BH, Tq) "
                 f"tensor on q's device")


def flash_attention_dq(q, k, v, kv_mask, seed, dout, lse, delta, *,
                       scale: float, causal: bool = False,
                       dropout_rate: float = 0.0) -> torch.Tensor:
    """dq of flash attention (replacing ``_dq_kernel``):
    ``csrc/flash_attn_dq_sm90.cu``, ``csrc/flash_attn_dq_f32_sm90.cu`` or
    ``csrc/flash_attn_bwd.cu`` as :func:`flash_design` says, from the
    forward's lse, ``Δ`` (:func:`attention_delta`) and seed. CPU tensors:
    :func:`flash_attention_dq_reference`."""
    if q.device.type == "cpu":
        return flash_attention_dq_reference(
            q, k, v, kv_mask, seed, dout, lse, delta, scale=scale,
            causal=causal, dropout_rate=dropout_rate)
    _check_bwd(q, k, v, dout, lse, delta, "flash_attn_dq")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    kv_mask = _kernel_mask(kv_mask, bh, t_k, q.device, "flash_attn_dq")
    seed = _norm_seed(seed, dropout_rate, q.device)
    dq = torch.empty_like(q)
    design = flash_design(q.dtype, d, "dq")
    kernel = {"sm90": "flash_attn_dq_sm90",
              "sm90_f32": "flash_attn_dq_f32_sm90"}.get(design,
                                                        "flash_attn_dq")
    if design != "simt":
        _require_tma_aligned(kernel, q, k, v, dout)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(seed),
            dq.data_ptr(), bh, t_q, t_k, d, float(scale), int(bool(causal)),
            float(dropout_rate), _inv_keep(dropout_rate))
    lib = "flash_attn_bwd" if design == "simt" else kernel
    fn = _build.kernel_fn(lib, "dl4j_" + kernel, _DQ_ARGS)
    rc = fn(*args, _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(rc, kernel)
    flash_attention_dq.launches += 1
    flash_attention_dq.sm90_launches += int(design == "sm90")
    flash_attention_dq.sm90_f32_launches += int(design == "sm90_f32")
    return dq


flash_attention_dq.launches = 0
flash_attention_dq.sm90_launches = 0
flash_attention_dq.sm90_f32_launches = 0


def flash_attention_dkv(q, k, v, kv_mask, seed, dout, lse, delta, *,
                        scale: float, causal: bool = False,
                        dropout_rate: float = 0.0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) of flash attention (replacing ``_dkv_kernel``):
    ``csrc/flash_attn_dkv_sm90.cu``, ``csrc/flash_attn_dkv_f32_sm90.cu`` or
    ``csrc/flash_attn_bwd.cu`` as :func:`flash_design` says. CPU tensors:
    :func:`flash_attention_dkv_reference`."""
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(
            q, k, v, kv_mask, seed, dout, lse, delta, scale=scale,
            causal=causal, dropout_rate=dropout_rate)
    _check_bwd(q, k, v, dout, lse, delta, "flash_attn_dkv")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    kv_mask = _kernel_mask(kv_mask, bh, t_k, q.device, "flash_attn_dkv")
    seed = _norm_seed(seed, dropout_rate, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    design = flash_design(q.dtype, d, "dkv")
    kernel = {"sm90": "flash_attn_dkv_sm90",
              "sm90_f32": "flash_attn_dkv_f32_sm90"}.get(design,
                                                         "flash_attn_dkv")
    if design != "simt":
        _require_tma_aligned(kernel, q, k, v, dout)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(kv_mask),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), _ptr(seed),
            dk.data_ptr(), dv.data_ptr(), bh, t_q, t_k, d, float(scale),
            int(bool(causal)), float(dropout_rate), _inv_keep(dropout_rate))
    lib = "flash_attn_bwd" if design == "simt" else kernel
    fn = _build.kernel_fn(lib, "dl4j_" + kernel, _DKV_ARGS)
    rc = fn(*args, _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(rc, kernel)
    flash_attention_dkv.launches += 1
    flash_attention_dkv.sm90_launches += int(design == "sm90")
    flash_attention_dkv.sm90_f32_launches += int(design == "sm90_f32")
    return dk, dv


flash_attention_dkv.launches = 0
flash_attention_dkv.sm90_launches = 0
flash_attention_dkv.sm90_f32_launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention — the counterpart of the JAX
    ``flash_attention`` ``custom_vjp`` (``_fwd``/``_bwd``). The forward
    saves q, k, v, the mask, the seed, out and lse; the backward computes
    Δ with torch and runs the dq and dk/dv kernels (their plain versions on
    CPU tensors, or everywhere when ``plain``). lse is returned but not
    differentiated."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, scale, causal, dropout_rate,
                plain):
        if plain:
            out, lse = flash_attention_reference(
                q, k, v, kv_mask, seed, scale=scale, causal=causal,
                dropout_rate=dropout_rate)
        else:
            out, lse = _flash_fwd(q, k, v, kv_mask, seed, scale, causal,
                                  dropout_rate)
        ctx.save_for_backward(q, k, v, kv_mask, seed, out, lse)
        ctx.config = (scale, causal, dropout_rate, plain)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kv_mask, seed, out, lse = ctx.saved_tensors
        scale, causal, rate, plain = ctx.config
        dout = dout.contiguous()
        delta = attention_delta(dout, out)
        dq_fn, dkv_fn = ((flash_attention_dq_reference,
                          flash_attention_dkv_reference) if plain else
                         (flash_attention_dq, flash_attention_dkv))
        kw = dict(scale=scale, causal=causal, dropout_rate=rate)
        dq = dq_fn(q, k, v, kv_mask, seed, dout, lse, delta, **kw)
        dk, dv = dkv_fn(q, k, v, kv_mask, seed, dout, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, kv_mask=None, seed=None, *,
                    scale: Optional[float] = None, causal: bool = False,
                    dropout_rate: float = 0.0, plain: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention over ``(BH, T, D)`` tensors, differentiable in
    q, k and v.

    ``kv_mask``: optional ``(BH, T_kv)`` 0/1 key-padding mask (1 = attend).
    ``causal``: start-aligned causal mask; requires ``t_q == t_kv`` (the
    only case where it agrees with the generic op's end-aligned mask).
    ``dropout_rate`` / ``seed``: post-softmax attention dropout inside the
    kernels; the seed is any int or int32 tensor (its first element is
    used) and is required when the rate is above 0. ``plain``: run the
    plain versions even on CUDA tensors (a reference run on the card).
    Returns ``(out (BH, Tq, D) in q's dtype, lse (BH, Tq) float32)``."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention requires t_q == t_kv, got "
                         f"{q.shape[1]} vs {k.shape[1]}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seed = _norm_seed(seed, dropout_rate, q.device)
    return FlashAttentionFn.apply(q, k, v, kv_mask, seed, float(scale),
                                  bool(causal), float(dropout_rate),
                                  bool(plain))


flash_attention.launches = 0
flash_attention.sm90_launches = 0
flash_attention.sm90_f32_launches = 0


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------


def paged_decode_attention_reference(q, k_pages, v_pages, page_table,
                                     seq_lens, *,
                                     scale: Optional[float] = None):
    """Plain version of :func:`paged_decode_attention`
    (``paged_decode_attention_xla``): gather every page-table row, mask
    positions ``>= seq_lens`` with -1e30, softmax in float32. Page ids are
    clamped into range as a JAX gather clamps them."""
    s_n, h, d = q.shape
    page = k_pages.shape[1]
    max_pages = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pt = page_table.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[pt].reshape(s_n, max_pages * page, h, d)
    v = v_pages[pt].reshape(s_n, max_pages * page, h, d)
    s = torch.einsum("shd,sthd->sht", q.float(), k.float()) * scale
    pos = torch.arange(max_pages * page, device=q.device)
    s = s.masked_fill(pos[None, None, :] >= seq_lens[:, None, None].long(),
                      _MASKED)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("sht,sthd->shd", p, v.float()).to(q.dtype)


# paged decode's plan (csrc/paged_decode.cu): one stage of the ring holds a
# K and a V tile of at most PAGED_STAGE_BYTES, the ring at most
# PAGED_RING_BYTES (two blocks an SM); a block owns at most
# PAGED_MAX_HEADS heads (a warp each); splits are sized so that a full
# batch gives PAGED_WAVES blocks an SM.
PAGED_STAGE_BYTES = 48 * 1024
PAGED_RING_BYTES = 96 * 1024
PAGED_MAX_HEADS = 16
PAGED_WAVES = 2


@dataclasses.dataclass(frozen=True)
class PagedPlan:
    """How :func:`paged_decode_attention` cuts one call.

    ``tile`` positions of a page (a divisor of the page) land in shared
    memory per stage, ``heads_per_block`` heads each (``head_groups``
    blocks cover a position's heads), in a ring of ``stages``; a slot's
    sequence is cut into splits of ``pages_per_split`` pages, at most
    ``splits`` of them (a full slot)."""

    tile: int
    heads_per_block: int
    head_groups: int
    stages: int
    pages_per_split: int
    splits: int


def paged_plan(slots: int, heads: int, d: int, page: int, max_pages: int,
               elem_size: int, sms: int) -> PagedPlan:
    """The plan of a call. A tile is the largest run of a page whose K and
    V fit one stage (the whole page where it fits: bfloat16 at GPT-2-small
    width, half of it in float32); where not even 8 positions of every head
    fit, the heads are split over blocks. The split length comes from the
    batch's capacity, ``slots × max_pages`` pages against
    :data:`PAGED_WAVES` × ``sms`` blocks: seq_lens lives on the device,
    and reading it would synchronise the host. Each slot then takes the
    splits its own seq_len fills, on the device."""
    row = d * elem_size  # bytes of one head of one position
    hb = min(heads, PAGED_MAX_HEADS)
    want = min(page, 8)
    if 2 * want * hb * row > PAGED_STAGE_BYTES:
        hb = max(1, PAGED_STAGE_BYTES // (2 * want * row))
    tile = max(t for t in range(1, page + 1)
               if page % t == 0 and 2 * t * hb * row <= PAGED_STAGE_BYTES)
    stage = 2 * tile * hb * row
    stages = max(2, min(4, PAGED_RING_BYTES // stage))
    groups = -(-heads // hb)
    pps = max(1, -(-(slots * max_pages * groups) // (PAGED_WAVES * sms)))
    return PagedPlan(tile=tile, heads_per_block=hb, head_groups=groups,
                     stages=stages, pages_per_split=pps,
                     splits=-(-max_pages // pps))


# per device: the kernel's split counters (zero between calls; the last
# block of a slot resets its own). A buffer outgrown by a larger call is
# kept, never freed: a CUDA graph captured against it keeps its address.
_PAGED_COUNTERS: dict = {}
_PAGED_OUTGROWN: list = []


def _paged_counters(dev: torch.device, n: int) -> torch.Tensor:
    c = _PAGED_COUNTERS.get(dev)
    if c is None or c.numel() < n:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            # a capture's warm-up sized it; made here it would live in the
            # graph's pool and die with the graph
            raise RuntimeError("paged_decode_attention: split counters "
                               "would be allocated inside a CUDA-graph "
                               "capture; run the call once before it")
        if c is not None:
            _PAGED_OUTGROWN.append(c)
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _PAGED_COUNTERS[dev] = c
    return c


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           scale: Optional[float] = None):
    """Decode-step attention: ``q (S, H, D)``, ``k/v_pages (P, page, H,
    D)``, ``page_table (S, max_pages)``, ``seq_lens (S,)`` -> ``(S, H, D)``.
    The indices are taken as int32, as ``_paged_decode_call`` casts them
    (no copy when they already are). The pages are read in place:
    ``k_pages``/``v_pages`` may be views of the engine's whole cache
    (``kv[layer, 0]``), and are never copied. One launch a call: the
    splits of :func:`paged_plan` write partial softmax sums to a workspace
    and the last split of each slot combines them."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, page_table, seq_lens, scale=scale)
    _require(q.device.type == "cuda",
             f"paged_decode_attention: unsupported device {q.device}")
    _require(q.ndim == 3 and k_pages.ndim == 4 and v_pages.ndim == 4
             and page_table.ndim == 2 and seq_lens.ndim == 1,
             "paged_decode_attention: expected q (S,H,D), k/v_pages "
             "(P,page,H,D), page_table (S,max_pages), seq_lens (S,)")
    s_n, h, d = q.shape
    n_pages, page = k_pages.shape[0], k_pages.shape[1]
    max_pages = page_table.shape[1]
    _require(k_pages.shape == (n_pages, page, h, d)
             and v_pages.shape == k_pages.shape,
             f"paged_decode_attention: pages {tuple(k_pages.shape)} / "
             f"{tuple(v_pages.shape)} disagree with q {tuple(q.shape)}")
    _require(page_table.shape[0] == s_n and seq_lens.shape[0] == s_n,
             "paged_decode_attention: page_table/seq_lens slot count")
    _require(q.dtype in _DTYPE_CODES and k_pages.dtype == q.dtype
             and v_pages.dtype == q.dtype,
             f"paged_decode_attention: dtypes must be one of float32/"
             f"bfloat16/float16 and agree, got {q.dtype}, {k_pages.dtype}")
    _require_head_dim(d, "paged_decode_attention")
    page_table = page_table.to(torch.int32)
    seq_lens = seq_lens.to(torch.int32)
    _require(all(t.data_ptr() % 16 == 0 for t in (k_pages, v_pages)),
             "paged_decode_attention: pages must be 16-byte aligned (the "
             "kernel copies them to shared memory in bulk)")
    _require(all(t.device == q.device and t.is_contiguous()
                 for t in (q, k_pages, v_pages, page_table, seq_lens)),
             "paged_decode_attention: inputs must be contiguous on one "
             "device")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if s_n == 0 or max_pages == 0:
        return torch.zeros_like(q)
    plan = paged_plan(s_n, h, d, page, max_pages, q.element_size(),
                      torch.cuda.get_device_properties(
                          q.device).multi_processor_count)
    out = torch.empty_like(q)
    ws = torch.empty(max(1, s_n * plan.splits * h * (d + 2)),
                     dtype=torch.float32, device=q.device)
    counters = _paged_counters(q.device, s_n * plan.head_groups)
    fn = _build.kernel_fn("paged_decode", "dl4j_paged_decode", _PAGED_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            ws.data_ptr(), counters.data_ptr(), s_n, h, d, page, max_pages,
            n_pages, float(scale), plan.tile, plan.heads_per_block,
            plan.stages, plan.pages_per_split, _DTYPE_CODES[q.dtype],
            _stream(q))
    _check_launch(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

# kernel name -> (the function holding its launch count, the attribute).
# flash_attn_fwd, flash_attn_dq and flash_attn_dkv count every launch of
# any design; the _sm90 names count the 16-bit tensor-core design's alone,
# the _f32_sm90 names the float32 one's.
KERNELS = {"flash_attn_fwd": (flash_attention, "launches"),
           "flash_attn_fwd_sm90": (flash_attention, "sm90_launches"),
           "flash_attn_fwd_f32_sm90": (flash_attention, "sm90_f32_launches"),
           "flash_attn_dq": (flash_attention_dq, "launches"),
           "flash_attn_dq_sm90": (flash_attention_dq, "sm90_launches"),
           "flash_attn_dq_f32_sm90": (flash_attention_dq,
                                      "sm90_f32_launches"),
           "flash_attn_dkv": (flash_attention_dkv, "launches"),
           "flash_attn_dkv_sm90": (flash_attention_dkv, "sm90_launches"),
           "flash_attn_dkv_f32_sm90": (flash_attention_dkv,
                                       "sm90_f32_launches"),
           "paged_decode": (paged_decode_attention, "launches")}


def reset_launch_counts() -> None:
    for w, attr in KERNELS.values():
        setattr(w, attr, 0)


def launch_counts() -> dict:
    return {name: getattr(w, attr) for name, (w, attr) in KERNELS.items()}


# ---------------------------------------------------------------------------
# registry: the "cuda" platform helpers
# ---------------------------------------------------------------------------


def _on_cuda(*ts) -> bool:
    return all(isinstance(t, torch.Tensor) and t.device.type == "cuda"
               for t in ts)


def flash_usable(q, k, v, mask=None, *, scaled: bool = True,
                 causal: bool = False, dropout_rate: float = 0.0,
                 dropout_rng=None) -> bool:
    """Gate of the flash helper: the JAX ``usable`` without the
    TPU-measured ``flash_min_t`` crossover — ranks, key-padding-only
    masks, causal only for ``t_q == t_kv``, head dim a multiple of 8 — on
    CUDA tensors. Dropout passes, as it does there (the kernels drop in
    place). A head dim above :data:`MAX_HEAD_DIM`, which the JAX kernel
    takes and these are not built for, is refused: the op runs its plain
    version, counted as a ``not_usable`` generic dispatch. The dtype is not
    checked here: the kernel wrappers raise on one they do not take
    instead of the op quietly running its plain version."""
    if not _on_cuda(q, k, v):
        return False
    if q.ndim == 4:
        t_q, t_kv = q.shape[2], k.shape[2]
        mask_ok = mask is None or (
            mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1
            and mask.shape[-1] == t_kv)
    elif q.ndim == 3:
        t_q, t_kv = q.shape[1], k.shape[1]
        mask_ok = mask is None or (
            mask.ndim in (2, 3) and mask.shape[-1] == t_kv
            and (mask.ndim == 2 or mask.shape[1] == 1))
    else:
        return False
    if causal and t_q != t_kv:
        return False
    return mask_ok and q.shape[-1] % 8 == 0 and q.shape[-1] <= MAX_HEAD_DIM


def flash_dpa(q, k, v, mask=None, *, scaled: bool = True,
              causal: bool = False, dropout_rate: float = 0.0,
              dropout_rng: Optional[torch.Generator] = None,
              plain: bool = False):
    """``dot_product_attention`` through :func:`flash_attention`: folds
    ``(B, H, T, D)`` to ``(B*H, T, D)`` (batch-major, as the JAX
    ``flash_dpa`` does, so the dropout hash sees the same batch·head
    index) and the ``(B, 1, 1, Tk)`` key mask to ``(B*H, Tk)``. With
    dropout, one int32 seed is drawn from ``dropout_rng`` (a
    ``torch.Generator``) on the device. ``plain`` runs the plain versions
    on the card (a reference run); the registry never passes it."""
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError(
            "dot_product_attention: dropout_rate > 0 requires dropout_rng "
            "(pass rate 0 for eval mode)")
    seed = rng_to_seed(dropout_rng) if dropout_rate > 0.0 else None
    kw = dict(scale=(1.0 / math.sqrt(q.shape[-1])) if scaled else 1.0,
              causal=causal, dropout_rate=dropout_rate, plain=plain)
    if q.ndim == 4:
        b, h, t, d = q.shape
        tk = k.shape[2]
        m = None
        if mask is not None:
            m = mask.reshape(b, tk).to(torch.float32).repeat_interleave(
                h, dim=0)
        out, _ = flash_attention(
            q.reshape(b * h, t, d).contiguous(),
            k.reshape(b * h, tk, d).contiguous(),
            v.reshape(b * h, tk, d).contiguous(), m, seed, **kw)
        return out.reshape(b, h, t, d)
    m = None if mask is None else mask.reshape(q.shape[0], k.shape[1])
    out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             m, seed, **kw)
    return out


def paged_usable(q, k_pages, v_pages, page_table, seq_lens, **kw) -> bool:
    """Gate of the paged helper: the JAX ``_paged_usable`` on CUDA tensors
    — documented ranks, head dim and page size multiples of 8. Its tuned
    ``min_pages`` is a TPU measurement (default 1: always) and is left
    out, as ``flash_min_t`` is. A head dim above :data:`MAX_HEAD_DIM` is
    refused, as in :func:`flash_usable`; a dtype the kernel does not take
    is not checked here: :func:`paged_decode_attention` raises on it."""
    if not _on_cuda(q, k_pages, v_pages, page_table, seq_lens):
        return False
    if q.ndim != 3 or k_pages.ndim != 4:
        return False
    if page_table.ndim != 2 or seq_lens.ndim != 1:
        return False
    return (q.shape[-1] % 8 == 0 and q.shape[-1] <= MAX_HEAD_DIM
            and k_pages.shape[1] % 8 == 0)


def register_platform_attention() -> None:
    """Register the paged decode op (plain generic impl + CUDA helper) and
    install flash attention as the CUDA helper of the generic
    ``dot_product_attention`` op."""
    from deeplearning4j_tpu_torch.ops.registry import registry

    reg = registry()
    if "paged_decode_attention" not in reg:
        reg.register(
            "paged_decode_attention", paged_decode_attention_reference,
            doc="decode-step attention over a block-paged KV cache "
                "(q:[S,H,D], k/v_pages:[P,page,H,D], page_table:[S,max_pages],"
                " seq_lens:[S] -> [S,H,D])")
        reg.register_platform("paged_decode_attention", "cuda",
                              paged_decode_attention, paged_usable)
    reg.register_platform("dot_product_attention", "cuda", flash_dpa,
                          flash_usable)
