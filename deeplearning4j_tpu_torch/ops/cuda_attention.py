"""Hand-written CUDA attention kernels for the serving path, and their
plain PyTorch versions.

Counterpart of ``deeplearning4j_tpu/ops/pallas_attention.py`` for the two
kernels generative serving reaches:

* :func:`flash_attention` — causal/masked FlashAttention-2 forward over
  ``(BH, T, D)`` tensors, returning ``(out, lse)`` as ``_flash_fwd`` does
  (``csrc/flash_attn_fwd.cu``, replacing ``_attn_kernel``). Forward only,
  dropout rate 0: dropout and the backward come with the training slice.
* :func:`paged_decode_attention` — one query per slot against the
  block-paged KV cache (``csrc/paged_decode.cu``, replacing
  ``_paged_decode_kernel``), the contract of ``paged_decode_attention_xla``.

Beside each wrapper stands its plain PyTorch version
(:func:`flash_attention_reference`, :func:`paged_decode_attention_reference`,
the counterparts of ``_reference_attention`` and
``paged_decode_attention_xla``). A wrapper given CPU tensors computes the
plain version; given CUDA tensors it launches its kernel or raises — it
never falls back. Each wrapper counts its launches in ``.launches``.

:func:`register_platform_attention` installs both kernels under the
``"cuda"`` platform of the op registry, behind usable gates that mirror
the JAX package's ``usable`` / ``_paged_usable`` without the TPU-measured
``flash_min_t`` crossover: on the card every prefill the JAX gate would
send to its kernel launches this one. Both kernels take float32,
bfloat16 and float16 and every head dim the JAX gates take (a multiple
of 8) up to :data:`MAX_HEAD_DIM`; past that the wrappers raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from deeplearning4j_tpu_torch.ops import _build

# both kernels take every head dim D with D % 8 == 0 up to this
MAX_HEAD_DIM = 256
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MASKED = -1e30  # the kernels' (and the TPU kernels') mask fill

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FLASH_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P)
_PAGED_ARGS = (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P)


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
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with "
                           f"cudaError_t {rc}")


# ---------------------------------------------------------------------------
# flash attention forward
# ---------------------------------------------------------------------------


def flash_attention_reference(q, k, v, kv_mask=None, *,
                              scale: Optional[float] = None,
                              causal: bool = False
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`flash_attention`: the O(T^2) materialized
    softmax in float32 (``_reference_attention``'s math, -1e30 mask fill,
    causal aligned as the kernel is for ``t_q == t_kv``). Returns
    ``(out in q's dtype, lse float32)``."""
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        s = s.masked_fill(kv_mask.reshape(bh, 1, t_k) <= 0.5, _MASKED)
    if causal:
        tri = torch.ones((t_q, t_k), dtype=torch.bool,
                         device=q.device).tril(diagonal=t_k - t_q)
        s = s.masked_fill(~tri, _MASKED)
    lse = torch.logsumexp(s, dim=-1)
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.to(q.dtype), lse


def flash_attention(q, k, v, kv_mask=None, *, scale: Optional[float] = None,
                    causal: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise attention forward over ``(BH, T, D)`` tensors.

    ``kv_mask``: optional ``(BH, T_kv)`` 0/1 key-padding mask (1 = attend).
    ``causal``: start-aligned causal mask; requires ``t_q == t_kv`` (the
    only case where it agrees with the generic op's end-aligned mask).
    Returns ``(out (BH, Tq, D) in q's dtype, lse (BH, Tq) float32)``."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal flash attention requires t_q == t_kv, got "
                         f"{q.shape[1]} vs {k.shape[1]}")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, kv_mask, scale=scale,
                                         causal=causal)
    _require(q.device.type == "cuda",
             f"flash_attention: unsupported device {q.device}")
    _require(q.ndim == 3 and k.ndim == 3 and v.ndim == 3,
             "flash_attention: q, k, v must be (BH, T, D)")
    bh, t_q, d = q.shape
    t_k = k.shape[1]
    _require(k.shape == (bh, t_k, d) and v.shape == (bh, t_k, d),
             f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, "
             f"{tuple(v.shape)} disagree")
    _require(q.dtype in _DTYPE_CODES and k.dtype == q.dtype
             and v.dtype == q.dtype,
             f"flash_attention: dtypes must be one of float32/bfloat16/"
             f"float16 and agree, got {q.dtype}, {k.dtype}, {v.dtype}")
    _require_head_dim(d, "flash_attention")
    _require(all(t.device == q.device and t.is_contiguous()
                 for t in (k, v, q)),
             "flash_attention: q, k, v must be contiguous on one device")
    if kv_mask is not None:
        kv_mask = kv_mask.reshape(bh, t_k).to(torch.float32).contiguous()
        _require(kv_mask.device == q.device,
                 "flash_attention: kv_mask on another device")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    lse = torch.empty((bh, t_q), dtype=torch.float32, device=q.device)
    fn = _build.kernel_fn("flash_attn_fwd", "dl4j_flash_attn_fwd",
                          _FLASH_ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if kv_mask is None else kv_mask.data_ptr(),
            out.data_ptr(), lse.data_ptr(), bh, t_q, t_k, d, float(scale),
            int(bool(causal)), _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(rc, "flash_attn_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


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


def paged_decode_attention(q, k_pages, v_pages, page_table, seq_lens, *,
                           scale: Optional[float] = None):
    """Decode-step attention: ``q (S, H, D)``, ``k/v_pages (P, page, H,
    D)``, ``page_table (S, max_pages)``, ``seq_lens (S,)`` -> ``(S, H, D)``.
    The indices are taken as int32, as ``_paged_decode_call`` casts them
    (no copy when they already are). The pages are read in place:
    ``k_pages``/``v_pages`` may be views of the engine's whole cache
    (``kv[layer, 0]``), and are never copied."""
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
             "kernel reads them in 16-byte vectors)")
    _require(all(t.device == q.device and t.is_contiguous()
                 for t in (q, k_pages, v_pages, page_table, seq_lens)),
             "paged_decode_attention: inputs must be contiguous on one "
             "device")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.kernel_fn("paged_decode", "dl4j_paged_decode", _PAGED_ARGS)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            s_n, h, d, page, max_pages, n_pages, float(scale),
            _DTYPE_CODES[q.dtype], _stream(q))
    _check_launch(rc, "paged_decode")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0

# kernel name (= csrc source stem) -> wrapper holding its launch count
KERNELS = {"flash_attn_fwd": flash_attention,
           "paged_decode": paged_decode_attention}


def reset_launch_counts() -> None:
    for w in KERNELS.values():
        w.launches = 0


def launch_counts() -> dict:
    return {name: w.launches for name, w in KERNELS.items()}


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
    CUDA tensors, and no dropout (not in the kernel yet; it comes with the
    training slice). Limits of the kernel that the JAX gate does not have
    (dtype, head dim above :data:`MAX_HEAD_DIM`) are not checked here:
    :func:`flash_attention` raises on them instead of the op quietly
    running its plain version."""
    if dropout_rate or not _on_cuda(q, k, v):
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
    return mask_ok and q.shape[-1] % 8 == 0


def flash_dpa(q, k, v, mask=None, *, scaled: bool = True,
              causal: bool = False, dropout_rate: float = 0.0,
              dropout_rng=None):
    """``dot_product_attention`` through the flash kernel: folds
    ``(B, H, T, D)`` to ``(B*H, T, D)`` and the ``(B, 1, 1, Tk)`` key mask
    to ``(B*H, Tk)``."""
    if dropout_rate:
        raise ValueError("flash_dpa: the CUDA flash kernel has no dropout")
    scale = (1.0 / math.sqrt(q.shape[-1])) if scaled else 1.0
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
            v.reshape(b * h, tk, d).contiguous(), m, scale=scale,
            causal=causal)
        return out.reshape(b, h, t, d)
    m = None if mask is None else mask.reshape(q.shape[0], k.shape[1])
    out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             m, scale=scale, causal=causal)
    return out


def paged_usable(q, k_pages, v_pages, page_table, seq_lens, **kw) -> bool:
    """Gate of the paged helper: the JAX ``_paged_usable`` on CUDA tensors
    — documented ranks, head dim and page size multiples of 8. Its tuned
    ``min_pages`` is a TPU measurement (default 1: always) and is left
    out, as ``flash_min_t`` is. Limits of the kernel that the JAX gate does
    not have (dtype, head dim above :data:`MAX_HEAD_DIM`) are not checked
    here: :func:`paged_decode_attention` raises on them."""
    if not _on_cuda(q, k_pages, v_pages, page_table, seq_lens):
        return False
    if q.ndim != 3 or k_pages.ndim != 4:
        return False
    if page_table.ndim != 2 or seq_lens.ndim != 1:
        return False
    return q.shape[-1] % 8 == 0 and k_pages.shape[1] % 8 == 0


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
