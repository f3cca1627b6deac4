"""The split-KV paged decode of ``csrc/paged_decode.cu``, transcribed in
torch.

:func:`paged_decode_split` computes what the kernel computes, in its
order: a slot's positions cut into splits of ``pages_per_split`` pages
(:func:`~deeplearning4j_tpu_torch.ops.cuda_attention.paged_plan`), each
split walked in tiles of ``tile`` positions and, inside a tile, 8
positions at a time with the online softmax (running max m, sum l,
accumulator acc per head, float32; the kernel keeps the scores in base 2,
scaled by log2 e, the same function); a slot with one split divides acc by l,
a slot with several combines the splits' (m, l, acc) with the log-sum-exp
rescale. A slot with seq_len 0 gives zeros. Page ids are clamped into
range.

The CPU tests hold it against ``paged_decode_attention_reference`` and the
JAX package's Pallas kernel in interpret mode, and chip_smoke holds the
kernel against the reference on the card. The faulted variants (``fault``)
must break those checks: ``"split_dropped"`` leaves a slot's first split
out of the combine, ``"no_rescale"`` adds the splits' sums without
rescaling them to the common max.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

FAULTS = ("split_dropped", "no_rescale")


def split_bounds(n: int, page: int, pages_per_split: int):
    """[(first position, end)] of the splits of a slot holding ``n``
    positions (one empty split for n = 0, as the kernel's first block)."""
    split_len = pages_per_split * page
    n_splits = max(1, -(-n // split_len))
    return [(j * split_len, min((j + 1) * split_len, n))
            for j in range(n_splits)]


def tile_bounds(lo: int, hi: int, tile: int):
    """[(first position, end)] of the tiles of a split, and inside each the
    8-position groups the kernel scores together."""
    out = []
    for t0 in range(lo, hi, tile):
        np_ = min(tile, hi - t0)
        out.append([(t0 + i0, t0 + min(i0 + 8, np_))
                    for i0 in range(0, np_, 8)])
    return out


def paged_decode_split(q, k_pages, v_pages, page_table, seq_lens, *, plan,
                       scale: Optional[float] = None,
                       fault: Optional[str] = None):
    """The kernel's output for ``plan`` (a ``PagedPlan``), or a faulted
    variant's (``fault`` in :data:`FAULTS`)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; valid: {FAULTS}")
    s_n, h, d = q.shape
    n_pages, page = k_pages.shape[0], k_pages.shape[1]
    max_pages = page_table.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    out = torch.zeros((s_n, h, d), dtype=torch.float32, device=dev)
    for s in range(s_n):
        n = max(0, min(int(seq_lens[s]), max_pages * page))
        if n == 0:
            continue
        pos = torch.arange(n, device=dev)
        pg = page_table[s].long()[pos // page].clamp(0, n_pages - 1)
        k = k_pages[pg, pos % page].float()          # (n, H, D)
        v = v_pages[pg, pos % page].float()
        sc = torch.einsum("hd,nhd->hn", q[s].float(), k) * scale
        parts = []
        for lo, hi in split_bounds(n, page, plan.pages_per_split):
            m = torch.full((h,), -math.inf, device=dev)
            l = torch.zeros(h, device=dev)
            acc = torch.zeros(h, d, device=dev)
            for groups in tile_bounds(lo, hi, plan.tile):
                for a, b in groups:
                    mn = torch.maximum(m, sc[:, a:b].max(dim=1).values)
                    alpha = torch.exp(m - mn)
                    p = torch.exp(sc[:, a:b] - mn[:, None])
                    l = l * alpha + p.sum(dim=1)
                    acc = acc * alpha[:, None] + torch.einsum(
                        "hn,nhd->hd", p, v[a:b])
                    m = mn
            parts.append((m, l, acc))
        if len(parts) == 1:
            m, l, acc = parts[0]
            out[s] = acc / l[:, None]
            continue
        if fault == "split_dropped":
            parts = parts[1:]
        ms = torch.stack([p[0] for p in parts])       # (splits, H)
        c = torch.exp(ms - ms.max(dim=0).values)
        if fault == "no_rescale":
            c = torch.ones_like(c)
        lsum = (torch.stack([p[1] for p in parts]) * c).sum(dim=0)
        o = (torch.stack([p[2] for p in parts]) * c[..., None]).sum(dim=0)
        out[s] = o / lsum[:, None]
    return out.to(q.dtype)
