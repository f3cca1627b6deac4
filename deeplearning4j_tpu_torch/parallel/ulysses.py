"""Ulysses sequence parallelism: attention re-sharded by all-to-all.

Counterpart of ``deeplearning4j_tpu/parallel/ulysses.py`` (DeepSpeed-
Ulysses, Jacobs et al. 2023). Activations enter sharded over the sequence;
an all-to-all re-shards q, k and v over the heads (each rank then holds
H/N heads over the whole sequence and attends densely), and a second one
restores the sequence sharding. Against the ring (``ring_attention.py``):
q, k, v and the output move once each whatever N, and the head count must
divide by N.

JAX's ``all_to_all(split_axis=1, concat_axis=2, tiled=True)`` has no
direct ``all_to_all_single`` form (that splits dim 0): the head chunks are
moved to the front, exchanged, and the received sequence chunks laid out
in source (= sequence shard) order.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import mesh_groups


def _seq_to_heads(x, n, groups, axis):
    # (B, H, T/N, D) -> (B, H/N, T, D)
    b, h, t, d = x.shape
    chunks = x.reshape(b, n, h // n, t, d).permute(1, 0, 2, 3, 4)
    got = collectives.all_to_all(chunks, groups, axis)  # (N_src, B, H/N, ..)
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _heads_to_seq(x, n, groups, axis):
    # (B, H/N, T, D) -> (B, H, T/N, D)
    b, hn, t, d = x.shape
    chunks = x.reshape(b, hn, n, t // n, d).permute(2, 0, 1, 3, 4)
    got = collectives.all_to_all(chunks, groups, axis)  # (N_src, B, H/N, ..)
    return got.permute(1, 0, 2, 3, 4).reshape(b, n * hn, t // n, d)


def ulysses_attention(q, k, v, *, mesh, axis: str = "seq",
                      scale: Optional[float] = None, causal: bool = False):
    """All-to-all sequence-parallel attention. q, k, v: (B, H, T/N, D),
    the rank's shard of the sequence; returns the rank's (B, H, T/N, D)
    output. The head count must divide by the axis size. Float32
    arithmetic, the result in q's dtype."""
    groups = mesh_groups(mesh)
    n = groups.size(axis)
    h = q.shape[1]
    if h % n != 0:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the '{axis}' axis "
            f"size ({n}) — use ring_attention for head-indivisible meshes")
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = (_seq_to_heads(a, n, groups, axis) for a in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qh.to(torch.float32) * sc,
                     kh.to(torch.float32))
    if causal:
        t = s.shape[-1]
        keep = torch.ones((t, t), dtype=torch.bool, device=s.device).tril()
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vh.to(torch.float32))
    return _heads_to_seq(out.to(q.dtype), n, groups, axis)
