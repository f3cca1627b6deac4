"""Ring attention: sequence (context) parallelism over a mesh axis.

Counterpart of ``deeplearning4j_tpu/parallel/ring_attention.py`` (Liu et
al.'s ring attention, the FlashAttention recurrence distributed): the
sequence is sharded over the ``seq`` ranks; each keeps its queries and an
online-softmax accumulator (running max m, denominator l, numerator acc)
while the K/V shards travel round the ring, one hop a shard. The hop is
``collectives.ring_shift`` — an autograd function whose backward shifts
the gradient the other way, as JAX differentiates through ``ppermute``.
K and V travel together, one shift a hop, and the last hop's shift (whose
result no one reads) is not made.

Memory a rank: O(T/N · D) activations and O((T/N)²) scores a hop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops import collectives
from deeplearning4j_tpu_torch.ops.collectives import mesh_groups


def ring_attention(q, k, v, *, mesh, axis: str = "seq",
                   scale: Optional[float] = None, causal: bool = False):
    """Attention of the rank's queries over the whole sequence. q, k, v:
    (BH, T/N, D), the rank's shard of the sequence (rank i of the axis
    holds positions [i·T/N, (i+1)·T/N)); returns the rank's (BH, T/N, D)
    output. Float32 arithmetic, the result in q's dtype."""
    groups = mesh_groups(mesh)
    n, idx = groups.size(axis), groups.index(axis)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    t_local = q.shape[1]
    qf = q.to(torch.float32) * scale
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full((*q.shape[:2], 1), -1e30, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)  # noqa: E741
    kv = torch.stack([k, v])
    for h in range(n):
        src = (idx - h) % n  # whose shard is here at hop h
        s = torch.einsum("bqd,bkd->bqk", qf, kv[0].to(torch.float32))
        if causal:
            q_pos = idx * t_local + torch.arange(t_local, device=q.device)
            k_pos = src * t_local + torch.arange(t_local, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)  # noqa: E741
        acc = acc * alpha + torch.einsum("bqk,bkd->bqd", p,
                                         kv[1].to(torch.float32))
        m = m_new
        if h < n - 1:
            kv = collectives.ring_shift(kv, groups, axis)
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


class RingSelfAttention:
    """Multi-head self-attention with the sequence sharded over a mesh
    axis (the long-context building block): ``x`` (N, T/n, d) is the
    rank's shard of the sequence, the projections are whole."""

    def __init__(self, mesh, num_heads: int, axis: str = "seq",
                 causal: bool = False):
        self.mesh = mesh
        self.num_heads = num_heads
        self.axis = axis
        self.causal = causal

    def __call__(self, x, wq, wk, wv, wo):
        n, t, d = x.shape
        h = self.num_heads
        dh = d // h

        def split(a):
            return a.reshape(n, t, h, dh).transpose(1, 2).reshape(n * h, t,
                                                                   dh)

        q, k, v = split(x @ wq), split(x @ wk), split(x @ wv)
        out = ring_attention(q, k, v, mesh=self.mesh, axis=self.axis,
                             causal=self.causal)
        out = out.reshape(n, h, t, dh).transpose(1, 2).reshape(n, t, d)
        return out @ wo
