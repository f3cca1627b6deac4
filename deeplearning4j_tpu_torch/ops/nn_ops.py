"""Generic neural-net ops of the port (plain PyTorch).

Counterpart of the slice of ``deeplearning4j_tpu/ops/nn_ops.py`` the
serving path reaches: the generic ``dot_product_attention``
(``nn_ops.py:448``). The hand-written flash kernel registers as its
``"cuda"`` platform helper in :mod:`.cuda_attention`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from deeplearning4j_tpu_torch.ops.registry import op


@op("dot_product_attention")
def dot_product_attention(q, k, v, mask=None, *, scaled: bool = True,
                          causal: bool = False, dropout_rate: float = 0.0,
                          dropout_rng: Optional[torch.Generator] = None):
    """q:[...,Lq,Dk] k:[...,Lk,Dk] v:[...,Lk,Dv] -> [...,Lq,Dv].

    ``mask``: boolean, broadcast against the scores; masked scores are
    filled with ``-1e9``. ``causal``: END-aligned lower-triangular mask
    (``tril(k=Lk-Lq)``), composed with ``mask``. ``dropout_rate`` /
    ``dropout_rng`` (a ``torch.Generator``): post-softmax dropout of the
    attention probabilities."""
    scores = torch.matmul(q, k.transpose(-1, -2))
    if scaled:
        scores = scores / math.sqrt(q.shape[-1])
    neg = torch.tensor(-1e9, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask.bool(), scores, neg)
    if causal:
        l_q, l_k = scores.shape[-2], scores.shape[-1]
        tri = torch.ones((l_q, l_k), dtype=torch.bool,
                         device=scores.device).tril(diagonal=l_k - l_q)
        scores = torch.where(tri, scores, neg)
    weights = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError(
                "dot_product_attention: dropout_rate > 0 requires "
                "dropout_rng (pass rate 0 for eval mode)")
        keep = torch.rand(weights.shape, generator=dropout_rng,
                          device=weights.device) >= dropout_rate
        weights = torch.where(keep, weights / (1.0 - dropout_rate),
                              torch.zeros_like(weights))
    return torch.matmul(weights, v)
