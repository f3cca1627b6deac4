"""Per-slot token sampling — temperature / top-k / top-p.

Counterpart of ``deeplearning4j_tpu/serving/sampling.py`` with the same
semantics: one vectorized function over the slot axis, every knob a
``(S,)`` tensor, so a greedy slot and a temperature-1.2 top-p slot share
one call. Random draws come from the caller's ``torch.Generator`` (the
engine owns one on its device, seeded from its ``seed``, and registers it
with the CUDA graphs of its prefill and decode steps, so each replay draws
new numbers); ``jax.random`` and ``torch.Generator`` streams cannot agree,
so only greedy slots match the JAX package token for token.
"""

from __future__ import annotations

import torch


def sample_tokens(logits, generator: torch.Generator, temperature, top_k,
                  top_p):
    """Sample one token per slot.

    logits: (S, V); generator: on the logits' device; temperature: (S,)
    float — ``<= 0`` means greedy argmax for that slot; top_k: (S,) int —
    ``0`` disables the k cutoff; top_p: (S,) float — ``1.0`` disables the
    nucleus cutoff. Returns (S,) int64."""
    s_n, vocab = logits.shape
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)

    scaled = logits / temperature.float().clamp(min=1e-6)[:, None]
    # a fill on the device, not a host copy: the sampler runs inside the
    # decode step's CUDA-graph capture
    neg_inf = torch.full((), float("-inf"), device=logits.device)

    # top-k: keep scores >= the k-th largest per row (k=0 -> keep all)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    k = k.long().clamp(1, vocab)
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = desc.gather(1, (k - 1)[:, None])
    masked = torch.where(scaled >= kth, scaled, neg_inf)

    # top-p (nucleus) on the k-masked distribution: keep the smallest
    # prefix of descending probs whose mass reaches top_p — a sorted token
    # is kept when the mass BEFORE it is < top_p
    probs = torch.softmax(masked, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sp, dim=-1)
    keep_sorted = (cum - sp) < top_p.float()[:, None]
    cutoff = torch.where(keep_sorted, sp, torch.full_like(sp, float("inf")))
    cutoff = cutoff.min(dim=-1, keepdim=True).values
    masked = torch.where(probs >= cutoff, masked, neg_inf)

    # categorical draw by the Gumbel-max trick, one row of noise per slot
    u = torch.rand((s_n, vocab), generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(temperature <= 0.0, greedy, sampled)
