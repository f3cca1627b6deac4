"""Speculative decoding — draft-model propose, single-pass target verify.

Counterpart of ``deeplearning4j_tpu/serving/speculative.py``. A cheap DRAFT
model proposes ``K`` greedy continuations, then ONE target forward
(:func:`~deeplearning4j_tpu_torch.models.gpt.gpt_verify`, ``K + 1`` tokens
against the paged cache) scores every proposal. Greedy exact-match
acceptance commits the agreed prefix plus the target's own next token, so
each verify commits 1..K+1 tokens and the committed stream is the plain
greedy stream — as long as the verify pass and plain decode agree on the
argmax. They run different attention code on the card (``gpt_verify`` the
registry's generic dense attention, plain decode the paged kernel), so a
near-tie logit may resolve differently there; on the CPU both run the
one generic path.

This module owns the DRAFT half:

* a **dense per-slot draft KV cache** ``(L, 2, max_slots, max_ctx + 1, H,
  Dh)`` on the engine's device — the draft is small, so the paged
  indirection would cost more than it saves; the last position is the
  trash position (inactive slots' writes land there);
* ``draft_prefill`` — the draft's full-prompt pass at admission, on the
  ``max_prompt`` bucket (causal flash on the card), written into the slot's
  row;
* ``draft_decode`` — ONE captured unit proposing all K tokens: K + 1 greedy
  decode steps over the whole slot bank, each step's argmax feeding the
  next on the device (the counterpart of the JAX ``lax.scan``). Each step
  attends with one query a slot under an ``(S, 1, 1, T)`` key mask, which
  the flash gate takes: L flash launches a step.

Both are :class:`~deeplearning4j_tpu_torch.ops.capture.CapturedUnit`\\ s
whose inputs are staged device buffers (one pinned host buffer each,
copied in one transfer), so their signatures depend only on the engine's
configuration: the recompile ledger records one ``first_compile`` each
(keys ``draft_prefill`` / ``draft_decode``) and no ``new_shape``.

**Rollback** is host bookkeeping: a rejection rewinds the committed
length (target-side ``cache.seq_lens`` and the draft's :attr:`lens`),
leaving the rejected positions as garbage beyond the length that
attention never reads and the next pass overwrites. No page is freed on
rollback, and shared prefix-cache pages are never written past the
prompt.

**Supervision**: :meth:`reset` zeroes the draft KV in place (the captured
units keep its address) and every draft length; retried requests
re-prefill from the prompt.

Metrics: ``dl4j_tpu_spec_{proposed,accepted,rejected}_tokens_total`` and
the ``dl4j_tpu_spec_accept_ratio`` histogram; the ``serving_draft`` spans.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.models._tree import leaf_paths, rebuild
from deeplearning4j_tpu_torch.models.gpt import (
    GptModel, _ffn, _layer_norm, gpt_prefill)
from deeplearning4j_tpu_torch.ops.capture import CapturedUnit

#: acceptance-ratio histogram bounds — fractions of K, not latencies
_ACCEPT_BOUNDS = tuple(i / 10.0 for i in range(11))


def perturbed_draft(model: GptModel, *, scale: float = 1e-2,
                    seed: int = 0) -> GptModel:
    """A deterministic distillation stand-in for harnesses: the target's
    own parameters plus small Gaussian noise, same config and device.
    Greedy agreement with the target is high but not total, so both
    accepts and rejections are exercised. The noise is drawn leaf by leaf
    (in the parameter tree's leaf order) from a CPU ``torch.Generator``
    seeded by ``seed``, so the same draft comes out on any device; it
    cannot match the JAX package's ``jax.random`` draft, whose parameters
    a parity test carries across instead."""
    gen = torch.Generator().manual_seed(int(seed))
    made = {}
    for path, leaf in leaf_paths(model.params):
        noise = torch.randn(tuple(leaf.shape), generator=gen,
                            dtype=torch.float32)
        made[path] = leaf + (scale * noise).to(leaf.device, leaf.dtype)
    return GptModel(model.cfg, params=rebuild(model.params, made),
                    device=model.device)


def _draft_decode_step(params, kv, tokens, pos, active, cfg):
    """One greedy draft token for every slot against the dense cache.

    kv: (L, 2, S, T+1, H, Dh) — position T is the trash position, written
    IN PLACE; tokens/pos: (S,) the fed token and its absolute position;
    active: (S,) integer. Writes the fed token's K/V at ``pos`` (trash when
    inactive), attends over positions ``<= pos``, returns ``(kv, logits
    (S, V))``; the returned cache is the argument itself."""
    from deeplearning4j_tpu_torch.ops import exec_op

    emb = params["embeddings"]
    s_n = tokens.shape[0]
    t_all = kv.shape[3]
    dev = tokens.device
    h, dh = cfg.heads, cfg.hidden // cfg.heads
    pos = pos.long()
    p = pos.clamp(0, cfg.max_position - 1)
    x = emb["word"][tokens.long()] + emb["position"][p]
    x = _layer_norm(x, emb["ln_gamma"], emb["ln_beta"], cfg.layer_norm_eps)
    wpos = torch.where(active > 0, pos, torch.full_like(pos, t_all - 1))
    rows = torch.arange(s_n, device=dev)
    # (S, 1, 1, T): key j is readable once written — j <= pos (history and
    # the token this step writes); the trash position never enters it
    m4 = (torch.arange(t_all - 1, device=dev)[None, :]
          <= pos[:, None])[:, None, None, :]
    for li, blk in enumerate(params["blocks"]):
        a = blk["attn"]
        q = (x @ a["Wq"] + a["bq"]).reshape(s_n, h, 1, dh)
        k = (x @ a["Wk"] + a["bk"]).reshape(s_n, h, dh)
        v = (x @ a["Wv"] + a["bv"]).reshape(s_n, h, dh)
        kv[li, 0, rows, wpos] = k.to(kv.dtype)
        kv[li, 1, rows, wpos] = v.to(kv.dtype)
        kc = kv[li, 0, :, :t_all - 1].permute(0, 2, 1, 3)  # (S, H, T, Dh)
        vc = kv[li, 1, :, :t_all - 1].permute(0, 2, 1, 3)
        out = exec_op("dot_product_attention", q, kc, vc, m4, scaled=True)
        out = out.reshape(s_n, cfg.hidden)
        x = _layer_norm(x + out @ a["Wo"] + a["bo"],
                        a["ln_gamma"], a["ln_beta"], cfg.layer_norm_eps)
        x = _ffn(blk, x, cfg.layer_norm_eps)
    return kv, x @ emb["word"].T


class SpeculativeDecoder:
    """The draft half of speculative decoding: the dense per-slot draft KV,
    the two captured draft units, and the commit/rollback/reset
    bookkeeping the engine drives (module docstring).

    Invariant (``GenerativeEngine.check_invariants`` asserts it): for every
    speculating slot :attr:`lens` equals the target cache's ``seq_lens``;
    for every other slot it is zero.
    """

    def __init__(self, draft_model: GptModel, *, k: int, max_slots: int,
                 max_ctx: int, max_prompt: int):
        if k <= 0:
            raise ValueError(f"spec_k must be positive, got {k}")
        self.draft = draft_model
        cfg = draft_model.cfg
        self.k = int(k)
        self.max_slots = int(max_slots)
        self.max_ctx = int(max_ctx)
        self.max_prompt = int(max_prompt)
        if cfg.max_position < self.max_prompt:
            raise ValueError(
                f"draft max_position={cfg.max_position} cannot prefill the "
                f"engine's max_prompt={max_prompt} bucket")
        self.device = draft_model.device
        # +1: the trash position, where inactive slots' writes land
        self.kv = torch.zeros(
            (cfg.layers, 2, self.max_slots, self.max_ctx + 1, cfg.heads,
             cfg.hidden // cfg.heads), dtype=draft_model.dtype,
            device=self.device)
        self.lens = np.zeros((self.max_slots,), np.int32)
        self._stage()
        self._prefill_fn = None
        self._propose_fn = None
        m = observe.metrics()
        self._c_proposed = m.counter("dl4j_tpu_spec_proposed_tokens_total")
        self._c_accepted = m.counter("dl4j_tpu_spec_accepted_tokens_total")
        self._c_rejected = m.counter("dl4j_tpu_spec_rejected_tokens_total")
        self._h_ratio = m.histogram("dl4j_tpu_spec_accept_ratio",
                                    bounds=_ACCEPT_BOUNDS)

    # -------------------------------------------------------------- staging
    def _stage(self) -> None:
        """Pinned host buffers and their device twins: prefill reads the
        bucketed prompt, its length and the slot; propose reads the fed
        tokens, the draft lengths and the active flags of every slot."""
        pin = self.device.type == "cuda"
        t, s_n = self.max_prompt, self.max_slots

        def pair(n):
            host = torch.zeros(n, dtype=torch.int32, pin_memory=pin)
            return host, host.numpy(), torch.zeros(n, dtype=torch.int32,
                                                   device=self.device)

        self._pre_host, self._pre_np, pre = pair(t + 2)
        self._pre_dev = pre
        self._pre = {"ids": pre[:t].view(1, t), "p_len": pre[t],
                     "slot": pre[t + 1:t + 2]}
        self._prop_host, self._prop_np, prop = pair(3 * s_n)
        self._prop_dev = prop
        self._prop = {"tokens": prop[:s_n], "lens": prop[s_n:2 * s_n],
                      "active": prop[2 * s_n:]}
        # the prefill reads nothing back: this event marks its host-to-device
        # copy done before the next admission rewrites the pinned buffer
        self._pre_copied = torch.cuda.Event() if pin else None

    # --------------------------------------------------------- captured units
    def _build_prefill(self) -> CapturedUnit:
        cfg, params, a = self.draft.cfg, self.draft.params, self._pre
        t = self.max_prompt

        def draft_prefill():
            pos = torch.arange(t, device=self.device)
            mask = (pos < a["p_len"])[None].to(torch.int32)
            _logits, kvp = gpt_prefill(params, a["ids"], cfg, mask=mask)
            # kvp (L, 2, 1, Tpre, H, Dh) drops into the slot's row;
            # positions >= prompt_len hold pad garbage the <= pos decode
            # mask never reads (the first propose overwrites position
            # prompt_len before attending to it)
            self.kv[:, :, a["slot"].long(), :t] = kvp.to(self.kv.dtype)

        return CapturedUnit(draft_prefill, device=self.device,
                            name="draft_prefill")

    def _build_propose(self) -> CapturedUnit:
        cfg, params, d, k = self.draft.cfg, self.draft.params, self._prop, \
            self.k

        def draft_decode():
            step = (d["active"] > 0).to(torch.int32)
            toks, pos, props = d["tokens"], d["lens"], []
            # k + 1 steps for k proposals: the last one only writes d_K's
            # K/V (its output is dropped) — a full accept commits K + 1
            # tokens and advances the draft length over position lens + K,
            # which must then hold real K/V
            for _ in range(k + 1):
                _, logits = _draft_decode_step(params, self.kv, toks, pos,
                                               d["active"], cfg)
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
                props.append(toks)
                pos = pos + step
            return torch.stack(props[:k], dim=1)  # (S, K)

        return CapturedUnit(draft_decode, device=self.device,
                            name="draft_decode")

    # ------------------------------------------------------------- lifecycle
    @torch.no_grad()
    def prefill(self, slot: int, prompt) -> None:
        """Run the draft over ``slot``'s (bucket-padded) prompt at
        admission; afterwards the draft agrees with the target on a cached
        length of ``prompt_len``."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p_len = int(prompt.size)
        t = self.max_prompt
        ids = np.zeros((1, t), np.int32)
        ids[0, :p_len] = prompt
        if self._prefill_fn is None:
            self._prefill_fn = self._build_prefill()
        observe.note_jit_signature(
            self._prefill_fn, graph="serving", key="draft_prefill",
            signature=observe.signature_of(ids=ids))
        if self._pre_copied is not None:
            self._pre_copied.synchronize()
        h = self._pre_np
        h[:t] = ids[0]
        h[t:] = (p_len, slot)
        with observe.tracer().span("serving_draft", category="serving",
                                   phase="prefill", prompt_len=p_len):
            self._pre_dev.copy_(self._pre_host, non_blocking=True)
            if self._pre_copied is not None:
                self._pre_copied.record()
            self._prefill_fn()
        self.lens[slot] = p_len

    @torch.no_grad()
    def propose(self, tokens: np.ndarray, active: np.ndarray) -> np.ndarray:
        """Propose K greedy draft tokens for every active slot, feeding
        each slot's pending token first. Advances the draft KV (rejected
        tails are rewound by :meth:`commit`); returns (S, K) int32."""
        if self._propose_fn is None:
            self._propose_fn = self._build_propose()
        observe.note_jit_signature(
            self._propose_fn, graph="serving", key="draft_decode",
            signature=observe.signature_of(tokens=tokens, lens=self.lens,
                                           active=active))
        s_n, h = self.max_slots, self._prop_np
        h[:s_n] = tokens
        h[s_n:2 * s_n] = self.lens
        h[2 * s_n:] = active
        with observe.tracer().span("serving_draft", category="serving",
                                   phase="decode",
                                   slots=int(np.sum(active))):
            self._prop_dev.copy_(self._prop_host, non_blocking=True)
            props = self._propose_fn()
            return props.cpu().numpy().astype(np.int32)

    def commit(self, slot: int, n_tokens: int) -> None:
        """Advance ``slot``'s draft length by the tokens the verify pass
        committed — everything past it is the rollback: garbage beyond the
        length, overwritten by the next propose."""
        self.lens[slot] += int(n_tokens)

    def note_outcome(self, proposed: int, accepted: int,
                     committed_from_draft: int) -> None:
        """Count one slot's verify outcome. ``proposed == accepted +
        rejected`` always: ``accepted`` counts draft tokens that committed,
        ``rejected`` everything proposed that did not land (target
        disagreement or eos/budget truncation). The accept ratio histogram
        takes the verified agreement (``accepted``/K) alone."""
        self._c_proposed.inc(proposed)
        self._c_accepted.inc(committed_from_draft)
        self._c_rejected.inc(proposed - committed_from_draft)
        if proposed:
            self._h_ratio.observe(accepted / proposed)

    def free(self, slot: int) -> None:
        """Retire ``slot``'s draft row (length 0; its KV is garbage beyond
        the length until the next tenant's prefill)."""
        self.lens[slot] = 0

    def reset(self) -> None:
        """Supervised crash recovery: zero the draft KV in place (the
        captured units keep its address, so nothing is captured again and
        the ledger records no ``new_shape``) and every draft length
        (retried requests re-prefill from the prompt)."""
        self.kv.zero_()
        self.lens[:] = 0

    # ------------------------------------------------------------ inspection
    def check_invariants(self, active_spec_slots, seq_lens) -> None:
        """Draft/target length agreement (test hook): every speculating
        slot's draft length equals the target cache's, every other slot's
        is zero. Raises AssertionError on violation."""
        for slot in range(self.max_slots):
            if slot in active_spec_slots:
                assert self.lens[slot] == seq_lens[slot], (
                    f"slot {slot}: draft cached {self.lens[slot]} tokens "
                    f"but the target cache holds {seq_lens[slot]}")
            else:
                assert self.lens[slot] == 0, (
                    f"slot {slot} is not speculating but holds a draft "
                    f"length of {self.lens[slot]}")


__all__: List[str] = ["SpeculativeDecoder", "perturbed_draft"]
