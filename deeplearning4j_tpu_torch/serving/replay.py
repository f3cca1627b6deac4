"""Serving traffic replay — the prefix-cache and speculative-decoding
harnesses.

Counterpart of ``deeplearning4j_tpu/serving/replay.py``. Each leg builds a
fresh :class:`GenerativeEngine` on ``device`` (the card unless the caller
asks for the CPU, as the tests do) and serves closed-loop, one request at
a time on the inline engine, so TTFT measures prefill service time, not
queueing (queueing under load is ``serving/overload.py``'s).

:func:`run_prefix_replay` drives the traffic the radix prefix cache
exists for — a handful of shared "system prompts", each followed by a
short unique tail — and reports what the cache buys: TTFT percentiles
(with the cache, admission prefills only the suffix against the cached
prefix), hit accounting (``GenerationResult.prefix_hit_tokens`` and the
``dl4j_tpu_prefix_*`` counters), the greedy outputs (the caller holds
cache-on to cache-off token for token) and the serving ``new_shape``
count. Warm rounds populate the tree and capture every path first.

:func:`run_spec_replay` runs one greedy request plan with speculation on
or off and reports decode tokens/sec, the outputs (identical across the
legs) and proposal/acceptance accounting. Both legs can arm the 50 ms
``slow_decode`` floor (one fire a target step), standing in for a big
model's step time so the bench measures the mechanism. The default draft
is :func:`~deeplearning4j_tpu_torch.serving.speculative.perturbed_draft`.

:func:`run_randomized_replay` is shape-diverse: prompt lengths across the
whole ``1..max_prompt`` range, varied generation lengths, some shared
prefixes, with the prefix cache and speculation armed at once — the
bucketing contract says none of it may reach a capture signature (no
serving ``new_shape``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

# one definition of "a serving recompile" for every harness
from deeplearning4j_tpu_torch.serving.overload import _serving_new_shape_count


def _pct(sorted_xs: List[float], q: float) -> Optional[float]:
    if not sorted_xs:
        return None
    return sorted_xs[min(len(sorted_xs) - 1, int(q * len(sorted_xs)))]


def run_prefix_replay(*, prefix_on: bool, n_requests: int = 12,
                      n_prefixes: int = 3, sys_len: int = 88,
                      tail_max: int = 5, gen_tokens: int = 4,
                      max_slots: int = 2, seed: int = 0, vocab: int = 512,
                      max_prompt: int = 96, page_size: int = 8,
                      suffix_bucket: int = 16,
                      prefix_pages: Optional[int] = None,
                      warm_rounds: int = 2,
                      model=None, device=None) -> Dict[str, Any]:
    """One replay leg on a fresh engine. Identical ``seed`` on both legs
    yields an identical request plan, so outputs are comparable
    token-for-token. Returns TTFT percentiles, per-request outputs, hit
    accounting, and the serving ``new_shape`` delta."""
    from deeplearning4j_tpu_torch.models.gpt import GptConfig, GptModel
    from deeplearning4j_tpu_torch.serving import GenerativeEngine

    if model is None:
        cfg = GptConfig(vocab_size=vocab, hidden=256, layers=4, heads=8,
                        intermediate=1024, max_position=2 * max_prompt,
                        eos_token=0)
        model = GptModel(cfg, seed=0, device=device)
    cfg = model.cfg
    if sys_len + tail_max > max_prompt:
        raise ValueError("sys_len + tail_max must fit the max_prompt bucket")
    pages_per_seq = -(-(max_prompt + gen_tokens + 1) // page_size) + 1
    if prefix_pages is None:
        # budget: every shared prefix fully resident plus a few tails
        prefix_pages = n_prefixes * (-(-max_prompt // page_size))
    num_pages = max_slots * pages_per_seq + (prefix_pages if prefix_on
                                             else 0)
    eng = GenerativeEngine(
        model, max_slots=max_slots, page_size=page_size,
        num_pages=num_pages, max_pages_per_seq=pages_per_seq,
        max_prompt=max_prompt, seed=0,
        prefix_pages=prefix_pages if prefix_on else 0,
        suffix_bucket=suffix_bucket, device=model.device)
    new_shape_before = _serving_new_shape_count()

    r = np.random.RandomState(seed)
    prefixes = [r.randint(1, cfg.vocab_size, size=sys_len).astype(np.int32)
                for _ in range(n_prefixes)]
    plan = []
    for _ in range(n_requests):
        pfx = prefixes[int(r.randint(n_prefixes))]
        tail = r.randint(1, cfg.vocab_size,
                         size=int(r.randint(1, tail_max + 1))) \
            .astype(np.int32)
        plan.append(np.concatenate([pfx, tail]))

    def run_one(prompt):
        fut = eng.submit(prompt, max_new_tokens=gen_tokens, eos_token=-1)
        while eng.scheduler.has_work():
            eng.step()
        return fut.result(timeout=0)

    # warm: round 0 inserts each shared prefix; round 1 HITS it on the
    # cache-on leg, capturing the suffix-prefill path — so the timed
    # window below pays no capture on either leg
    for round_ in range(warm_rounds):
        for pfx in prefixes:
            run_one(np.concatenate(
                [pfx, np.asarray([1 + round_], np.int32)]))

    results = [run_one(p) for p in plan]

    ttfts = sorted(res.ttft_s for res in results if res.ttft_s is not None)
    hit_tokens = sum(res.prefix_hit_tokens for res in results)
    reasons: Dict[str, int] = {}
    for res in results:
        reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1
    out: Dict[str, Any] = {
        "prefix_on": prefix_on,
        "requests": n_requests,
        "outputs": [res.tokens.tolist() for res in results],
        "prompts": [p.tolist() for p in plan],
        "reasons": dict(sorted(reasons.items())),
        "all_terminal": all(res.finish_reason in ("eos", "length")
                            for res in results),
        "ttft_p50_ms": round(_pct(ttfts, 0.50) * 1e3, 3) if ttfts else None,
        "ttft_p99_ms": round(_pct(ttfts, 0.99) * 1e3, 3) if ttfts else None,
        "prefix_hit_tokens": int(hit_tokens),
        "hit_requests": sum(1 for res in results
                            if res.prefix_hit_tokens > 0),
        "new_shape_events": max(
            0, _serving_new_shape_count() - new_shape_before),
    }
    if prefix_on and eng.prefix is not None:
        eng.check_invariants()
        out["tree_pages"] = eng.prefix.tree_pages
        out["pinned_pages"] = eng.prefix.pinned_pages
    return out


def _serving_first_compile_keys(before: int) -> List[str]:
    """The serving-graph ``first_compile`` ledger keys recorded after
    event index ``before``: the evidence that exactly the expected units
    were captured."""
    from deeplearning4j_tpu_torch import observe

    evs = observe.ledger().events()
    return sorted(e.key for e in evs[before:]
                  if e.graph == "serving" and e.cause == "first_compile")


def run_spec_replay(*, spec_on: bool, n_requests: int = 6,
                    prompt_len: int = 10, gen_tokens: int = 12,
                    spec_k: int = 4, max_slots: int = 2, seed: int = 0,
                    vocab: int = 512, page_size: int = 8,
                    max_prompt: int = 16, draft_model=None,
                    draft_noise: float = 1e-2, slow_decode: bool = True,
                    warm_rounds: int = 2, model=None,
                    device=None) -> Dict[str, Any]:
    """One speculative-decoding replay leg on a fresh engine (module
    docstring has the measurement model). Identical ``seed`` on both
    legs yields an identical greedy request plan, so outputs are
    comparable token-for-token. Returns decode tokens/sec over the timed
    window, per-request outputs, proposal/acceptance accounting, the
    serving ``new_shape`` delta, and the leg's ``first_compile`` key
    set."""
    from deeplearning4j_tpu_torch import faults, observe
    from deeplearning4j_tpu_torch.models.gpt import GptConfig, GptModel
    from deeplearning4j_tpu_torch.serving import GenerativeEngine
    from deeplearning4j_tpu_torch.serving.speculative import perturbed_draft

    if model is None:
        cfg = GptConfig.tiny(vocab_size=vocab,
                             max_position=4 * max_prompt)
        model = GptModel(cfg, seed=0, device=device)
    cfg = model.cfg
    if spec_on and draft_model is None:
        draft_model = perturbed_draft(model, scale=draft_noise, seed=1)
    pages_per_seq = -(-(max_prompt + gen_tokens + spec_k + 1)
                      // page_size) + 1
    eng = GenerativeEngine(
        model, max_slots=max_slots, page_size=page_size,
        max_pages_per_seq=pages_per_seq, max_prompt=max_prompt, seed=0,
        spec_k=spec_k if spec_on else 0,
        draft_model=draft_model if spec_on else None, device=model.device)
    led_before = len(observe.ledger().events())
    new_shape_before = _serving_new_shape_count()

    r = np.random.RandomState(seed)
    plan = [r.randint(1, cfg.vocab_size, size=prompt_len).astype(np.int32)
            for _ in range(n_requests)]

    def run_one(prompt):
        fut = eng.submit(prompt, max_new_tokens=gen_tokens, eos_token=-1)
        while eng.scheduler.has_work():
            eng.step()
        return fut.result(timeout=0)

    # warm: capture every path on this leg (prefill + decode or
    # prefill + draft_prefill + draft_decode + verify) OUTSIDE the timed
    # window, floor unarmed — the window below measures steps
    for round_ in range(warm_rounds):
        run_one(r.randint(1, cfg.vocab_size,
                          size=prompt_len).astype(np.int32))

    if slow_decode:
        # the deterministic per-target-step service floor (one fire per
        # engine step)
        faults.arm("slow_decode", prob=1.0, seed=0)
    try:
        t0 = time.perf_counter()
        results = [run_one(p) for p in plan]
        wall = time.perf_counter() - t0
    finally:
        if slow_decode:
            faults.disarm("slow_decode")

    eng.check_invariants()
    n_tokens = sum(len(res.tokens) for res in results)
    proposed = sum(res.spec_proposed_tokens for res in results)
    accepted = sum(res.spec_accepted_tokens for res in results)
    reasons: Dict[str, int] = {}
    for res in results:
        reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1
    return {
        "spec_on": spec_on,
        "spec_k": spec_k if spec_on else 0,
        "requests": n_requests,
        "outputs": [res.tokens.tolist() for res in results],
        "prompts": [p.tolist() for p in plan],
        "reasons": dict(sorted(reasons.items())),
        "all_terminal": all(res.finish_reason in ("eos", "length")
                            for res in results),
        "generated_tokens": int(n_tokens),
        "tokens_per_sec": round(n_tokens / wall, 3) if wall else None,
        "wall_s": round(wall, 3),
        "proposed_tokens": int(proposed),
        "accepted_tokens": int(accepted),
        "acceptance_rate": round(accepted / proposed, 4) if proposed
        else None,
        "new_shape_events": max(
            0, _serving_new_shape_count() - new_shape_before),
        "first_compile_keys": _serving_first_compile_keys(led_before),
    }


def run_randomized_replay(*, n_requests: int = 16, seed: int = 0,
                          vocab: int = 256, max_prompt: int = 32,
                          page_size: int = 8, suffix_bucket: int = 8,
                          gen_max: int = 6, spec_k: int = 3,
                          max_slots: int = 2, n_prefixes: int = 2,
                          draft_noise: float = 1e-2,
                          model=None, device=None) -> Dict[str, Any]:
    """Shape-diverse replay.

    Where :func:`run_prefix_replay` fixes the traffic shape to measure
    the cache, this leg does the opposite: prompt lengths are drawn from
    the FULL ``1..max_prompt`` range (deliberately straddling page and
    ``suffix_bucket`` boundaries), generation lengths vary per request,
    and a fraction of requests share one of ``n_prefixes`` system
    prompts so both the full-prefill and suffix-prefill paths fire —
    with the prefix cache AND speculative decoding armed at once.  The
    engine's bucketing contract says none of that diversity may reach a
    capture signature: the ledger must show only ``first_compile`` events,
    ZERO serving ``new_shape``.  That is the assertion this function
    exists to feed (the caller makes it — this function only reports).
    """
    from deeplearning4j_tpu_torch import observe
    from deeplearning4j_tpu_torch.models.gpt import GptConfig, GptModel
    from deeplearning4j_tpu_torch.serving import GenerativeEngine
    from deeplearning4j_tpu_torch.serving.speculative import perturbed_draft

    if model is None:
        cfg = GptConfig.tiny(vocab_size=vocab,
                             max_position=4 * max_prompt)
        model = GptModel(cfg, seed=0, device=device)
    cfg = model.cfg
    draft_model = perturbed_draft(model, scale=draft_noise, seed=1)
    pages_per_seq = -(-(max_prompt + gen_max + spec_k + 1)
                      // page_size) + 1
    prefix_pages = n_prefixes * (-(-max_prompt // page_size))
    # boot: the engine's construction (its draft copy and caches)
    t_boot = time.perf_counter()
    eng = GenerativeEngine(
        model, max_slots=max_slots, page_size=page_size,
        num_pages=max_slots * pages_per_seq + prefix_pages,
        max_pages_per_seq=pages_per_seq, max_prompt=max_prompt, seed=0,
        prefix_pages=prefix_pages, suffix_bucket=suffix_bucket,
        spec_k=spec_k, draft_model=draft_model, device=model.device)
    boot_s = time.perf_counter() - t_boot
    led_before = len(observe.ledger().events())
    new_shape_before = _serving_new_shape_count()

    r = np.random.RandomState(seed)
    # shared system prompts sized to cross a page boundary, so prefix
    # hits exercise the suffix-prefill path too
    pfx_len = max(page_size + 1, max_prompt // 2)
    prefixes = [r.randint(1, cfg.vocab_size, size=pfx_len).astype(np.int32)
                for _ in range(n_prefixes)]
    plan = []
    for i in range(n_requests):
        if i % 3 == 0 and n_prefixes:
            # shared-prefix request with a ragged unique tail
            pfx = prefixes[int(r.randint(n_prefixes))]
            tail_max = max(1, max_prompt - pfx_len)
            tail = r.randint(1, cfg.vocab_size,
                             size=int(r.randint(1, tail_max + 1))) \
                .astype(np.int32)
            plan.append(np.concatenate([pfx, tail]))
        else:
            # fully random length across the whole admissible range
            plen = int(r.randint(1, max_prompt + 1))
            plan.append(r.randint(1, cfg.vocab_size,
                                  size=plen).astype(np.int32))
    gens = [int(r.randint(1, gen_max + 1)) for _ in range(n_requests)]

    def run_one(prompt, n_gen):
        fut = eng.submit(prompt, max_new_tokens=n_gen, eos_token=-1)
        while eng.scheduler.has_work():
            eng.step()
        return fut.result(timeout=0)

    results = [run_one(p, g) for p, g in zip(plan, gens)]
    eng.check_invariants()

    reasons: Dict[str, int] = {}
    for res in results:
        reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1
    return {
        "requests": n_requests,
        "outputs": [res.tokens.tolist() for res in results],
        "prompt_lens": sorted({len(p) for p in plan}),
        "gen_lens": sorted(set(gens)),
        "reasons": dict(sorted(reasons.items())),
        "all_terminal": all(res.finish_reason in ("eos", "length")
                            for res in results),
        "generated_tokens": int(sum(len(res.tokens) for res in results)),
        "prefix_hit_tokens": int(sum(res.prefix_hit_tokens
                                     for res in results)),
        "new_shape_events": max(
            0, _serving_new_shape_count() - new_shape_before),
        "first_compile_keys": _serving_first_compile_keys(led_before),
        "boot_s": round(boot_s, 4),
        "ttft_first_ms": (round(results[0].ttft_s * 1e3, 3)
                          if results and results[0].ttft_s is not None
                          else None),
    }
