"""Speculative decoding of the PyTorch port against the JAX package (CPU).

* ``_draft_decode_step`` and ``gpt_verify`` match the JAX functions
  within 1e-5 (float32 logits and K/V; the verify argmax exactly).
* The engine with ``spec_k`` 2 and 4 commits the plain greedy stream and
  the JAX engine's, token for token, with the JAX draft's parameters
  (``perturbed_draft``) carried across: the same proposals and acceptances
  per request. The schedule includes shared-prefix admissions, so
  rollbacks cross page boundaries on pages mapped from the radix tree.
  Both packages run one generic attention on the CPU, which is why exact
  equality is the bar here (on the card verify and plain decode run
  different attention code, and a near tie may resolve differently).
* ``_recover`` with the prefix cache and speculation on stays lossless.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu.serving import speculative as jspec
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.models import zoo as tzoo
from deeplearning4j_tpu_torch.models._tree import leaf_paths
from deeplearning4j_tpu_torch.serving import (
    GenerativeEngine, SpeculativeDecoder, perturbed_draft)
from deeplearning4j_tpu_torch.serving.replay import run_spec_replay
from deeplearning4j_tpu_torch.serving.speculative import _draft_decode_step
from deeplearning4j_tpu_torch.testing.gpt_serving import (
    numpy_gpt_params, shared_prefix_prompts, tiny_config)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = tiny_config()
NP_PARAMS = numpy_gpt_params(CFG)
JAX_MODEL = jgpt.GptModel(CFG, params=jax.tree.map(jnp.asarray, NP_PARAMS))
PORT_PARAMS = tgpt.params_from_numpy(NP_PARAMS, device="cpu")
MODEL = tgpt.GptModel(CFG, params=PORT_PARAMS, device="cpu")
# the JAX package's perturbed draft, carried across leaf by leaf
JAX_DRAFT = jspec.perturbed_draft(JAX_MODEL, scale=3e-2, seed=1)
DRAFT = tgpt.GptModel(CFG, params=tgpt.params_from_numpy(
    jax.tree.map(np.asarray, JAX_DRAFT.params), device="cpu"), device="cpu")
#: all-zero parameters: the draft proposes token 0 at every position, and
#: the targets below never emit it — a rejection at every position
ZDRAFT = tgpt.GptModel(CFG, params=tgpt.params_from_numpy(jax.tree.map(
    lambda a: np.zeros_like(a), NP_PARAMS), device="cpu"), device="cpu")
ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=6,
                 max_prompt=24, seed=3)
PROMPTS = [np.array([3, 5, 7, 9], np.int32), np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32)]


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def port_engine(**kw):
    return GenerativeEngine(MODEL, device="cpu", **dict(ENGINE_KW, **kw))


def serving_new_shape():
    return sum(1 for e in observe.ledger().events()
               if e.graph == "serving" and e.cause == "new_shape")


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------


def test_draft_decode_step_logits_and_kv():
    r = np.random.RandomState(4)
    h, dh = CFG.heads, CFG.hidden // CFG.heads
    s_n, t = 3, 20
    kv = r.randn(CFG.layers, 2, s_n, t + 1, h, dh).astype(np.float32)
    tokens = np.array([7, 200, 5], np.int32)
    pos = np.array([4, 19, 0], np.int32)
    active = np.array([1, 1, 0], np.int32)
    want_kv, want_l = jspec._draft_decode_step(
        JAX_MODEL.params, jnp.asarray(kv), jnp.asarray(tokens),
        jnp.asarray(pos), jnp.asarray(active), CFG)
    got_kv = torch.from_numpy(kv.copy())
    with torch.no_grad():
        out_kv, got_l = _draft_decode_step(
            PORT_PARAMS, got_kv, torch.from_numpy(tokens),
            torch.from_numpy(pos), torch.from_numpy(active), CFG)
    assert out_kv is got_kv  # written in place
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), **TOL)


def test_verify_kv_and_greedy():
    r = np.random.RandomState(5)
    h, dh = CFG.heads, CFG.hidden // CFG.heads
    s_n, page, n_pages, max_pages, b = 3, 8, 12, 3, 5
    kv = r.randn(CFG.layers, 2, n_pages + 1, page, h, dh).astype(np.float32)
    pt = np.stack([r.choice(n_pages, max_pages, replace=False)
                   for _ in range(s_n)]).astype(np.int32)
    seq_lens = np.array([6, 13, 0], np.int32)   # slot 1 crosses a page
    active = np.array([1, 1, 0], np.int32)
    tokens = r.randint(1, CFG.vocab_size, (s_n, b)).astype(np.int32)
    pos = seq_lens[:, None] + np.arange(b)[None]
    row = np.clip(pos // page, 0, max_pages - 1)
    wpage = np.where(active[:, None] > 0, pt[np.arange(s_n)[:, None], row],
                     n_pages).astype(np.int32)
    woff = (pos % page).astype(np.int32)
    args = (tokens, seq_lens, pt, wpage, woff)
    want_kv, want_g = jgpt.gpt_verify(
        JAX_MODEL.params, jnp.asarray(kv), *[jnp.asarray(a) for a in args],
        CFG, page_size=page)
    got_kv = torch.from_numpy(kv.copy())
    with torch.no_grad():
        out_kv, got_g = tgpt.gpt_verify(
            PORT_PARAMS, got_kv, *[torch.from_numpy(a) for a in args], CFG,
            page_size=page)
    assert out_kv is got_kv and got_g.dtype == torch.int32
    np.testing.assert_array_equal(got_g.numpy(), np.asarray(want_g))
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), **TOL)


def test_verify_argmax_equals_step_by_step_decode():
    """The verify window's argmax at fed position i is the greedy token
    after the first i + 1 fed tokens: each position against a full
    prefill of the same sequence."""
    prompt = PROMPTS[2]
    fed = np.array([9, 31, 4, 77], np.int32)
    ids = np.concatenate([prompt, fed])
    with torch.no_grad():
        full, _ = tgpt.gpt_prefill(PORT_PARAMS,
                                   torch.from_numpy(ids[None]), CFG)
        eng = port_engine()
        eng.generate([prompt], max_new_tokens=1, eos_token=-1)  # capture
        cache = eng.cache
        cache.ensure_capacity(0, ids.size)
        _, kvp = tgpt.gpt_prefill(PORT_PARAMS,
                                  torch.from_numpy(prompt[None]), CFG)
        for i in range(prompt.size):
            pg = int(cache.page_table[0, i // 8])
            cache.kv[:, :, pg, i % 8] = kvp[:, :, 0, i]
        pos = prompt.size + np.arange(fed.size)
        wpage = cache.page_table[0, pos // 8][None].astype(np.int32)
        _, greedy = tgpt.gpt_verify(
            PORT_PARAMS, cache.kv, torch.from_numpy(fed[None]),
            torch.tensor([prompt.size], dtype=torch.int32),
            torch.from_numpy(cache.page_table[:1].copy()),
            torch.from_numpy(wpage), torch.from_numpy((pos % 8)[None]),
            CFG, page_size=8)
    want = full[0, prompt.size - 1 + 1:].argmax(-1).numpy()
    np.testing.assert_array_equal(greedy[0].numpy(), want)


def test_perturbed_draft_is_seeded():
    a = perturbed_draft(MODEL, scale=1e-2, seed=7)
    b = perturbed_draft(MODEL, scale=1e-2, seed=7)
    c = perturbed_draft(MODEL, scale=1e-2, seed=8)
    for (_, x), (_, y), (_, z), (_, w) in zip(
            leaf_paths(a.params), leaf_paths(b.params),
            leaf_paths(c.params), leaf_paths(MODEL.params)):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert 0 < float((x - w).abs().max()) < 0.1
    assert a.cfg == MODEL.cfg and a.device == MODEL.device


def test_draft_config_and_zoo_init_draft_match_jax():
    for cfg in (jgpt.GptConfig.base(), tiny_config(eos_token=5)):
        assert (tgpt.draft_config_for(cfg, layers=3).to_json()
                == jgpt.draft_config_for(cfg, layers=3).to_json())
    zt = tzoo.GPT("base", seed=2, device="cpu")
    assert (zt.init_draft().cfg.to_json()
            == jzoo.GPT("base", seed=2).init_draft().cfg.to_json())
    draft = tzoo.GPT("tiny", device="cpu").init_draft(
        params=jax.tree.map(np.asarray, jzoo.GPT("tiny").init_draft().params))
    eng = GenerativeEngine(tzoo.GPT("tiny", device="cpu").init(),
                           device="cpu", spec_k=2, draft_model=draft,
                           **ENGINE_KW)
    r = eng.generate([PROMPTS[0]], max_new_tokens=4, eos_token=-1)[0]
    assert r.finish_reason == "length" and r.spec_proposed_tokens > 0


def test_engine_rejects_mismatched_drafts():
    with pytest.raises(ValueError, match="requires a draft_model"):
        port_engine(spec_k=2)
    with pytest.raises(ValueError, match="vocab_size"):
        port_engine(spec_k=2, draft_model=tgpt.GptModel(
            tiny_config(vocab_size=128), device="cpu"))
    with pytest.raises(ValueError, match="eos_token"):
        port_engine(spec_k=2, draft_model=tgpt.GptModel(
            tiny_config(eos_token=3), device="cpu"))
    with pytest.raises(ValueError, match="spec_k must be positive"):
        SpeculativeDecoder(MODEL, k=0, max_slots=2, max_ctx=32,
                           max_prompt=16)


# ---------------------------------------------------------------------------
# the engine against the JAX engine and against plain greedy
# ---------------------------------------------------------------------------

#: closed-loop shared-prefix requests (a miss, then hits whose rollbacks
#: cross the page boundary at 16 on pages mapped from the tree), then
#: three at once through two slots
SCHEDULE = shared_prefix_prompts([[7], [9, 5], [7, 3, 3, 1, 2]])


def _serve(eng):
    out = [eng.generate([p], max_new_tokens=n, eos_token=-1)[0]
           for p, n in zip(SCHEDULE, (12, 9, 11))]
    return out + eng.generate(PROMPTS, max_new_tokens=10, eos_token=-1)


@pytest.mark.parametrize("k", [2, 4])
def test_engine_spec_matches_jax_engine_and_plain_greedy(k):
    kw = dict(spec_k=k, prefix_pages=8, suffix_bucket=8)
    jeng = JaxEngine(JAX_MODEL, draft_model=JAX_DRAFT, **kw, **ENGINE_KW)
    want = _serve(jeng)
    before = serving_new_shape()
    eng = port_engine(draft_model=DRAFT, **kw)
    got = _serve(eng)
    plain = _serve(port_engine())
    for g, w, p in zip(got, want, plain):
        assert g.finish_reason == w.finish_reason == "length"
        assert g.tokens.tolist() == w.tokens.tolist() == p.tokens.tolist()
        assert (g.spec_proposed_tokens, g.spec_accepted_tokens,
                g.prefix_hit_tokens) == (
            w.spec_proposed_tokens, w.spec_accepted_tokens,
            w.prefix_hit_tokens)
    accepted = sum(g.spec_accepted_tokens for g in got)
    proposed = sum(g.spec_proposed_tokens for g in got)
    assert 0 < accepted < proposed  # accepts and rejections both ran
    assert sum(g.prefix_hit_tokens > 0 for g in got) == 2
    assert serving_new_shape() == before
    eng.check_invariants()
    counts = {}
    for e in observe.ledger().events():
        if e.graph == "serving" and e.key in ("verify", "draft_prefill",
                                              "draft_decode",
                                              "suffix_prefill"):
            counts[(e.key, e.cause)] = counts.get((e.key, e.cause), 0) + 1
    assert set(counts) == {(key, "first_compile") for key in (
        "verify", "draft_prefill", "draft_decode", "suffix_prefill")}


def test_rejection_at_every_position_on_shared_pages():
    """A draft that is always wrong: every verify commits one token and
    rewinds K, across the page boundary at 16, on slots whose first page
    is the tree's. The donor keeps serving exact hits."""
    eng = port_engine(spec_k=3, draft_model=ZDRAFT, prefix_pages=8,
                      suffix_bucket=8)
    plain = port_engine()
    hits = []
    for tail in ([7], [9], [7], [11]):
        p = shared_prefix_prompts([tail])[0]
        r = eng.generate([p], max_new_tokens=12, eos_token=-1)[0]
        want = plain.generate([p], max_new_tokens=12, eos_token=-1)[0]
        assert r.tokens.tolist() == want.tokens.tolist()
        assert 0 not in want.tokens.tolist()
        assert r.spec_accepted_tokens == 0 and r.spec_proposed_tokens > 0
        hits.append(r.prefix_hit_tokens)
    assert hits[0] == 0 and all(h == 11 for h in hits[1:])
    eng.check_invariants()


def test_eos_and_budget_inside_the_window():
    plain = port_engine().generate([PROMPTS[0]], max_new_tokens=9,
                                   eos_token=-1)[0].tokens.tolist()
    eos = plain[4]
    eng = port_engine(spec_k=4, draft_model=MODEL)  # accepts everything
    r = eng.generate([PROMPTS[0]], max_new_tokens=9, eos_token=eos)[0]
    assert r.finish_reason == "eos"
    assert r.tokens.tolist() == plain[:plain.index(eos)]
    r = eng.generate([PROMPTS[0]], max_new_tokens=7, eos_token=-1)[0]
    assert r.tokens.tolist() == plain[:7]
    eng.check_invariants()


def test_sampling_slots_and_spec_disabled_take_plain_decode():
    eng = port_engine(spec_k=2, draft_model=DRAFT)
    futs = [eng.submit(PROMPTS[0], max_new_tokens=5, temperature=0.8),
            eng.submit(PROMPTS[1], max_new_tokens=5, eos_token=-1)]
    while eng.scheduler.has_work():
        eng.step()
    sampled, greedy = [f.result(timeout=0) for f in futs]
    assert sampled.spec_proposed_tokens == 0
    assert greedy.spec_proposed_tokens > 0
    from deeplearning4j_tpu_torch.serving import GenerationRequest
    req = GenerationRequest(prompt=PROMPTS[2], max_new_tokens=5,
                            eos_token=-1, spec_disabled=True)
    fut = eng.submit_request(req)
    while eng.scheduler.has_work():
        eng.step()
    res = fut.result(timeout=0)
    assert res.spec_disabled and res.spec_proposed_tokens == 0
    eng.check_invariants()


def test_recover_with_prefix_cache_and_speculation_stays_lossless():
    """decode_step_error fires inside a speculative step (mid-flight, two
    slots sharing the tree's pages): the supervisor clears the tree and
    the draft state, retries from the prompt, and the streams are the
    plain greedy streams, with no new_shape."""
    prompts = shared_prefix_prompts([[7], [9, 5]])
    want = [r.tokens.tolist() for r in port_engine().generate(
        prompts, max_new_tokens=10, eos_token=-1)]
    eng = port_engine(spec_k=3, draft_model=DRAFT, prefix_pages=8,
                      suffix_bucket=8, restart_backoff_s=0.0)
    eng.generate(shared_prefix_prompts([[3]]), max_new_tokens=4,
                 eos_token=-1)  # captures every unit, inserts the prefix
    before = serving_new_shape()
    faults.arm("decode_step_error", prob=1.0, after_n=3, max_fires=1)
    eng.start()
    try:
        futs = [eng.submit(p, max_new_tokens=10, eos_token=-1,
                           max_retries=2) for p in prompts]
        got = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    assert eng.restarts == 1
    assert [r.tokens.tolist() for r in got] == want
    assert serving_new_shape() == before
    assert not eng.spec.lens.any()
    eng.check_invariants()


def test_spec_replay_on_cpu():
    kw = dict(n_requests=3, prompt_len=6, gen_tokens=8, spec_k=3,
              max_prompt=8, page_size=4, slow_decode=False, warm_rounds=1,
              model=MODEL, device="cpu")
    on = run_spec_replay(spec_on=True, draft_model=DRAFT, **kw)
    off = run_spec_replay(spec_on=False, **kw)
    assert on["outputs"] == off["outputs"]
    assert on["all_terminal"] and off["all_terminal"]
    assert on["proposed_tokens"] > 0 and off["proposed_tokens"] == 0
    assert on["new_shape_events"] == off["new_shape_events"] == 0
    assert {"verify", "draft_prefill", "draft_decode"} <= set(
        on["first_compile_keys"])


def _chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("scale", [3e-2, 1e-1])
def test_chip_smoke_draft_checks_on_cpu(scale):
    """chip_smoke's serve_spec checks, rehearsed on the CPU: every
    request's accepted count equals what its committed stream predicts
    (``_draft_agreement``), and one propose, kept with the draft cache it
    started from, equals the generic draft steps (``_propose_check``)."""
    cs = _chip_smoke()
    draft = perturbed_draft(MODEL, scale=scale, seed=1)
    eng = port_engine(spec_k=4, draft_model=draft)
    real, snap, calls = eng.spec.propose, {}, [0]

    def propose(tokens, active):
        calls[0] += 1
        if calls[0] != 3:
            return real(tokens, active)
        snap["kv"] = eng.spec.kv.clone()
        props = real(tokens, active)
        p = eng.spec._prop
        snap.update(call=3, props=props, tokens=p["tokens"].clone(),
                    lens=p["lens"].clone(), active=p["active"].clone())
        return props

    eng.spec.propose = propose
    prompts = list(SCHEDULE) + PROMPTS
    got = [eng.generate([p], max_new_tokens=12, eos_token=-1)[0]
           for p in SCHEDULE] + eng.generate(PROMPTS, max_new_tokens=10,
                                             eos_token=-1)
    predicted, gaps, agree, n_pos = cs._draft_agreement(draft, 4, prompts,
                                                        got)
    assert predicted == [r.spec_accepted_tokens for r in got]
    assert len(gaps) == len(got) and 0 < agree < n_pos
    problems, summary = cs._propose_check(eng.spec, snap)
    assert problems == [] and summary["mismatches"] == []
    assert summary["equal_generic"] == summary["proposals"] > 0
