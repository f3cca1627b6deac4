"""Radix prefix cache of the PyTorch port against the JAX package (CPU).

* The radix tree is host code: the same sequence of ``insert`` /
  ``match`` / ``pin`` / ``evict_to_free`` / ``clear`` over each package's
  paged cache gives the same matches, page refs, refcounts and free lists.
* ``gpt_prefill_suffix`` matches the JAX function in logits and K/V within
  1e-5 (float32, two layers at hidden 32).
* The engine with ``prefix_pages`` gives the JAX engine's greedy tokens,
  prefix hits and copy-on-writes exactly, from carried weights, and the
  same tokens as itself with the cache off: both packages run one generic
  attention on the CPU, and these weights keep the top-2 logit gaps far
  wider than float32 error.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import observe as jobserve
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu.serving.cache import PagedKVCache as JaxCache
from deeplearning4j_tpu.serving.prefix import RadixPrefixCache as JaxRadix
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import (
    GenerativeEngine, PagedKVCache, RadixPrefixCache)
from deeplearning4j_tpu_torch.serving.replay import run_prefix_replay
from deeplearning4j_tpu_torch.testing.gpt_serving import (
    SYSTEM_PROMPT, numpy_gpt_params, shared_prefix_prompts, tiny_config)

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = tiny_config()
NP_PARAMS = numpy_gpt_params(CFG)
JAX_PARAMS = jax.tree.map(jnp.asarray, NP_PARAMS)
PORT_PARAMS = tgpt.params_from_numpy(NP_PARAMS, device="cpu")
MODEL = tgpt.GptModel(CFG, params=PORT_PARAMS, device="cpu")
ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=6,
                 max_prompt=24, seed=3)


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


def counter(obs, name):
    return int(obs.metrics().counter(name).value)


# ---------------------------------------------------------------------------
# the radix tree, operation for operation
# ---------------------------------------------------------------------------


def _tree_state(cache, tree):
    return (sorted(tree.page_refs().items()), list(cache.free),
            [int(c) for c in cache.refcount], tree.tree_pages,
            tree.pinned_pages)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_radix_tree_operation_sequence_matches_jax(seed):
    """A random sequence of inserts (from slots that own the pages, as the
    engine's retire does), matches, pins, pool-pressure evictions and
    clears: after every operation both trees hold the same page refs and
    both allocators the same free list and refcounts."""
    r = np.random.RandomState(seed)
    geo = dict(layers=1, heads=1, head_dim=8, page_size=4, num_pages=24,
               max_slots=2, max_pages_per_seq=6)
    jc, tc = JaxCache(**geo), PagedKVCache(device="cpu", **geo)
    jt = JaxRadix(jc, max_pages=10, min_match=3)
    tt = RadixPrefixCache(tc, max_pages=10, min_match=3)
    stems = [r.randint(1, 9, size=9).astype(np.int32) for _ in range(3)]
    for step in range(40):
        op = r.choice(["insert", "insert", "match", "pin", "evict", "clear"],
                      p=[.3, .2, .25, .1, .1, .05])
        prompt = np.concatenate([stems[r.randint(3)],
                                 r.randint(1, 9, size=r.randint(0, 9))])
        if op in ("insert",):
            n = tc.pages_for(prompt.size)
            for c in (jc, tc):
                assert c.ensure_capacity(0, prompt.size) == "ok"
            got = tt.insert(prompt, list(tc.owned[0][:n]))
            want = jt.insert(prompt, list(jc.owned[0][:n]))
            jc.free_slot(0)
            tc.free_slot(0)
            assert got == want
        elif op == "match":
            cap = int(r.randint(1, 6))
            got, want = tt.match(prompt, max_suffix=cap), \
                jt.match(prompt, max_suffix=cap)
            assert (got is None) == (want is None)
            if got is not None:
                assert (got.matched, got.pages) == (want.matched, want.pages)
        elif op == "pin":
            assert tt.pin(prompt) == jt.pin(prompt)
        elif op == "evict":
            n = int(r.randint(1, 4))
            assert tt.evict_to_free(n) == jt.evict_to_free(n)
            assert tt.reclaimable_pages() == jt.reclaimable_pages()
        else:
            assert tt.clear() == jt.clear()
        assert _tree_state(tc, tt) == _tree_state(jc, jt), (step, op)
        tt.check_invariants()
        tc.check_invariants(tree_refs=tt.page_refs())


def test_used_pages_matches_jax():
    geo = dict(layers=1, heads=1, head_dim=8, page_size=4, num_pages=12,
               max_slots=3, max_pages_per_seq=4)
    jc, tc = JaxCache(**geo), PagedKVCache(device="cpu", **geo)
    for c in (jc, tc):
        c.ensure_capacity(0, 9)
        c.ensure_capacity(2, 4)
        c.map_shared(1, c.owned[0][0])
    assert tc.used_pages() == jc.used_pages() == 5


# ---------------------------------------------------------------------------
# the suffix prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefix_len,suffix_len", [(11, 5), (8, 1),
                                                   (16, 8)])
def test_prefill_suffix_logits_and_kv(prefix_len, suffix_len):
    r = np.random.RandomState(prefix_len)
    t_pre, b = 24, 8
    h, dh = CFG.heads, CFG.hidden // CFG.heads
    ids = np.zeros((1, b), np.int32)
    ids[0, :suffix_len] = r.randint(1, CFG.vocab_size, suffix_len)
    prefix_kv = r.randn(CFG.layers, 2, t_pre, h, dh).astype(np.float32)
    want_l, want_kv = jgpt.gpt_prefill_suffix(
        JAX_PARAMS, jnp.asarray(ids), jnp.asarray(prefix_kv),
        jnp.asarray(prefix_len, jnp.int32),
        jnp.asarray(suffix_len, jnp.int32), CFG)
    with torch.no_grad():
        got_l, got_kv = tgpt.gpt_prefill_suffix(
            PORT_PARAMS, torch.from_numpy(ids), torch.from_numpy(prefix_kv),
            torch.tensor(prefix_len, dtype=torch.int32),
            torch.tensor(suffix_len, dtype=torch.int32), CFG)
    # pad queries attend too, as in the JAX function: every row compares
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)
    np.testing.assert_allclose(got_kv.numpy(), np.asarray(want_kv), **TOL)


def test_prefill_suffix_equals_full_prefill():
    """The suffix pass over the real prefix K/V gives the full prefill's
    logits at the suffix positions."""
    prompt = shared_prefix_prompts([[7, 9, 11]])[0]
    n_pre = SYSTEM_PROMPT.size
    ids = torch.from_numpy(prompt[None].astype(np.int64))
    with torch.no_grad():
        full_l, full_kv = tgpt.gpt_prefill(PORT_PARAMS, ids, CFG)
        pad = torch.zeros(CFG.layers, 2, 24 - n_pre, CFG.heads,
                          CFG.hidden // CFG.heads)
        prefix_kv = torch.cat([full_kv[:, :, 0, :n_pre], pad], dim=2)
        suf = torch.zeros(1, 8, dtype=torch.int64)
        suf[0, :3] = ids[0, n_pre:]
        got_l, got_kv = tgpt.gpt_prefill_suffix(
            PORT_PARAMS, suf, prefix_kv, torch.tensor(n_pre),
            torch.tensor(3), CFG)
    np.testing.assert_allclose(got_l[0, :3].numpy(),
                               full_l[0, n_pre:].numpy(), **TOL)
    np.testing.assert_allclose(got_kv[:, :, :3].numpy(),
                               full_kv[:, :, 0, n_pre:].numpy(), **TOL)


# ---------------------------------------------------------------------------
# the engine: hits, copy-on-writes and tokens against the JAX engine
# ---------------------------------------------------------------------------

#: a first request (miss: inserts the prompt), hits with mid-page tails
#: (copy-on-write of the partial page), a divergence inside the first full
#: page, a tail past the suffix bucket (full prefill), an unrelated prompt
SCHEDULE = (shared_prefix_prompts([[7], [9, 5], [7, 3, 3], [11] * 10])
            + [np.concatenate([SYSTEM_PROMPT[:5], [90, 91, 92]]),
               np.array([3, 5, 7, 9, 11], np.int32)]
            + shared_prefix_prompts([[13, 17]]))


def _run(eng, prompts, budgets):
    """Submit one at a time (closed loop), as a replay does, then two at
    once (two slots sharing the prefix's pages)."""
    out = []
    for p, n in zip(prompts, budgets):
        out += eng.generate([p], max_new_tokens=n, eos_token=-1)
    out += eng.generate(shared_prefix_prompts([[19], [23, 29]]),
                        max_new_tokens=9, eos_token=-1)
    return out


def test_engine_prefix_cache_matches_jax_engine_and_cache_off():
    budgets = [6, 9, 12, 5, 7, 4, 10]
    # min_match 4: the divergence 5 tokens into the first page still hits
    jeng = JaxEngine(jgpt.GptModel(CFG, params=JAX_PARAMS), prefix_pages=12,
                     suffix_bucket=8, prefix_min_match=4, **ENGINE_KW)
    jcow0 = counter(jobserve, "dl4j_tpu_prefix_cow_copies_total")
    want = _run(jeng, SCHEDULE, budgets)
    jcow = counter(jobserve, "dl4j_tpu_prefix_cow_copies_total") - jcow0

    before = serving_new_shape()
    eng = port_engine(prefix_pages=12, suffix_bucket=8, prefix_min_match=4)
    cow0 = counter(observe, "dl4j_tpu_prefix_cow_copies_total")
    got = _run(eng, SCHEDULE, budgets)
    cow = counter(observe, "dl4j_tpu_prefix_cow_copies_total") - cow0
    off = _run(port_engine(), SCHEDULE, budgets)

    hits = [r.prefix_hit_tokens for r in got]
    assert hits == [r.prefix_hit_tokens for r in want]
    assert hits[0] == 0 and hits[1] == 11 and hits[4] == 5
    assert hits[3] == 0  # its 10-token tail is past the suffix bucket
    assert cow == jcow > 0
    for g, w, o in zip(got, want, off):
        assert g.finish_reason == w.finish_reason == "length"
        assert g.tokens.tolist() == w.tokens.tolist() == o.tokens.tolist()
        assert o.prefix_hit_tokens == 0
    assert eng.prefix.tree_pages == jeng.prefix.tree_pages
    assert (sorted(eng.prefix.page_refs().items())
            == sorted(jeng.prefix.page_refs().items()))
    eng.check_invariants()
    assert serving_new_shape() == before
    keys = {e.key for e in observe.ledger().events()
            if e.graph == "serving" and e.cause == "first_compile"}
    assert {"prefill", "write_prompt", "decode", "suffix_prefill"} <= keys


def test_prewarm_pins_and_the_first_request_hits():
    eng = port_engine(prefix_pages=4, suffix_bucket=8)
    eng.prewarm_prefix(SYSTEM_PROMPT)
    assert eng.prefix.pinned_pages == 2  # the full page and the tail
    r = eng.generate(shared_prefix_prompts([[7]]), max_new_tokens=4,
                     eos_token=-1)[0]
    assert r.prefix_hit_tokens == SYSTEM_PROMPT.size
    # budget pressure from unrelated traffic never evicts the pinned path
    for i in range(6):
        eng.generate([np.arange(1, 13, dtype=np.int32) + 10 * i],
                     max_new_tokens=2, eos_token=-1)
    assert eng.prefix.match(shared_prefix_prompts([[9]])[0]).matched == 11
    eng.check_invariants()


def test_prewarm_without_prefix_cache_raises():
    with pytest.raises(RuntimeError, match="prefix cache disabled"):
        port_engine().prewarm_prefix(SYSTEM_PROMPT)


def test_page_oom_mid_match_is_terminal_and_sound():
    eng = port_engine(prefix_pages=8, suffix_bucket=8)
    eng.generate(shared_prefix_prompts([[7]]), max_new_tokens=2,
                 eos_token=-1)
    faults.arm("page_oom", prob=1.0, max_fires=1)
    r = eng.generate(shared_prefix_prompts([[9]]), max_new_tokens=2,
                     eos_token=-1)[0]
    assert r.finish_reason == "oom"
    eng.check_invariants()
    # the tree kept its pages: the next request still hits
    r = eng.generate(shared_prefix_prompts([[9]]), max_new_tokens=2,
                     eos_token=-1)[0]
    assert r.prefix_hit_tokens == 11


def test_recover_clears_the_tree_and_stays_exact():
    """A decode_step_error under the threaded loop: the supervisor drops
    the tree (its pages were zeroed), retries from the prompt, and the
    stream is the cache-off stream, with no new_shape."""
    prompts = shared_prefix_prompts([[7], [9, 5]])
    want = [r.tokens.tolist() for r in port_engine().generate(
        prompts, max_new_tokens=8, eos_token=-1)]
    eng = port_engine(prefix_pages=8, suffix_bucket=8,
                      restart_backoff_s=0.0)
    eng.generate(shared_prefix_prompts([[3]]), max_new_tokens=2,
                 eos_token=-1)
    assert eng.prefix.tree_pages == 2
    before = serving_new_shape()
    faults.arm("decode_step_error", prob=1.0, after_n=2, max_fires=1)
    eng.start()
    try:
        futs = [eng.submit(p, max_new_tokens=8, eos_token=-1,
                           max_retries=2) for p in prompts]
        got = [f.result(timeout=60) for f in futs]
    finally:
        eng.stop()
    assert eng.restarts == 1
    assert [r.tokens.tolist() for r in got] == want
    assert serving_new_shape() == before
    eng.check_invariants()


def test_prefix_replay_on_cpu():
    """One small case of the replay harness: identical greedy outputs with
    the cache on and off, hits on the cache-on leg, no new_shape."""
    kw = dict(n_requests=4, n_prefixes=2, sys_len=12, tail_max=3,
              gen_tokens=3, max_prompt=16, page_size=4, suffix_bucket=4,
              warm_rounds=1, model=MODEL, device="cpu")
    on = run_prefix_replay(prefix_on=True, **kw)
    off = run_prefix_replay(prefix_on=False, **kw)
    assert on["outputs"] == off["outputs"]
    assert on["all_terminal"] and off["all_terminal"]
    assert on["hit_requests"] == 4 and off["hit_requests"] == 0
    assert on["prefix_hit_tokens"] >= 4 * 12
    assert on["new_shape_events"] == off["new_shape_events"] == 0
    assert on["ttft_p50_ms"] is not None
