"""Serving tier of the PyTorch port (CPU): paged-cache allocator, sampler
semantics, engine behaviour, and the package rules of the port.

Sampling draws come from a ``torch.Generator`` and cannot reproduce
``jax.random``; sampled slots are tested by semantics (greedy limits,
support of top-k), as ``tests/test_serving.py`` tests the JAX sampler.
"""

import ast
import math
import pathlib
import time

import numpy as np
import pytest

import torch

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.environment import environment
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, init_gpt_params, reference_generate)
from deeplearning4j_tpu_torch.serving import (
    GenerativeEngine, PagedKVCache, sample_tokens)
from deeplearning4j_tpu_torch.testing.gpt_serving import drain

REPO = pathlib.Path(__file__).resolve().parents[1]
CFG = GptConfig.tiny()
MODEL = GptModel(CFG, params=init_gpt_params(
    CFG, seed=1, std=2.0 / math.sqrt(CFG.hidden), device="cpu"),
    device="cpu")
PROMPTS = [np.array([3, 5, 7, 9], np.int32),
           np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32),
           np.array([8, 8, 8], np.int32),
           np.array([17, 23, 31], np.int32)]


def make_engine(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_pages_per_seq", 6)
    kw.setdefault("max_prompt", 16)
    kw.setdefault("seed", 3)
    return GenerativeEngine(MODEL, device="cpu", **kw)


def oracle(prompt, n):
    return reference_generate(MODEL.params, CFG, prompt, n)


# ---------------------------------------------------------------------------
# paged KV cache — allocator invariants
# ---------------------------------------------------------------------------


class TestPagedKVCache:
    def make_cache(self, **kw):
        kw.setdefault("layers", 2)
        kw.setdefault("heads", 2)
        kw.setdefault("head_dim", 8)
        kw.setdefault("page_size", 4)
        kw.setdefault("num_pages", 8)
        kw.setdefault("max_slots", 3)
        kw.setdefault("max_pages_per_seq", 4)
        kw.setdefault("device", "cpu")
        return PagedKVCache(**kw)

    def test_layout(self):
        c = self.make_cache()
        assert tuple(c.kv.shape) == (2, 2, 9, 4, 2, 8)  # +1 trash page
        assert c.trash_page == 8
        assert c.kv[1, 0].is_contiguous()  # a kernel reads it in place

    def test_alloc_grow_free_invariants(self):
        c = self.make_cache()
        assert c.ensure_capacity(0, 5) == "ok"   # 2 pages
        c.check_invariants()
        assert c.free_pages == 6 and len(c.owned[0]) == 2
        assert c.ensure_capacity(0, 6) == "ok"   # still 2 pages
        assert c.ensure_capacity(1, 9) == "ok"   # 3 pages
        c.check_invariants()
        assert c.free_slot(0) == 2 and c.free_pages == 5
        c.check_invariants()
        assert all(int(p) == c.trash_page for p in c.page_table[0])

    def test_fragmented_reuse(self):
        c = self.make_cache()
        for slot in range(3):
            assert c.ensure_capacity(slot, 8) == "ok"
        freed = set(c.owned[1])
        c.free_slot(1)
        assert c.ensure_capacity(1, 16) == "ok"  # 4 pages from a torn pool
        c.check_invariants()
        assert freed & set(c.owned[1])

    def test_overflow_and_oom_never_partial(self):
        c = self.make_cache()
        assert c.ensure_capacity(0, 17) == "overflow"  # 5 pages > 4/seq
        assert c.owned[0] == [] and c.free_pages == 8
        assert c.ensure_capacity(0, 16) == "ok"
        assert c.ensure_capacity(1, 16) == "ok"
        assert c.ensure_capacity(2, 4) == "oom"
        assert c.owned[2] == [] and c.free_pages == 0
        c.check_invariants()

    def test_refcounts_shared_and_cow(self):
        c = self.make_cache()
        assert c.ensure_capacity(0, 8) == "ok"
        shared, tail = c.owned[0]
        c.kv[:, :, tail] = 7.0
        c.map_shared(1, shared)                 # two holders
        dst = c.cow_page(1, tail)               # private copy of the tail
        assert dst not in (shared, tail)
        assert torch.equal(c.kv[:, :, dst], c.kv[:, :, tail])
        c.check_invariants(tree_refs={})
        c.free_slot(0)
        assert c.refcount[shared] == 1 and shared not in c.free
        c.free_slot(1)
        assert c.free_pages == c.num_pages
        with pytest.raises(AssertionError, match="double free"):
            c.release(shared)


# ---------------------------------------------------------------------------
# sampling semantics
# ---------------------------------------------------------------------------


class TestSampling:
    def logits(self, s=4, v=32, seed=0):
        return torch.from_numpy(np.random.RandomState(seed).randn(s, v)
                                .astype(np.float32))

    def gen(self, seed):
        return torch.Generator().manual_seed(seed)

    @pytest.mark.parametrize("temp,top_k,top_p", [
        (0.0, 0, 1.0),     # temperature 0
        (2.0, 1, 1.0),     # top_k = 1
        (2.0, 0, 1e-6),    # tiny nucleus
    ])
    def test_greedy_limits(self, temp, top_k, top_p):
        lg = self.logits()
        toks = sample_tokens(lg, self.gen(1), torch.full((4,), temp),
                             torch.full((4,), top_k, dtype=torch.int32),
                             torch.full((4,), top_p))
        assert torch.equal(toks, lg.argmax(-1))

    def test_top_k_restricts_support(self):
        lg = self.logits(s=2, v=16)
        top3 = lg.argsort(dim=-1)[:, -3:]
        for seed in range(20):
            toks = sample_tokens(lg, self.gen(seed), torch.full((2,), 1.5),
                                 torch.full((2,), 3, dtype=torch.int32),
                                 torch.ones(2))
            for row in range(2):
                assert toks[row] in top3[row]

    def test_top_p_restricts_support(self):
        """A nucleus of 0.5 on probabilities (0.4, 0.3, 0.2, 0.1) keeps
        exactly the first two tokens."""
        lg = torch.log(torch.tensor([[0.4, 0.3, 0.2, 0.1]]))
        seen = {int(sample_tokens(lg, self.gen(s), torch.ones(1),
                                  torch.zeros(1, dtype=torch.int32),
                                  torch.full((1,), 0.5))[0])
                for s in range(40)}
        assert seen == {0, 1}

    def test_slots_sample_independently(self):
        toks = sample_tokens(torch.zeros(8, 64), self.gen(5), torch.ones(8),
                             torch.zeros(8, dtype=torch.int32), torch.ones(8))
        assert len(set(toks.tolist())) > 1

    def test_mixed_greedy_and_sampled_slots(self):
        lg = self.logits()
        toks = sample_tokens(lg, self.gen(3),
                             torch.tensor([0.0, 1.0, 0.0, 1.0]),
                             torch.zeros(4, dtype=torch.int32), torch.ones(4))
        greedy = lg.argmax(-1)
        assert toks[0] == greedy[0] and toks[2] == greedy[2]

    def test_engine_seed_fixes_the_draws(self):
        def run(seed):
            eng = make_engine(seed=seed)
            return [r.tokens.tolist() for r in eng.generate(
                PROMPTS[:2], max_new_tokens=6, temperature=1.0,
                eos_token=-1)]

        assert run(7) == run(7)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class TestEngine:
    def test_midflight_admit_evict_matches_oracle(self):
        observe.reset()
        eng = make_engine()
        budgets = [3, 8, 2, 6, 4]
        results = [eng.submit(p, max_new_tokens=b, eos_token=-1)
                   for p, b in zip(PROMPTS, budgets)]
        drain(eng)
        for p, b, f in zip(PROMPTS, budgets, results):
            res = f.result(timeout=0)
            assert res.finish_reason == "length"
            np.testing.assert_array_equal(res.tokens, oracle(p, b))
        m = observe.metrics()
        assert m.counter("dl4j_tpu_serving_admitted_total").value == 5
        assert m.family_total("dl4j_tpu_serving_evicted_total") == 5
        assert m.counter(
            "dl4j_tpu_serving_generated_tokens_total").value == sum(budgets)
        spans = {e["name"] for e in observe.tracer().to_dict()["traceEvents"]}
        assert {"serving_prefill", "serving_decode"} <= spans
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_eos_finishes_early(self):
        first = int(make_engine().generate([PROMPTS[0]], max_new_tokens=3,
                                           eos_token=-1)[0].tokens[0])
        res = make_engine().generate([PROMPTS[0]], max_new_tokens=10,
                                     eos_token=first)[0]
        assert res.finish_reason == "eos" and res.tokens.size == 0

    def test_overflow_eviction(self):
        eng = make_engine(max_slots=1, page_size=4, max_pages_per_seq=3,
                          max_prompt=8)  # context cap: 12 tokens
        res = eng.generate([PROMPTS[0]], max_new_tokens=50, eos_token=-1)[0]
        assert res.finish_reason == "overflow" and res.tokens.size == 9
        np.testing.assert_array_equal(res.tokens, oracle(PROMPTS[0], 9))
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_oom_eviction_returns_pages(self):
        eng = make_engine(page_size=4, max_pages_per_seq=4, num_pages=5,
                          max_prompt=8)
        res = eng.generate([PROMPTS[0], PROMPTS[3]], max_new_tokens=12,
                           eos_token=-1)
        assert sorted(r.finish_reason for r in res) == ["length", "oom"]
        for p, r in zip([PROMPTS[0], PROMPTS[3]], res):
            np.testing.assert_array_equal(r.tokens, oracle(p, len(r.tokens)))
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_threaded_serving_loop(self):
        eng = make_engine().start()
        try:
            futs = [eng.submit(p, max_new_tokens=4, eos_token=-1)
                    for p in PROMPTS[:4]]
            for p, f in zip(PROMPTS, futs):
                np.testing.assert_array_equal(f.result(timeout=60).tokens,
                                              oracle(p, 4))
        finally:
            eng.stop()
        assert eng.stopped_cleanly
        with pytest.raises(RuntimeError, match="stopped"):
            eng.submit(PROMPTS[0])

    def test_shed_and_queue_deadline(self):
        eng = make_engine(max_queue=1)
        a = eng.submit(PROMPTS[0], max_new_tokens=2)
        shed = eng.submit(PROMPTS[1], max_new_tokens=2)
        assert shed.result(timeout=0).finish_reason == "shed"
        assert not a.done()  # still queued
        late = make_engine()
        fut = late.submit(PROMPTS[0], max_new_tokens=2, deadline_s=0.0)
        time.sleep(0.01)
        late.step()
        assert fut.result(timeout=0).finish_reason == "deadline"

    def test_validation_runs_before_any_launch(self):
        eng = make_engine()
        with pytest.raises(ValueError, match="token ids"):
            eng.submit(np.array([1, CFG.vocab_size], np.int32))
        with pytest.raises(ValueError, match="max_prompt"):
            eng.submit(np.arange(17, dtype=np.int32))
        assert not eng.scheduler.has_work()

    def test_step_failure_fails_every_request(self):
        """Forced kernel mode on CPU tensors raises inside the step; the
        unsupervised engine fails every outstanding request."""
        env = environment()
        old = env.helper_mode
        env.helper_mode = "kernel"
        try:
            eng = make_engine()
            futs = [eng.submit(p, max_new_tokens=3) for p in PROMPTS[:3]]
            with pytest.raises(RuntimeError, match="no kernel"):
                eng.generate([PROMPTS[3]], max_new_tokens=3)
        finally:
            env.helper_mode = old
        for f in futs:
            with pytest.raises(RuntimeError, match="no kernel"):
                f.result(timeout=0)
        with pytest.raises(RuntimeError, match="died"):
            eng.submit(PROMPTS[0])

    def test_default_device_engine_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            GenerativeEngine(MODEL)

    def test_paged_kv_cache_defaults_to_cuda(self, monkeypatch):
        """A cache that names no device asks for the card, as every other
        entry point does (it used to default to the CPU)."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            PagedKVCache(layers=1, heads=1, head_dim=8)
        cache = PagedKVCache(layers=1, heads=1, head_dim=8, device="cpu")
        assert cache.kv.device.type == "cpu"

    def test_init_gpt_params_defaults_to_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="is_available"):
            init_gpt_params(CFG, seed=0)
        params = init_gpt_params(CFG, seed=0, device="cpu")
        assert params["embeddings"]["word"].device.type == "cpu"

    def test_model_device_must_match(self):
        with pytest.raises(ValueError, match="live on"):
            GenerativeEngine(MODEL, device="meta")


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "deeplearning4j_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(REPO).as_posix(), mod) for f in files
           for mod in _imported_modules(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu")]
    assert bad == []
