"""The serving engine's warm boot from the export cache
(``serving/aot.py``) on the CPU: ``tests/test_export.py``'s engine case,
and the warm-booted engine held to the JAX engine.

* A randomized replay (prefix cache and speculation armed) cold, then
  populating the cache, then warm in a config-identical engine: the
  tokens equal across the three legs, the warm leg's ledger without a
  serving ``first_compile``, every step a ``cache_hit``, no ``new_shape``.
* Sampled tokens: the draws stay outside the exported programs, so a
  warm-booted engine samples what a plain engine samples from the same
  seed, bit for bit.
* The engine is inert without ``$DL4J_TPU_COMPILE_CACHE``; ``_recover``
  keeps the units it has; the fingerprint separates geometries.
* Greedy tokens of a populating and a warm-booted engine against the JAX
  engine's (``testing/gpt_serving.py``'s weights: the top two logits are
  well separated, so equal tokens are the check, not a tolerance).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.autodiff import export as aot
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import GenerativeEngine
from deeplearning4j_tpu_torch.serving import aot as serving_aot
from deeplearning4j_tpu_torch.serving.replay import run_randomized_replay
from deeplearning4j_tpu_torch.testing.gpt_serving import (
    TINY, numpy_gpt_params, tiny_config)

CFG = tiny_config()
NP_PARAMS = numpy_gpt_params(CFG)
KW = dict(max_slots=2, page_size=8, max_pages_per_seq=6, max_prompt=16,
          seed=3)
PROMPTS = [np.array([3, 5, 7, 9], np.int32), np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32)]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(aot.ENV_DIR, raising=False)
    observe.reset()
    aot.reset_export_cache()
    yield
    observe.reset()
    aot.reset_export_cache()


def _engine(**kw):
    model = tgpt.GptModel(CFG, params=tgpt.params_from_numpy(
        NP_PARAMS, device="cpu"), device="cpu")
    return GenerativeEngine(model, device="cpu", **dict(KW, **kw))


def _serving_causes(start):
    return [(e.key, e.cause) for e in observe.ledger().events()[start:]
            if e.graph == "serving"]


def test_replay_over_restored_engine_is_clean(tmp_path, monkeypatch):
    cold = run_randomized_replay(n_requests=4, seed=3, device="cpu")
    assert cold["all_terminal"]
    monkeypatch.setenv(aot.ENV_DIR, str(tmp_path))
    populate = run_randomized_replay(n_requests=4, seed=3, device="cpu")
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs
             if f.endswith(".json")]
    assert len(files) == 7  # prefill .. draft_decode: every step a file
    warm = run_randomized_replay(n_requests=4, seed=3, device="cpu")
    assert warm["all_terminal"]
    assert warm["first_compile_keys"] == [], warm["first_compile_keys"]
    assert warm["cache_hit_keys"], "the warm leg restored nothing"
    assert warm["new_shape_events"] == populate["new_shape_events"] == 0
    assert warm["outputs"] == populate["outputs"] == cold["outputs"]
    assert sorted(populate["aot"]["exported"]) == sorted(
        warm["aot"]["restored"])
    assert all(n > 0 for n in warm["aot"]["bytes"].values())


def test_sampled_tokens_equal_a_plain_engine(tmp_path):
    cache = aot.ExportCache(str(tmp_path))
    kw = dict(max_new_tokens=6, temperature=0.9, top_k=20, top_p=0.9,
              eos_token=-1)
    plain = _engine().generate(PROMPTS, **kw)
    serving_aot.warm_boot(_engine(), cache=cache)
    warm = _engine()
    assert sorted(serving_aot.warm_boot(warm, cache=cache)["restored"]) == [
        "decode", "prefill", "write_prompt"]
    got = warm.generate(PROMPTS, **kw)
    for a, b in zip(plain, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)


def test_engine_is_inert_without_the_variable(tmp_path):
    eng = _engine()
    assert eng.aot_boot["restored"] == eng.aot_boot["exported"] == []
    assert eng._prefill_fn is None and eng._decode_fn is None
    assert serving_aot.maybe_warm_boot(eng)["fingerprint"] is None
    assert list(tmp_path.iterdir()) == []


def test_recover_keeps_the_units_it_has(tmp_path, monkeypatch):
    monkeypatch.setenv(aot.ENV_DIR, str(tmp_path))
    eng = _engine(max_restarts=2, restart_backoff_s=0.0)
    units = (eng._prefill_fn, eng._write_fn, eng._decode_fn)
    assert None not in units and eng.aot_boot["exported"]
    eng.generate(PROMPTS[:1], max_new_tokens=3, eos_token=-1)
    assert eng._recover(RuntimeError("injected"))
    assert (eng._prefill_fn, eng._write_fn, eng._decode_fn) == units


def test_fingerprint_separates_geometries():
    assert serving_aot.engine_fingerprint(_engine()) == \
        serving_aot.engine_fingerprint(_engine())
    assert serving_aot.engine_fingerprint(_engine()) != \
        serving_aot.engine_fingerprint(_engine(max_prompt=24))


def test_warm_booted_greedy_tokens_match_the_jax_engine(tmp_path):
    jeng = JaxEngine(jgpt.GptModel(jgpt.GptConfig.tiny(**TINY),
                                  params=jax.tree.map(jnp.asarray,
                                                      NP_PARAMS)), **KW)
    want = jeng.generate(PROMPTS, max_new_tokens=6, eos_token=-1)
    cache = aot.ExportCache(str(tmp_path))
    for leg in ("populating", "warm"):
        eng = _engine()
        start = len(observe.ledger().events())
        serving_aot.warm_boot(eng, cache=cache)
        got = eng.generate(PROMPTS, max_new_tokens=6, eos_token=-1)
        for w, g in zip(want, got):
            assert g.finish_reason == w.finish_reason == "length"
            np.testing.assert_array_equal(g.tokens, w.tokens)
        causes = {c for _, c in _serving_causes(start)}
        assert causes == ({"first_compile"} if leg == "populating"
                          else {"cache_hit"}), (leg, causes)
