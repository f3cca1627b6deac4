"""Cluster router of the PyTorch port (CPU).

Two port engines on the CPU behind one :class:`ClusterRouter`: routing by
prefix affinity and load, quarantine, and — the property the router is
for — an ``engine_death`` on one engine migrates its retryable requests
to the survivor, whose greedy streams equal the JAX engine's on the same
carried weights, with no ``new_shape`` on the survivor. Then the router
behind the SLO frontend, whose circuit breaker is per engine.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import serving as jserving
from deeplearning4j_tpu.models import gpt as jgpt
from deeplearning4j_tpu.serving import GenerativeEngine as JaxEngine
from deeplearning4j_tpu_torch import serving as tserving
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.faults import InjectedFault
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import (
    ClusterRouter, GenerativeEngine, SLOFrontend)
from deeplearning4j_tpu_torch.serving.overload import (
    _serving_new_shape_count)
from deeplearning4j_tpu_torch.testing.gpt_serving import (
    SYSTEM_PROMPT, drain, numpy_gpt_params, shared_prefix_prompts,
    tiny_config)

CFG = tiny_config()
NP_PARAMS = numpy_gpt_params(CFG)
MODEL = tgpt.GptModel(CFG, params=tgpt.params_from_numpy(
    NP_PARAMS, device="cpu"), device="cpu")
ENGINE_KW = dict(max_slots=2, page_size=8, max_pages_per_seq=6,
                 max_prompt=24, seed=3, restart_backoff_s=0.0)
PROMPTS = [np.arange(1, 9, dtype=np.int32) + i for i in range(6)]


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()


def make_router(n=2, router_kw=None, **kw):
    engines = [GenerativeEngine(MODEL, device="cpu",
                                **dict(ENGINE_KW, **kw)) for _ in range(n)]
    return ClusterRouter(engines, **(router_kw or {}))


def evicted_total():
    return sum(int(i.value) for i in observe.metrics().instruments()
               if i.name == "dl4j_tpu_serving_evicted_total" and i.labels)


def test_engines_renumbered_and_least_loaded_wins():
    r = make_router(3)
    assert [e.engine_id for e in r.engines] == [0, 1, 2]
    r.engines[0].submit(PROMPTS[0], max_new_tokens=2)
    r.engines[1].submit(PROMPTS[1], max_new_tokens=2)
    eng, reason, _aff, _load = r._select(
        r.engines[0].scheduler.pending_snapshot()[0][0])
    assert eng is r.engines[2] and reason == "load"


def test_prefix_affinity_routes_to_the_cached_engine():
    r = make_router(2, prefix_pages=4, suffix_bucket=8)
    r.engines[1].generate(shared_prefix_prompts([[3]]), max_new_tokens=2,
                          eos_token=-1)
    fut = r.submit(shared_prefix_prompts([[7]])[0], max_new_tokens=3,
                   eos_token=-1)
    assert r.engines[1].scheduler.pending_snapshot()[0][1] is fut
    drain(r.engines[1])
    assert fut.result(timeout=0).prefix_hit_tokens == SYSTEM_PROMPT.size
    # affinity yields to load past the imbalance cap
    for p in PROMPTS:
        r.engines[1].submit(p, max_new_tokens=2)
    sel = r._select(r.engines[1].scheduler.pending_snapshot()[0][0])
    assert sel[0] is r.engines[0]


def test_restart_thrash_quarantines_but_never_strands():
    r = make_router(2, router_kw=dict(quarantine_restarts=2,
                                      quarantine_window_s=30.0,
                                      quarantine_cooldown_s=60.0))
    r.engines[0].restarts = 2
    assert r._routable() == [r.engines[1]]
    r.engines[1].restarts = 2
    assert len(r._routable()) == 2  # everyone quarantined: both serve


def test_engine_death_migrates_and_keeps_the_jax_tokens():
    """engine_death hard-kills engine 0 mid-flight (its loop runs alone
    until then, so the fault lands on it): every request terminal, its
    in-flight requests migrated, each stream the JAX engine's greedy
    stream, no new_shape on the survivor, and one terminal count per
    request."""
    want = JaxEngine(jgpt.GptModel(CFG, params=jax.tree.map(
        jnp.asarray, NP_PARAMS)), **ENGINE_KW).generate(
            PROMPTS, max_new_tokens=6, eos_token=-1)
    r = make_router(2)
    e0, e1 = r.engines
    for e in r.engines:  # capture before the faults are armed
        e.generate([PROMPTS[0]], max_new_tokens=2, eos_token=-1)
    before_terminal = evicted_total()
    new_shape0 = _serving_new_shape_count()
    faults.arm("engine_death", prob=1.0, after_n=3, max_fires=1)
    e0.start()
    try:
        futs = [r.submit(p, max_new_tokens=6, eos_token=-1, max_retries=3)
                for p in PROMPTS]
        deadline = time.perf_counter() + 60
        while e0._error is None and time.perf_counter() < deadline:
            time.sleep(0.005)
        e1.start()
        res = [f.result(timeout=120) for f in futs]
        live = r.live_engines()
    finally:
        r.stop()
    assert isinstance(e0._error, InjectedFault)
    assert r.deaths == 1 and live == [e1]
    assert r.migrations >= 2
    for got, w in zip(res, want):
        assert got.finish_reason == "length"
        assert got.tokens.tolist() == w.tokens.tolist()
    assert _serving_new_shape_count() == new_shape0
    assert evicted_total() == before_terminal + len(PROMPTS)
    r.check_invariants()


def test_migration_keeps_submit_time_priority_and_charges_a_retry():
    r = make_router(2)
    e0, e1 = r.engines
    fut = e0.submit(PROMPTS[0], max_new_tokens=64, eos_token=-1,
                    deadline_s=0.25, max_retries=2, priority=0)
    second = e0.submit(PROMPTS[1], max_new_tokens=4)
    e0.step()  # both admitted: in flight on the two slots
    e0.submit(PROMPTS[2], max_new_tokens=4)
    e0.submit(PROMPTS[3], max_new_tokens=4)
    st = e0.scheduler.slots[0]
    r._on_engine_death(e0, RuntimeError("boom"))
    items = e1.scheduler.pending_snapshot()
    assert items[0][1] is fut and items[0][2] == st.submit_t
    assert items[0][0].priority == 0 and items[0][0].retries_used == 1
    assert items[1][1] is second and items[1][0].retries_used == 1
    # the queued ones migrate behind them without a retry charge
    assert [it[0].retries_used for it in items[2:]] == [0, 0]
    while time.perf_counter() - st.submit_t <= 0.25:
        time.sleep(0.01)
    e1.step()
    assert fut.result(timeout=10).finish_reason == "deadline"


def test_no_survivor_fails_every_request_terminally():
    r = make_router(1)
    futs = [r.engines[0].submit(p, max_new_tokens=4) for p in PROMPTS[:3]]
    r._on_engine_death(r.engines[0], RuntimeError("boom"))
    assert all(f.result(timeout=10).finish_reason == "error" for f in futs)


def test_pinned_prefix_rewarms_on_the_destination():
    r = make_router(2, prefix_pages=4, suffix_bucket=8)
    r.prewarm_prefix(SYSTEM_PROMPT)
    e0, e1 = r.engines
    assert e0.prefix.pinned_pages == e1.prefix.pinned_pages == 2
    e1.prefix.clear()  # the survivor lost its tree; the intent survives
    e0.submit(PROMPTS[0], max_new_tokens=2)
    r._on_engine_death(e0, RuntimeError("boom"))
    drain(e1)
    assert e1.prefix.pinned_pages == 2
    r.check_invariants()


def test_frontend_breaker_is_per_engine():
    r = make_router(2)
    fe = SLOFrontend(r, breaker_restarts=2, breaker_window_s=60.0,
                     breaker_cooldown_s=60.0)
    r.engines[0].restarts = 2
    fut = fe.submit(PROMPTS[0], max_new_tokens=2, eos_token=-1)
    assert not fut.done() and not fe.breaker_open  # engine 1 still serves
    r.engines[1].restarts = 2
    fut2 = fe.submit(PROMPTS[1], max_new_tokens=2, eos_token=-1)
    assert fe.breaker_open
    assert fut2.result(timeout=0).finish_reason == "error"
    assert r.scheduler.max_slots == 4
    r._on_engine_death(r.engines[0], RuntimeError("boom"))
    assert r.scheduler.max_slots == 2  # capacity follows the live engines


def test_serving_exports_every_jax_name():
    assert set(jserving.__all__) <= set(tserving.__all__)
    for name in tserving.__all__:
        assert getattr(tserving, name) is not None
