"""Supervised recovery of the port's serving engine (CPU).

Mirrors ``tests/test_robustness.py``'s supervised-recovery, deadline and
death-path cases on ``deeplearning4j_tpu_torch``'s ``GenerativeEngine``:
a retried greedy generation emits exactly the oracle's tokens (the port's
``reference_generate``: no tolerance, token ids), recovery captures
nothing again and the ledger records no ``new_shape`` (the KV pool is
zeroed in place: ``reset_kv`` keeps the buffer's ``data_ptr``), every
submitted request reaches a terminal state, and the death paths stay
loud.
"""

import math
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.faults import InjectedFault
from deeplearning4j_tpu_torch.models.gpt import (
    GptConfig, GptModel, init_gpt_params, reference_generate)
from deeplearning4j_tpu_torch.serving import GenerativeEngine, PagedKVCache
from deeplearning4j_tpu_torch.serving.scheduler import (
    FINISH_REASONS, GenerationRequest, SlotScheduler)
from deeplearning4j_tpu_torch.testing.gpt_serving import drain

CFG = GptConfig.tiny()
MODEL = GptModel(CFG, params=init_gpt_params(
    CFG, seed=1, std=2.0 / math.sqrt(CFG.hidden), device="cpu"),
    device="cpu")
PROMPTS = [np.array([3, 5, 7, 9], np.int32),
           np.array([11, 2], np.int32),
           np.array([42, 43, 44, 45, 46, 47], np.int32)]


def make_engine(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("page_size", 8)
    kw.setdefault("max_pages_per_seq", 6)
    kw.setdefault("max_prompt", 16)
    kw.setdefault("seed", 3)
    kw.setdefault("restart_backoff_s", 0.0)
    return GenerativeEngine(MODEL, device="cpu", **kw)


def oracle(prompt, n):
    return reference_generate(MODEL.params, CFG, prompt, n)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _units(eng):
    return [u for u in (eng._prefill_fn, eng._write_fn, eng._decode_fn)
            if u is not None]


# ---------------------------------------------------------------------------
# supervised crash recovery
# ---------------------------------------------------------------------------


class TestSupervisedRecovery:
    def test_inline_decode_crash_recovers_to_oracle(self):
        faults.arm("decode_step_error", prob=1.0, after_n=1, max_fires=1)
        eng = make_engine()
        res = eng.generate(PROMPTS, max_new_tokens=5)
        for p, r in zip(PROMPTS, res):
            assert r.finish_reason == "length"
            np.testing.assert_array_equal(r.tokens, oracle(p, 5))
        assert eng.restarts == 1
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_recovery_never_recompiles(self):
        """Two crashes: the pool stays the same tensor, each step unit
        compiled once, and no ``new_shape`` in the ledger."""
        observe.reset()
        faults.arm("decode_step_error", prob=1.0, after_n=2, max_fires=2)
        eng = make_engine()
        ptr = eng.cache.kv.data_ptr()
        eng.generate(PROMPTS, max_new_tokens=4)
        assert eng.restarts == 2
        assert eng.cache.kv.data_ptr() == ptr
        serving = [e for e in observe.ledger().events()
                   if e.graph == "serving"]
        assert serving
        assert not any(e.cause == "new_shape" for e in serving)
        by_key = {}
        for ev in serving:
            by_key.setdefault(ev.key, []).append(ev.cause)
        assert by_key["decode"] == ["first_compile"], by_key
        assert all(u.captures == 0 for u in _units(eng))  # eager on CPU

    def test_reset_kv_zeroes_in_place(self):
        c = PagedKVCache(layers=1, heads=2, head_dim=4, page_size=2,
                         num_pages=3, max_slots=1, max_pages_per_seq=2,
                         device="cpu")
        c.kv.fill_(1.5)
        ptr, shape, dtype = c.kv.data_ptr(), c.kv.shape, c.kv.dtype
        view = c.kv[0, 1]
        c.reset_kv()
        assert c.kv.data_ptr() == ptr
        assert (c.kv.shape, c.kv.dtype) == (shape, dtype)
        assert not c.kv.any() and not view.any()

    def test_restart_counter_metric_and_events(self, tmp_path, monkeypatch):
        log = tmp_path / "ev.jsonl"
        monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
        observe.reset()
        faults.arm("decode_step_error", prob=1.0, max_fires=1)
        eng = make_engine()
        eng.generate([PROMPTS[0]], max_new_tokens=3)
        assert eng.restarts == 1
        m = observe.metrics()
        assert m.counter("dl4j_tpu_serving_engine_restarts_total").value == 1
        assert m.counter("dl4j_tpu_serving_retries_total").value == 1
        assert '"kind": "engine_restart"' in log.read_text()

    def test_retry_budget_exhausted_is_error_result(self, tmp_path,
                                                    monkeypatch):
        log = tmp_path / "ev.jsonl"
        monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
        faults.arm("decode_step_error", prob=1.0, max_fires=2)
        eng = make_engine(max_slots=1)
        res = eng.generate([PROMPTS[0]], max_new_tokens=4, max_retries=1)[0]
        assert res.finish_reason == "error"
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages
        assert '"reason": "error"' in log.read_text()

    def test_restart_budget_exhausted_raises_inline(self):
        faults.arm("decode_step_error", prob=1.0)  # every step
        eng = make_engine(max_restarts=2)
        with pytest.raises(InjectedFault, match="decode_step_error"):
            eng.generate([PROMPTS[0]], max_new_tokens=4, max_retries=100)
        assert eng.restarts == 2
        with pytest.raises(RuntimeError, match="died"):
            eng.submit(PROMPTS[1])

    def test_unsupervised_engine_keeps_old_contract(self):
        faults.arm("decode_step_error", prob=1.0, max_fires=1)
        eng = make_engine(supervise=False)
        with pytest.raises(InjectedFault):
            eng.generate([PROMPTS[0]], max_new_tokens=4)
        assert eng.restarts == 0

    def test_backoff_doubles_and_is_capped(self, monkeypatch):
        from deeplearning4j_tpu_torch.serving import engine as engine_mod

        slept = []
        monkeypatch.setattr(engine_mod.time, "sleep", slept.append)
        faults.arm("decode_step_error", prob=1.0, max_fires=3)
        eng = make_engine(max_slots=1, restart_backoff_s=0.5,
                          max_backoff_s=1.5)
        res = eng.generate([PROMPTS[0]], max_new_tokens=3, max_retries=5)
        assert res[0].finish_reason == "length"
        assert slept == [0.5, 1.0, 1.5]

    def test_threaded_worker_death_restarts_and_serves(self):
        faults.arm("worker_death", prob=1.0, max_fires=1)
        eng = make_engine().start()
        ident0 = eng._worker.ident
        try:
            res = eng.submit(PROMPTS[0], max_new_tokens=4).result(
                timeout=120)
            np.testing.assert_array_equal(res.tokens, oracle(PROMPTS[0], 4))
            assert eng._worker.ident != ident0  # a replacement thread
        finally:
            eng.stop()
        assert eng.restarts == 1
        assert eng._worker is None and eng.stopped_cleanly

    def test_threaded_decode_crash_retries_active_requests(self):
        """A decode crash with two requests active: both go back to the
        queue, both finish with the oracle's tokens, two retries."""
        observe.reset()
        faults.arm("decode_step_error", prob=1.0, after_n=2, max_fires=1)
        eng = make_engine().start()
        try:
            futs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[:2]]
            for p, f in zip(PROMPTS, futs):
                np.testing.assert_array_equal(f.result(timeout=120).tokens,
                                              oracle(p, 6))
        finally:
            eng.stop()
        assert eng.restarts == 1
        assert observe.metrics().counter(
            "dl4j_tpu_serving_retries_total").value == 2

    def test_engine_death_is_unrestartable(self):
        faults.arm("engine_death", prob=1.0, max_fires=1)
        eng = make_engine().start()
        fut = eng.submit(PROMPTS[0], max_new_tokens=4)
        with pytest.raises(InjectedFault, match="engine_death"):
            fut.result(timeout=120)
        assert eng.restarts == eng.max_restarts
        eng.stop()

    def test_threaded_unsupervised_crash_propagates_to_callers(self):
        faults.arm("decode_step_error", prob=1.0, max_fires=1)
        eng = make_engine(supervise=False).start()
        fut = eng.submit(PROMPTS[0], max_new_tokens=8)
        with pytest.raises(InjectedFault):
            fut.result(timeout=120)
        with pytest.raises(RuntimeError, match="died"):
            for _ in range(100):
                eng.submit(PROMPTS[1])
                time.sleep(0.01)
        eng.stop()


# ---------------------------------------------------------------------------
# deadlines, shedding, injected pool pressure
# ---------------------------------------------------------------------------


class TestDeadlinesAndShedding:
    def test_active_deadline_retires_with_partial_tokens(self):
        faults.arm("slow_decode", prob=1.0)  # +50 ms a decode step
        eng = make_engine(max_slots=1)
        fut = eng.submit(PROMPTS[0], max_new_tokens=50, deadline_s=0.12)
        drain(eng)
        res = fut.result(timeout=0)
        assert res.finish_reason == "deadline"
        assert res.tokens.size >= 1
        np.testing.assert_array_equal(res.tokens,
                                      oracle(PROMPTS[0], len(res.tokens)))
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_injected_page_oom_is_terminal_oom(self):
        faults.arm("page_oom", prob=1.0, max_fires=1)
        eng = make_engine(max_slots=1)
        res = eng.generate([PROMPTS[0], PROMPTS[1]], max_new_tokens=6)
        assert [r.finish_reason for r in res] == ["oom", "length"]
        assert res[0].tokens.size == 0
        np.testing.assert_array_equal(res[1].tokens, oracle(PROMPTS[1], 6))
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_request_validation(self):
        with pytest.raises(ValueError, match="deadline_s"):
            GenerationRequest(prompt=PROMPTS[0], deadline_s=-1.0)
        with pytest.raises(ValueError, match="max_retries"):
            GenerationRequest(prompt=PROMPTS[0], max_retries=-1)

    def test_prefill_crash_does_not_strand_request(self, monkeypatch):
        eng = make_engine(max_slots=1)
        real = eng._prefill_into
        calls = {"n": 0}

        def flaky(slot, req):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected prefill crash")
            return real(slot, req)

        monkeypatch.setattr(eng, "_prefill_into", flaky)
        res = eng.generate([PROMPTS[0]], max_new_tokens=3)[0]
        assert res.finish_reason == "length"
        np.testing.assert_array_equal(res.tokens, oracle(PROMPTS[0], 3))
        assert eng.restarts == 1
        eng.check_invariants()
        assert eng.cache.free_pages == eng.cache.num_pages

    def test_wall_clock_jump_cannot_expire_deadlines(self, monkeypatch):
        real_time = time.time
        monkeypatch.setattr(time, "time",
                            lambda: real_time() + 365 * 24 * 3600.0)
        eng = make_engine(max_slots=1)
        res = eng.generate([PROMPTS[0]], max_new_tokens=4,
                           deadline_s=120.0)[0]
        assert res.finish_reason == "length"
        assert res.tokens.size == 4


# ---------------------------------------------------------------------------
# death paths
# ---------------------------------------------------------------------------


class TestDeathPaths:
    def test_fail_all_drains_pending_submits(self):
        sched = SlotScheduler(max_slots=2)
        futs = [sched.submit(GenerationRequest(prompt=p)) for p in PROMPTS]
        sched.fail_all(RuntimeError("engine died"))
        assert not sched.pending and not sched.slots
        for f in futs:
            with pytest.raises(RuntimeError, match="engine died"):
                f.result(timeout=0)

    def test_fail_pending_leaves_active_slots_alone(self):
        sched = SlotScheduler(max_slots=2)
        active_fut: "Future" = Future()
        sched.admit(0, GenerationRequest(prompt=PROMPTS[0]), active_fut,
                    submit_t=0.0, first_token=1, now=0.0)
        queued = sched.submit(GenerationRequest(prompt=PROMPTS[1]))
        sched.fail_pending(RuntimeError("stop hung"))
        with pytest.raises(RuntimeError):
            queued.result(timeout=0)
        assert not active_fut.done()
        assert 0 in sched.slots

    def test_stop_detects_hung_worker(self):
        observe.reset()
        eng = make_engine().start()
        release = threading.Event()

        def stuck_step():
            release.wait(5.0)
            return 0

        eng.step = stuck_step
        fut = eng.submit(PROMPTS[0], max_new_tokens=4)
        time.sleep(0.05)
        eng.stop(timeout=0.2)
        assert eng.stopped_cleanly is False
        assert observe.metrics().gauge(
            "dl4j_tpu_serving_stopped_cleanly").value == 0.0
        assert eng._worker is not None
        with pytest.raises(RuntimeError, match="stopped"):
            eng.submit(PROMPTS[1])
        with pytest.raises(RuntimeError):
            fut.result(timeout=0)
        release.set()
        eng._worker.join(timeout=10)
        assert not eng._worker.is_alive()

    def test_clean_stop_sets_gauge_one(self):
        observe.reset()
        eng = make_engine().start()
        eng.stop()
        assert eng.stopped_cleanly
        assert observe.metrics().gauge(
            "dl4j_tpu_serving_stopped_cleanly").value == 1.0

    def test_finish_reasons_cover_the_recovery_outcomes(self):
        assert {"error", "shed", "deadline", "oom",
                "stopped"} <= set(FINISH_REASONS)
