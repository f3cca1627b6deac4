"""SLO frontend of the PyTorch port against the JAX package (CPU).

The frontend is host policy. On one schedule of arrivals, clock advances,
decode-latency samples, admissions, completions and engine restarts —
driven by a fake clock, so no decision depends on how fast this host runs
— the port's :class:`SLOFrontend` and the JAX one make the same admit,
shed and degrade decisions, go through the same ladder transitions and
open the same circuit breaker. Each side steers a stub engine built on its
own package's ``SlotScheduler`` (the engine surface the frontend reads,
without the device), and reads its own package's decode histogram. Then
the frontend over the port's engine on the CPU: shared-prefix pre-warm,
the burst fault, and one small overload ramp.
"""

import types

import numpy as np
import pytest

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu import observe as jobserve
from deeplearning4j_tpu.serving import frontend as jfrontend
from deeplearning4j_tpu.serving import scheduler as jscheduler
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.models import gpt as tgpt
from deeplearning4j_tpu_torch.serving import (
    OVERLOAD_STATES, ClassPolicy, GenerativeEngine, LadderThresholds,
    SLOFrontend, default_classes, frontend as tfrontend,
    scheduler as tscheduler)
from deeplearning4j_tpu_torch.serving.overload import run_overload_ramp
from deeplearning4j_tpu_torch.testing.gpt_serving import (
    SYSTEM_PROMPT, numpy_gpt_params, shared_prefix_prompts, tiny_config)

CFG = tiny_config()
MODEL = tgpt.GptModel(CFG, params=tgpt.params_from_numpy(
    numpy_gpt_params(CFG), device="cpu"), device="cpu")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for f in (faults, jfaults):
        monkeypatch.delenv(f.FAULTS_ENV, raising=False)
        f.reset()
    observe.reset()
    jobserve.reset()
    yield
    faults.reset()
    jfaults.reset()


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


class StubEngine:
    """The engine surface the frontend touches, over a package's real
    ``SlotScheduler``: a restarts counter and a ``submit_request`` that
    queues without serving."""

    def __init__(self, scheduler_mod, max_slots=2):
        self.scheduler = scheduler_mod.SlotScheduler(max_slots)
        self.restarts = 0
        self.max_restarts = 3
        self.cfg = types.SimpleNamespace(eos_token=-1, vocab_size=64)
        self.default_deadline_s = None
        self.submitted = []

    def validate_request(self, req):
        pass

    def submit_request(self, req):
        self.submitted.append(req)
        return self.scheduler.submit(req)


def _schedule(seed):
    """(op, args) events: arrivals of every class with and without
    deadlines, clock advances, decode-latency samples (the ladder's p99),
    admissions, completions and engine restarts."""
    r = np.random.RandomState(seed)
    events = []
    for _ in range(120):
        op = r.choice(["submit", "submit", "submit", "tick", "lat", "admit",
                       "finish", "crash"],
                      p=[.2, .2, .15, .12, .12, .09, .09, .03])
        if op == "submit":
            cls = ["interactive", "standard", "batch"][r.randint(3)]
            deadline = [None, 0.05, 0.5, 5.0][r.randint(4)]
            events.append(("submit", (cls, int(r.randint(1, 40)), deadline,
                                      int(r.randint(0, 3)) * 10)))
        elif op == "tick":
            events.append(("tick", float(r.choice([0.01, 0.3, 2.0, 6.0]))))
        elif op == "lat":
            events.append(("lat", [float(x) for x in
                                   r.choice([0.002, 0.03, 0.3, 1.5], 6)]))
        else:
            events.append((op, int(r.randint(1, 3))))
    return events


def _drive(frontend_mod, scheduler_mod, obs, events):
    """Run ``events`` through one package's frontend; returns the decision
    trace, the shed counts and the transition counts."""
    clock = FakeClock()
    eng = StubEngine(scheduler_mod)
    classes = frontend_mod.default_classes()
    classes["interactive"].max_concurrent = 4
    classes["standard"].rate, classes["standard"].burst = 1.5, 3
    classes["standard"].disable_spec = True
    classes["batch"].max_queued = 4
    fe = frontend_mod.SLOFrontend(
        eng, classes=classes, max_queue_total=7, degraded_max_new_tokens=6,
        est_decode_s=0.004, breaker_restarts=2, breaker_window_s=10.0,
        breaker_cooldown_s=4.0, clock=clock,
        thresholds=frontend_mod.LadderThresholds(
            degraded_queue=3, shedding_queue=6, degraded_p99_s=0.1,
            shedding_p99_s=1.0))
    hist = obs.metrics().histogram("dl4j_tpu_serving_decode_step_seconds")
    sched, trace, futs = eng.scheduler, [], []
    for op, arg in events:
        if op == "submit":
            cls, n_new, deadline, top_k = arg
            fut = fe.submit(np.array([3, 5, 7], np.int32), slo_class=cls,
                            max_new_tokens=n_new, deadline_s=deadline,
                            top_k=top_k)
            futs.append(fut)
            res = fut.result(timeout=0) if fut.done() else None
            req = eng.submitted[-1] if not fut.done() else None
            trace.append((
                "submit", fe.state, None if res is None else
                (res.finish_reason, res.degraded, res.spec_disabled),
                None if req is None else
                (req.max_new_tokens, req.top_k, req.degraded,
                 req.spec_disabled, req.priority)))
        elif op == "tick":
            clock.t += arg
        elif op == "lat":
            for x in arg:
                hist.observe(x)
        elif op == "admit":
            for _ in range(arg):
                free = sched.free_slot_ids()
                item = sched.peek_best_pending()
                if not free or item is None:
                    break
                sched.remove_pending(item)
                sched.admit(free[0], item[0], item[1], item[2], 1, clock.t)
            trace.append(("admit", sorted(
                st.request.slo_class for st in sched.slots.values())))
        elif op == "finish":
            for slot in sched.active_slots()[:arg]:
                sched.retire(slot, "length")
        else:
            eng.restarts += arg
            trace.append(("breaker", fe.breaker_open))
    trace.append(("end", fe.snapshot()["inflight"], fe.breaker_opens,
                  sorted(fe.states_visited),
                  [f.done() for f in futs]))
    sheds, trans = {}, {}
    for inst in obs.metrics().instruments():
        lbl = dict(inst.labels)
        if inst.name == "dl4j_tpu_slo_shed_total" and inst.value:
            sheds[(lbl["class"], lbl["reason"])] = int(inst.value)
        if inst.name == "dl4j_tpu_slo_transitions_total" and inst.value:
            trans[lbl["to"]] = int(inst.value)
    return trace, sheds, trans


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_decisions_and_ladder_match_jax_on_one_schedule(seed):
    events = _schedule(seed)
    want = _drive(jfrontend, jscheduler, jobserve, events)
    got = _drive(tfrontend, tscheduler, observe, events)
    assert got == want
    trace, sheds, trans = got
    # the schedule reaches the interesting arms
    reasons = {reason for _cls, reason in sheds}
    assert len(reasons) >= 3, sheds
    assert trans, "the ladder never moved"


def test_public_names_and_policy_validation_match_jax():
    assert OVERLOAD_STATES == jfrontend.OVERLOAD_STATES
    assert tfrontend.SHED_REASONS == jfrontend.SHED_REASONS
    assert ({k: vars(v) for k, v in default_classes().items()}
            == {k: vars(v) for k, v in jfrontend.default_classes().items()})
    assert vars(LadderThresholds()) == vars(jfrontend.LadderThresholds())
    for bad in (dict(priority=-1), dict(rate=0.0), dict(burst=0)):
        with pytest.raises(ValueError):
            ClassPolicy("x", **dict(dict(priority=1), **bad))
        with pytest.raises(ValueError):
            jfrontend.ClassPolicy("x", **dict(dict(priority=1), **bad))


# ---------------------------------------------------------------------------
# over the port's engine
# ---------------------------------------------------------------------------


def port_engine(**kw):
    return GenerativeEngine(MODEL, device="cpu", max_slots=2, page_size=8,
                            max_pages_per_seq=6, max_prompt=24, seed=3, **kw)


def test_shared_prefix_class_is_prewarmed_and_pinned():
    classes = default_classes()
    classes["interactive"].shared_prefix = SYSTEM_PROMPT
    eng = port_engine(prefix_pages=4, suffix_bucket=8)
    SLOFrontend(eng, classes=classes)
    assert eng.prefix.pinned_pages == 2
    eng.start()
    try:
        fe = SLOFrontend(eng, classes=classes)
        fut = fe.submit(shared_prefix_prompts([[7]])[0],
                        slo_class="interactive", max_new_tokens=4,
                        eos_token=-1)
        res = fut.result(timeout=60)
    finally:
        eng.stop()
    assert res.finish_reason == "length"
    assert res.prefix_hit_tokens == SYSTEM_PROMPT.size
    assert res.slo_class == "interactive"
    eng.check_invariants()


def test_burst_fault_and_degraded_results_are_terminal():
    eng = port_engine()
    fe = SLOFrontend(eng, degraded_max_new_tokens=2, burst_size=3)
    fe._signals = lambda: (100, None)  # shedding-level pressure
    faults.arm("burst_arrival", prob=1.0, max_fires=1)
    eng.start()
    try:
        futs = [fe.submit(np.array([3, 5, 7], np.int32), slo_class=c,
                          max_new_tokens=6, eos_token=-1)
                for c in ("standard", "interactive", "batch")]
        res = [f.result(timeout=60) for f in futs]
        burst = [f.result(timeout=60) for f in fe.burst_futures]
    finally:
        eng.stop()
    assert len(burst) == 3 and all(r.finish_reason == "shed" for r in burst)
    std, itx, batch = res
    assert std.degraded and std.tokens.size == 2
    assert not itx.degraded and itx.tokens.size == 6
    assert batch.finish_reason == "shed"
    assert fe.state == "shedding"


def test_overload_ramp_on_cpu():
    """One small ramp, both legs on one offered schedule: every request
    terminal, no new_shape across the ladder's transitions."""
    on = run_overload_ramp(frontend_on=True, n_requests=10, gen_tokens=4,
                           max_slots=2, device="cpu")
    off = run_overload_ramp(
        frontend_on=False, n_requests=10, gen_tokens=4, max_slots=2,
        device="cpu",
        capacity_tokens_per_sec=on["capacity_tokens_per_sec"])
    for leg in (on, off):
        assert leg["all_terminal"]
        assert leg["new_shape_events"] == 0
        assert (sum(leg["reasons"].values())
                == leg["requests"] + leg["burst_requests"])
    # one offered rate (each leg rounds the capacity it was handed)
    assert on["offered_rps"] == pytest.approx(off["offered_rps"], rel=1e-3)
    assert "states_visited" in on and "frontend" in on
