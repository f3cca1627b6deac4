"""Fault injection of the PyTorch port against the JAX package (CPU).

Both packages' ``faults`` are driven with the same schedule, through
``arm`` or the ``DL4J_TPU_FAULTS`` environment variable (one variable:
it arms both), and must fire on exactly the same calls; plus validation,
counters, the ``fault_injected`` event, the graceful-preemption flag and
the idle fast path. No tolerance: call sequences are compared exactly.
"""

import json

import pytest

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.faults import injection

CALLS = 200


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.FAULTS_ENV, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def _fires(pkg, point, n=CALLS):
    return [pkg.should_fire(point) for _ in range(n)]


def test_catalog_and_env_name_are_the_jax_packages():
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert faults.FAULTS_ENV == jfaults.FAULTS_ENV == "DL4J_TPU_FAULTS"


@pytest.mark.parametrize("point,kw", [
    ("decode_step_error", dict(prob=0.3)),
    ("page_oom", dict(prob=0.5, seed=7, after_n=3)),
    ("preemption", dict(prob=1.0, after_n=5, max_fires=1)),
    ("worker_death", dict(prob=0.1, seed=123, max_fires=4)),
    ("checkpoint_torn_write", dict(prob=0.75, seed=2**20, after_n=11)),
])
def test_armed_schedule_fires_on_the_same_calls(point, kw):
    faults.arm(point, **kw)
    jfaults.arm(point, **kw)
    got, want = _fires(faults, point), _fires(jfaults, point)
    assert got == want
    assert any(got)
    assert faults.fire_counts() == jfaults.fire_counts() == {
        point: sum(want)}


def test_points_draw_independent_streams():
    """Two points armed with one seed draw their own streams, keyed on
    the point's name, in both packages."""
    for pkg in (faults, jfaults):
        pkg.arm("page_oom", prob=0.5, seed=1)
        pkg.arm("slow_decode", prob=0.5, seed=1)
    got = [(faults.should_fire("page_oom"), faults.should_fire("slow_decode"))
           for _ in range(CALLS)]
    want = [(jfaults.should_fire("page_oom"),
             jfaults.should_fire("slow_decode")) for _ in range(CALLS)]
    assert got == want
    assert [a for a, _ in got] != [b for _, b in got]


def test_env_schedule_fires_on_the_same_calls(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV,
                       "decode_step_error:0.4:2, page_oom:0.2,bogus:1,"
                       "slow_decode:x")
    assert faults.active() and jfaults.active()
    for point in ("decode_step_error", "page_oom", "slow_decode"):
        assert _fires(faults, point) == _fires(jfaults, point)
    assert faults.fire_counts() == jfaults.fire_counts()
    assert set(faults.fire_counts()) == {"decode_step_error", "page_oom"}
    # a changed schedule re-parses with fresh counters after reset()
    monkeypatch.setenv(faults.FAULTS_ENV, "page_oom:1:1")
    faults.reset()
    jfaults.reset()
    assert _fires(faults, "page_oom", 3) == _fires(jfaults, "page_oom", 3) \
        == [False, True, True]


def test_programmatic_arm_wins_over_the_env(monkeypatch):
    monkeypatch.setenv(faults.FAULTS_ENV, "page_oom:1")
    faults.arm("page_oom", prob=1.0, after_n=2)
    jfaults.arm("page_oom", prob=1.0, after_n=2)
    assert _fires(faults, "page_oom", 4) == _fires(jfaults, "page_oom", 4) \
        == [False, False, True, True]


@pytest.mark.parametrize("kw,match", [
    (dict(point="no_such_point"), "unknown fault point"),
    (dict(point="page_oom", prob=1.5), "prob"),
    (dict(point="page_oom", prob=-0.1), "prob"),
    (dict(point="page_oom", after_n=-1), "after_n"),
])
def test_validation_raises_as_the_jax_package(kw, match):
    for pkg in (faults, jfaults):
        with pytest.raises(ValueError, match=match):
            pkg.arm(**kw)
    assert not faults.active()


def test_disarm_and_reset():
    faults.arm("page_oom")
    faults.arm("slow_decode")
    faults.disarm("page_oom")
    assert faults.active()
    assert not faults.should_fire("page_oom")
    assert faults.should_fire("slow_decode")
    faults.reset()
    assert not faults.active() and faults.fire_counts() == {}


def test_maybe_fail_and_maybe_sleep(monkeypatch):
    faults.arm("decode_step_error", max_fires=1)
    with pytest.raises(faults.InjectedFault, match="decode_step_error") as e:
        faults.maybe_fail("decode_step_error")
    assert e.value.point == "decode_step_error"
    faults.maybe_fail("decode_step_error")  # max_fires spent: no raise
    slept = []
    monkeypatch.setattr(injection.time, "sleep", slept.append)
    faults.arm("slow_decode", after_n=1)
    faults.maybe_sleep("slow_decode", 0.05)
    faults.maybe_sleep("slow_decode", 0.05)
    assert slept == [0.05]


def test_counter_and_event(tmp_path, monkeypatch):
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv(observe.OBS_LOG_ENV, str(log))
    m = observe.metrics()
    c = m.counter("dl4j_tpu_faults_injected_total", point="worker_death")
    before = c.value
    faults.arm("worker_death", after_n=1, max_fires=2)
    assert _fires(faults, "worker_death", 5) == [False, True, True, False,
                                                 False]
    assert c.value == before + 2
    events = [json.loads(line) for line in log.read_text().splitlines()]
    assert [e["kind"] for e in events] == ["fault_injected"] * 2
    assert all(e["point"] == "worker_death" and e["ts"] > 0 for e in events)


def test_event_log_write_failure_warns_once_and_turns_off(tmp_path,
                                                          monkeypatch,
                                                          caplog):
    bad = tmp_path / "missing_dir" / "events.jsonl"
    monkeypatch.setenv(observe.OBS_LOG_ENV, str(bad))
    observe.reset_log_state()
    try:
        with caplog.at_level("WARNING"):
            observe.log_event("a")
            observe.log_event("b")
        assert sum("cannot write" in r.message for r in caplog.records) == 1
        (tmp_path / "missing_dir").mkdir()
        observe.log_event("c")  # the path stays off for this process
        assert not bad.exists()
        observe.reset_log_state()
        observe.log_event("d")
        assert [json.loads(x)["kind"] for x in
                bad.read_text().splitlines()] == ["d"]
    finally:
        observe.reset_log_state()


def test_preemption_flag():
    assert not faults.preemption_requested()
    faults.request_preemption()
    faults.request_preemption()  # idempotent
    assert faults.preemption_requested()
    faults.clear_preemption()
    assert not faults.preemption_requested()
    faults.request_preemption()
    faults.reset()
    assert not faults.preemption_requested()


def test_idle_poll_takes_no_lock():
    """Off means off: with nothing armed and the environment unset, a
    poll reads a bool and the environment, and never the lock."""
    class Forbidden:
        def __enter__(self):
            raise AssertionError("idle poll took the lock")

        def __exit__(self, *a):
            return False

    lock, injection._LOCK = injection._LOCK, Forbidden()
    try:
        for point in faults.FAULT_POINTS:
            assert not faults.should_fire(point)
            faults.maybe_fail(point)
        assert not faults.active()
    finally:
        injection._LOCK = lock
