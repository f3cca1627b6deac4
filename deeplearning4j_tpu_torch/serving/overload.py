"""Goodput-under-overload ramp — the SLO frontend's success metric.

Counterpart of ``deeplearning4j_tpu/serving/overload.py``: drive a fresh
:class:`GenerativeEngine` with an OPEN-LOOP arrival stream past its
measured capacity and report **goodput** — tokens of requests that
completed (``eos``/``length``) WITHIN their deadline, per second of wall
time. Tokens decoded for a request that missed its deadline are work the
card did and the user never saw; goodput is the number that punishes it.

The ramp runs once with the :class:`SLOFrontend` in front of the engine
and once with raw ``engine.submit`` — same seed, prompts, class mix,
deadlines and offered schedule (the second leg reuses the first leg's
measured capacity, so both see one arrival rate). The frontend leg should
win: predictive early shed refuses work that cannot meet its deadline
before it costs decode steps, priority ordering keeps interactive TTFT
flat while batch sheds, and the degradation ladder trades answer length
for deadline hits. The baseline leg still expires queued requests at
their deadline.

Every request (frontend burst injections too) must reach a terminal
state, and the recompile ledger must show no ``new_shape`` serving event
across the degradation transitions. The engine runs on ``device`` (the
card unless the caller asks for the CPU, as the tests do).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from deeplearning4j_tpu_torch import observe

#: (class name, mix weight, deadline multiplier on the base deadline).
#: Interactive gets the tight deadline, batch 2.5× the slack — the mix a
#: chat product with a background lane actually sees. Interactive alone
#: fits inside capacity (0.3 × overload factor < 1 for factors < ~3.3),
#: so a frontend that PRIORITIZES can meet its deadlines while the FIFO
#: baseline drowns every class equally; deadlines are tight enough that
#: a deep queue position is genuinely hopeless, so early sheds cost no
#: goodput.
DEFAULT_MIX = (("interactive", 0.3, 1.0),
               ("standard", 0.3, 1.5),
               ("batch", 0.4, 2.5))


def _serving_new_shape_count() -> int:
    return sum(1 for e in observe.ledger().events()
               if e.graph == "serving" and e.cause == "new_shape")


def run_overload_ramp(*, frontend_on: bool, n_requests: int = 24,
                      gen_tokens: int = 12, max_slots: int = 2,
                      overload_factor: float = 2.5,
                      deadline_slack: float = 2.0, seed: int = 0,
                      vocab: int = 256,
                      capacity_tokens_per_sec: Optional[float] = None,
                      frontend_kwargs: Optional[Dict[str, Any]] = None,
                      slow_decode: bool = False,
                      result_timeout_s: float = 600.0,
                      device=None) -> Dict[str, Any]:
    """One overload-ramp leg on a fresh tiny-GPT engine.

    ``capacity_tokens_per_sec``: reuse a previous leg's measured capacity
    so both legs offer the IDENTICAL arrival schedule (pass leg 1's
    ``capacity_tokens_per_sec`` into leg 2); measured inline when None.
    ``slow_decode``: arm the ``slow_decode`` fault point at probability
    1.0 for the whole leg (including the capacity probe) — every decode
    step pays the injected 50ms, so service time dominates host
    scheduling jitter and the on/off comparison is reproducible on a
    noisy host (leave False when the caller arms its own schedule).
    ``device``: where the engine runs (default the card). Returns a dict
    with goodput, per-reason/-class accounting, ladder states visited,
    and the serving ``new_shape`` delta.
    """
    from deeplearning4j_tpu_torch import faults

    if slow_decode:
        faults.arm("slow_decode", prob=1.0, seed=0)
    try:
        return _run_leg(
            frontend_on=frontend_on, n_requests=n_requests,
            gen_tokens=gen_tokens, max_slots=max_slots,
            overload_factor=overload_factor, deadline_slack=deadline_slack,
            seed=seed, vocab=vocab,
            capacity_tokens_per_sec=capacity_tokens_per_sec,
            frontend_kwargs=frontend_kwargs,
            result_timeout_s=result_timeout_s, device=device)
    finally:
        if slow_decode:
            faults.disarm("slow_decode")


def _run_leg(*, frontend_on: bool, n_requests: int, gen_tokens: int,
             max_slots: int, overload_factor: float, deadline_slack: float,
             seed: int, vocab: int,
             capacity_tokens_per_sec: Optional[float],
             frontend_kwargs: Optional[Dict[str, Any]],
             result_timeout_s: float, device) -> Dict[str, Any]:
    from deeplearning4j_tpu_torch.models.gpt import GptConfig, GptModel
    from deeplearning4j_tpu_torch.serving import GenerativeEngine, SLOFrontend

    cfg = GptConfig.tiny(vocab_size=vocab)
    model = GptModel(cfg, seed=0, device=device)
    max_prompt = 16
    pages_per_seq = -(-(max_prompt + gen_tokens + 1) // 8) + 1
    eng = GenerativeEngine(model, max_slots=max_slots, page_size=8,
                           max_pages_per_seq=pages_per_seq,
                           max_prompt=max_prompt, seed=0,
                           device=model.device)
    new_shape_before = _serving_new_shape_count()

    # warm the captured steps: the ramp measures serving, not capture
    eng.generate([np.asarray([1, 2], np.int32)], max_new_tokens=2,
                 eos_token=-1)

    if capacity_tokens_per_sec is None:
        # capacity probe: saturate the slot bank inline and time it
        probe = [np.asarray([3, 5, 7], np.int32)] * (2 * max_slots)
        t0 = time.perf_counter()
        res = eng.generate(probe, max_new_tokens=gen_tokens, eos_token=-1)
        dt = time.perf_counter() - t0
        capacity_tokens_per_sec = sum(len(r.tokens) for r in res) / dt

    # base deadline: the time a request needs when admitted IMMEDIATELY
    # into a fully-busy bank, times the slack; offered request rate is
    # overload_factor × the capacity request rate — past saturation by
    # construction
    per_req_s = gen_tokens * max_slots / capacity_tokens_per_sec
    base_deadline = deadline_slack * per_req_s
    offered_rps = overload_factor * capacity_tokens_per_sec / gen_tokens

    fe = None
    if frontend_on:
        from deeplearning4j_tpu_torch.serving import (LadderThresholds,
                                                default_classes)
        classes = default_classes()
        # the default batch queue share is sized for a small engine —
        # scale it with the slot bank so the bound sheds GENUINE excess,
        # not viable batch work
        classes["batch"].max_queued = 4 * max_slots
        kw = dict(max_queue_total=6 * max_slots,
                  degraded_max_new_tokens=max(2, gen_tokens // 2),
                  est_tokens_per_request=float(gen_tokens),
                  classes=classes,
                  # admit only work whose estimated completion fits in
                  # 90% of its deadline: the headroom absorbs host-load
                  # spikes between the capacity probe and the ramp
                  shed_margin=0.9,
                  thresholds=LadderThresholds(
                      degraded_queue=2 * max_slots,
                      shedding_queue=5 * max_slots))
        kw.update(frontend_kwargs or {})
        fe = SLOFrontend(eng, **kw)

    r = np.random.RandomState(seed)
    names = [m[0] for m in DEFAULT_MIX]
    weights = np.asarray([m[1] for m in DEFAULT_MIX], np.float64)
    weights /= weights.sum()
    dl_mult = {m[0]: m[2] for m in DEFAULT_MIX}
    plan = []
    for i in range(n_requests):
        cls = names[int(r.choice(len(names), p=weights))]
        prompt = r.randint(1, vocab, size=int(r.randint(2, 8))) \
            .astype(np.int32)
        plan.append((cls, prompt, base_deadline * dl_mult[cls]))

    eng.start()
    done_t: Dict[int, float] = {}

    def _mark(i: int):
        def _cb(_fut) -> None:
            done_t[i] = time.perf_counter()
        return _cb

    futs, sub_t = [], []
    try:
        t_start = time.perf_counter()
        for i, (cls, prompt, deadline) in enumerate(plan):
            delay = (t_start + i / offered_rps) - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            sub_t.append(time.perf_counter())
            if fe is not None:
                fut = fe.submit(prompt, slo_class=cls,
                                max_new_tokens=gen_tokens, eos_token=-1,
                                deadline_s=deadline)
            else:
                fut = eng.submit(prompt, max_new_tokens=gen_tokens,
                                 eos_token=-1, deadline_s=deadline,
                                 slo_class=cls)
            fut.add_done_callback(_mark(i))
            futs.append(fut)
        results = [f.result(timeout=result_timeout_s) for f in futs]
        burst_results = []
        if fe is not None:
            burst_results = [f.result(timeout=result_timeout_s)
                             for f in fe.burst_futures]
        # result() can return before Future's done-callbacks run (they
        # fire after waiters wake) — wait for every _mark so no request
        # is scored deadline-missed for a timestamp that hadn't landed
        wait_until = time.perf_counter() + 5.0
        while len(done_t) < len(futs) and time.perf_counter() < wait_until:
            time.sleep(0.001)
        t_end = max(done_t.values()) if done_t else time.perf_counter()
    finally:
        eng.stop()

    wall = max(1e-9, t_end - t_start)
    good_tokens = 0
    reasons: Dict[str, int] = {}
    degraded = 0
    ttft_by_class: Dict[str, list] = {}
    met_by_class: Dict[str, int] = {}
    for i, res in enumerate(results):
        reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1
        degraded += int(res.degraded)
        cls, _prompt, deadline = plan[i]
        if res.ttft_s is not None:
            ttft_by_class.setdefault(cls, []).append(res.ttft_s)
        if (res.finish_reason in ("eos", "length")
                and done_t.get(i, float("inf")) - sub_t[i] <= deadline):
            good_tokens += len(res.tokens)
            met_by_class[cls] = met_by_class.get(cls, 0) + 1
    for res in burst_results:
        reasons[res.finish_reason] = reasons.get(res.finish_reason, 0) + 1

    all_terminal = (all(f.done() for f in futs)
                    and (fe is None
                         or all(f.done() for f in fe.burst_futures)))
    out = {
        "frontend_on": frontend_on,
        "requests": n_requests,
        "burst_requests": 0 if fe is None else len(fe.burst_futures),
        "offered_rps": round(offered_rps, 3),
        "capacity_tokens_per_sec": round(capacity_tokens_per_sec, 2),
        "base_deadline_s": round(base_deadline, 3),
        "goodput_tokens_per_sec": round(good_tokens / wall, 3),
        "good_tokens": int(good_tokens),
        "deadline_met": dict(sorted(met_by_class.items())),
        "reasons": dict(sorted(reasons.items())),
        "degraded_results": degraded,
        "all_terminal": bool(all_terminal),
        "wall_s": round(wall, 3),
        "new_shape_events": max(
            0, _serving_new_shape_count() - new_shape_before),
    }
    if frontend_on and fe is not None:
        out["states_visited"] = sorted(fe.states_visited)
        out["frontend"] = fe.snapshot()
    itx = ttft_by_class.get("interactive")
    if itx:
        itx = sorted(itx)
        out["interactive_ttft_p99_ms"] = round(
            itx[min(len(itx) - 1, int(0.99 * len(itx)))] * 1e3, 3)
    return out
