"""SLO-driven admission frontend — overload as a managed state.

Counterpart of ``deeplearning4j_tpu/serving/frontend.py``, the same host
policy over the port's engine: the layer between many users and ONE
:class:`~deeplearning4j_tpu_torch.serving.engine.GenerativeEngine` (or a
:class:`~deeplearning4j_tpu_torch.serving.cluster.ClusterRouter`). The engine's
own overload handling is a blunt ``max_queue`` cutoff — a hopeless request
still queues until its deadline burns, a burst of batch traffic starves
interactive traffic, and there is no middle ground between "serve fully"
and "shed". :class:`SLOFrontend` wraps ``engine.submit`` and makes
overload *managed*:

1. **Admission control.** Per-class token-bucket rate limits and
   in-flight concurrency caps, plus **predictive early shed**: estimated
   time-to-first-token (live queue depth, slot occupancy, and a rolling
   decode-step p50 read from the ``observe`` histograms) plus the decode
   time of the (possibly degraded) answer already past the request's
   deadline means the request completes as ``shed`` AT SUBMIT — capacity
   is never spent decoding work that cannot meet its SLO, and a
   completion landing past its deadline is priced at what it is worth:
   nothing.
2. **Priority classes.** ``interactive`` > ``standard`` > ``batch``
   (configurable): the engine's pending queue is priority-ordered (FIFO
   within a class — :meth:`SlotScheduler.peek_best_pending`), each class
   has its own queue-depth bound, and when the TOTAL queue bound is hit
   the LOWEST class queued is stolen and shed first. Supervisor retries
   re-queue the same request object — original class, priority, and
   submit time — so crash recovery never inverts priority.
3. **Graceful-degradation ladder.** Explicit overload states ``ok`` →
   ``degraded`` → ``shedding``, driven by hysteresis thresholds on queue
   depth and the ROLLING decode p99 (bucket-delta quantiles — the
   process-lifetime histogram never forgets, the ladder must). In
   ``degraded``, degradable (low) classes get ``max_new_tokens`` capped
   and the expensive sampling extras (top-k/top-p masking) disabled, and
   the trim is recorded on the request so the caller's
   ``GenerationResult.degraded`` is honest. In ``shedding``, classes
   marked ``reject_in_shedding`` (batch) are rejected outright.
4. **Circuit breaker.** When the supervisor is thrashing (engine
   restarts/minute above threshold) the frontend fast-fails NEW
   admissions terminally as ``error`` for a cooldown window instead of
   feeding a dying engine; existing work keeps its retry budget.

Every decision is observable: ``dl4j_tpu_slo_state`` (0/1/2),
``dl4j_tpu_slo_admitted_total{class}``,
``dl4j_tpu_slo_shed_total{class,reason}``,
``dl4j_tpu_slo_degraded_total{class}``,
``dl4j_tpu_slo_transitions_total{to}``, ``dl4j_tpu_slo_breaker_open``,
plus ``slo_state``/``slo_shed``/``slo_breaker`` JSONL events. Frontend
sheds complete with the SAME terminal taxonomy as the engine
(``FINISH_REASONS``; counted once in
``dl4j_tpu_serving_evicted_total{reason}`` via
:func:`~deeplearning4j_tpu_torch.serving.scheduler.count_terminal`).

The ``burst_arrival`` fault point (``faults/``) hooks
:meth:`SLOFrontend.submit`: a fire injects a burst of lowest-class
synthetic arrivals, so a chaos run can drive the ladder end to end.
Goodput under overload — completed-within-deadline tokens/sec, with and
without this frontend — is measured by ``serving/overload.py``.

Every clock read goes through the injectable ``clock`` (default
``time.perf_counter``): wall-clock jumps must never expire a deadline or
refill a bucket, and tests drive the ladder with a fake clock.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import faults, observe
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationRequest, GenerationResult, count_terminal)

logger = logging.getLogger(__name__)

#: The overload ladder, in escalation order. ``dl4j_tpu_slo_state`` carries
#: the index (0 = ok, 1 = degraded, 2 = shedding).
OVERLOAD_STATES = ("ok", "degraded", "shedding")
_STATE_LEVEL = {s: i for i, s in enumerate(OVERLOAD_STATES)}

#: Frontend shed reasons — the ``reason`` label on
#: ``dl4j_tpu_slo_shed_total{class,reason}``. Each maps onto ONE terminal
#: ``FINISH_REASONS`` outcome: ``circuit_open`` completes as ``error``,
#: everything else as ``shed``. ``engine_queue`` marks a request the
#: frontend admitted but the ENGINE's own ``max_queue`` gate shed —
#: counted so admitted-vs-evicted accounting never double-books it.
SHED_REASONS = ("rate_limit", "concurrency", "queue_full",
                "predicted_deadline", "shedding_state", "circuit_open",
                "engine_queue")


@dataclasses.dataclass
class ClassPolicy:
    """Admission policy for one priority class.

    ``priority`` orders the engine's pending queue (lower admits first).
    ``rate``/``burst`` arm a token bucket (None disables rate limiting);
    ``max_queued`` bounds this class's share of the pending queue;
    ``max_concurrent`` caps in-flight (queued + active) requests of the
    class; ``deadline_s`` is the class default when the caller passes
    none. ``degradable`` classes get trimmed in the ``degraded`` state;
    ``reject_in_shedding`` classes are refused outright in ``shedding``.
    ``disable_spec`` is the speculative-decoding degraded-mode knob: in
    the ``shedding`` state
    the class's requests decode NON-speculatively — the draft model's
    compute goes back to the drowning target — recorded on the result as
    ``GenerationResult.spec_disabled``, like the existing degraded
    fields.
    ``shared_prefix`` (token ids) is this class's shared system prompt:
    at frontend construction it is run through the engine once and PINNED
    in the radix prefix cache, so
    the class's traffic admits with a prefix hit from the first request
    and eviction pressure can never drop it.
    """

    name: str
    priority: int
    rate: Optional[float] = None          # sustained requests/sec
    burst: int = 8                        # token-bucket capacity
    max_queued: Optional[int] = None      # per-class pending bound
    max_concurrent: Optional[int] = None  # in-flight cap (queued + active)
    deadline_s: Optional[float] = None    # class-default deadline
    degradable: bool = True               # ladder may trim this class
    reject_in_shedding: bool = False      # refused outright in "shedding"
    disable_spec: bool = False            # "shedding" turns speculation off
    shared_prefix: Optional[Sequence[int]] = None  # pre-warmed + pinned
    #                                     system-prompt token ids

    def __post_init__(self):
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority}")
        if self.rate is not None and self.rate <= 0:
            raise ValueError(f"rate must be > 0 (None disables), "
                             f"got {self.rate}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


def default_classes() -> Dict[str, ClassPolicy]:
    """The three-class default ladder: ``interactive`` (never degraded,
    admitted first), ``standard``, ``batch`` (first shed, refused in
    ``shedding``, bounded queue share)."""
    return {
        "interactive": ClassPolicy("interactive", priority=0,
                                   degradable=False),
        "standard": ClassPolicy("standard", priority=1),
        "batch": ClassPolicy("batch", priority=2, max_queued=8,
                             reject_in_shedding=True),
    }


@dataclasses.dataclass
class LadderThresholds:
    """Hysteresis thresholds driving the ``ok``/``degraded``/``shedding``
    ladder. Escalation is immediate when EITHER signal crosses its enter
    threshold; de-escalation drops one level at a time and only once BOTH
    signals sit below ``exit_fraction`` of the current level's enter
    thresholds — flapping at a boundary cannot thrash the ladder."""

    degraded_queue: int = 8          # pending depth entering "degraded"
    shedding_queue: int = 16         # pending depth entering "shedding"
    degraded_p99_s: float = 0.5      # rolling decode p99 entering "degraded"
    shedding_p99_s: float = 2.0      # rolling decode p99 entering "shedding"
    exit_fraction: float = 0.5       # exit below fraction × enter threshold

    def __post_init__(self):
        if not 0.0 < self.exit_fraction < 1.0:
            raise ValueError("exit_fraction must be in (0, 1)")
        if (self.shedding_queue < self.degraded_queue
                or self.shedding_p99_s < self.degraded_p99_s):
            raise ValueError("shedding thresholds must be >= degraded ones")


class _TokenBucket:
    """Classic token bucket on an injectable monotonic clock."""

    def __init__(self, rate: float, burst: int, now: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._last = now

    def try_take(self, now: float) -> bool:
        self.tokens = min(self.burst,
                          self.tokens + (now - self._last) * self.rate)
        self._last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False

    def refund(self) -> None:
        """Return a taken token (the admission was denied downstream —
        a denial must not burn rate budget)."""
        self.tokens = min(self.burst, self.tokens + 1.0)


class _RollingQuantiles:
    """Recent decode-step p50/p99 from HISTOGRAM BUCKET DELTAS.

    The registry's histograms accumulate for the process lifetime, so
    their quantiles can only rise — useless for de-escalation. This
    reader snapshots the bucket counts each poll and estimates quantiles
    over the delta (the steps decoded since the last poll), EWMA-blended
    for stability. Decay is IDLE-TIME based, not poll based: polls can be
    arbitrarily frequent (one per submit), far faster than decode steps
    complete — only a genuinely idle engine (no new samples for
    ``idle_decay_s``) drifts back toward calm, at most one decay step per
    idle window."""

    def __init__(self, hist, alpha: float = 0.5, decay: float = 0.8,
                 idle_decay_s: float = 5.0,
                 clock: Callable[[], float] = time.perf_counter):
        self._hist = hist
        self._alpha = float(alpha)
        self._decay = float(decay)
        self._idle_decay_s = float(idle_decay_s)
        self._clock = clock
        now = clock()
        self._last_sample_t = now
        self._last_decay_t = now
        with hist._lock:
            self._last = list(hist.counts)
        self.p50: Optional[float] = None
        self.p99: Optional[float] = None

    @staticmethod
    def _delta_quantile(bounds, counts, q: float) -> Optional[float]:
        total = sum(counts)
        if not total:
            return None
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i] if i < len(bounds) else bounds[-1] * 2.0
                frac = (rank - cum) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += c
        return bounds[-1]

    def poll(self) -> None:
        with self._hist._lock:
            cur = list(self._hist.counts)
        delta = [a - b for a, b in zip(cur, self._last)]
        self._last = cur
        now = self._clock()
        if sum(delta) <= 0:
            # no NEW samples — decay only once the engine has been idle
            # a full window, and at most once per window
            if (now - self._last_sample_t > self._idle_decay_s
                    and now - self._last_decay_t > self._idle_decay_s):
                self._last_decay_t = now
                if self.p50 is not None:
                    self.p50 *= self._decay
                if self.p99 is not None:
                    self.p99 *= self._decay
            return
        self._last_sample_t = now
        q50 = self._delta_quantile(self._hist.bounds, delta, 0.50)
        q99 = self._delta_quantile(self._hist.bounds, delta, 0.99)
        a = self._alpha
        self.p50 = q50 if self.p50 is None else a * q50 + (1 - a) * self.p50
        self.p99 = q99 if self.p99 is None else a * q99 + (1 - a) * self.p99


class SLOFrontend:
    """SLO-driven admission wrapper around a running
    :class:`GenerativeEngine` (module docstring has the full design).

    Use::

        eng = GenerativeEngine(model, max_slots=8).start()
        fe = SLOFrontend(eng)
        fut = fe.submit(prompt, slo_class="interactive", deadline_s=0.5)
        result = fut.result()      # ALWAYS terminal — shed is a result

    Thread-safe: clients submit from any thread; all frontend state is
    guarded by one reentrant lock, and pending-queue surgery goes through
    the scheduler's own lock.
    """

    def __init__(self, engine, *,
                 classes: Optional[Dict[str, ClassPolicy]] = None,
                 thresholds: Optional[LadderThresholds] = None,
                 max_queue_total: Optional[int] = None,
                 degraded_max_new_tokens: int = 8,
                 est_tokens_per_request: float = 16.0,
                 est_decode_s: Optional[float] = None,
                 shed_margin: float = 1.0,
                 breaker_window_s: float = 60.0,
                 breaker_restarts: Optional[int] = None,
                 breaker_cooldown_s: float = 5.0,
                 burst_size: int = 4,
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.classes = dict(classes) if classes else default_classes()
        if not self.classes:
            raise ValueError("at least one class policy is required")
        if thresholds is None:
            slots = getattr(engine.scheduler, "max_slots", 4)
            thresholds = LadderThresholds(
                degraded_queue=max(4, 2 * slots),
                shedding_queue=max(8, 4 * slots))
        self.thresholds = thresholds
        self.max_queue_total = max_queue_total
        self.degraded_max_new_tokens = int(degraded_max_new_tokens)
        self.shed_margin = float(shed_margin)
        self.breaker_window_s = float(breaker_window_s)
        if breaker_restarts is None:
            # scale to THIS engine's lifetime restart budget: a fixed
            # threshold above engine.max_restarts would be unreachable —
            # the supervisor fail_alls first and the breaker never opens
            breaker_restarts = max(2, int(getattr(engine, "max_restarts",
                                                  6)))
        self.breaker_restarts = int(breaker_restarts)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.burst_size = int(burst_size)
        self._clock = clock
        now = clock()
        self._lock = threading.RLock()
        self._buckets: Dict[str, _TokenBucket] = {
            p.name: _TokenBucket(p.rate, p.burst, now)
            for p in self.classes.values() if p.rate is not None}
        self._inflight: Dict[str, int] = {n: 0 for n in self.classes}
        # ladder state
        self.state = "ok"
        self.states_visited = {"ok"}
        self._rolling = _RollingQuantiles(
            observe.metrics().histogram(
                "dl4j_tpu_serving_decode_step_seconds"),
            clock=clock)
        # predictive-shed model state: EWMA of requested generation length
        # (seed from config), optional fixed decode-time prior for cold
        # starts (no decode samples yet -> no estimate -> no early shed)
        self._est_tokens = float(est_tokens_per_request)
        self._est_decode_s = est_decode_s
        # circuit breaker — keyed by ENGINE id: behind a ClusterRouter one
        # thrashing
        # engine must not fast-fail admissions a healthy sibling could
        # serve, so window/cooldown state is per engine and the fast-fail
        # fires only when EVERY routable engine's breaker is open. For a
        # single engine this reduces exactly to the pre-cluster behavior.
        self._seen_restarts: Dict[int, int] = {}
        self._restart_times: Dict[int, "deque[float]"] = {}
        self._breaker_open_until: Dict[int, float] = {}
        for i, eng in enumerate(self._cluster_engines()):
            eid = int(getattr(eng, "engine_id", i))
            self._seen_restarts[eid] = int(getattr(eng, "restarts", 0))
            self._restart_times[eid] = deque()
            self._breaker_open_until[eid] = -1.0
        self.breaker_opens = 0
        # burst_arrival bookkeeping: the injected synthetic arrivals'
        # futures, so harnesses can assert they too reach terminal states.
        # Bounded: a long chaos soak must not pin every burst's result
        # forever (old entries roll off; harnesses read a recent window)
        self.burst_futures: "deque[Future[GenerationResult]]" = \
            deque(maxlen=1024)
        m = observe.metrics()
        self._g_state = m.gauge("dl4j_tpu_slo_state")
        self._g_breaker = m.gauge("dl4j_tpu_slo_breaker_open")
        self._g_state.set(0.0)
        self._g_breaker.set(0.0)
        self._prewarm_shared_prefixes()

    def _prewarm_shared_prefixes(self) -> None:
        """Run each class's ``shared_prefix`` through the engine once and
        pin it in the radix prefix cache — per-class system prompts hit
        from the FIRST real
        request, and eviction can never drop them."""
        for pol in self.classes.values():
            if pol.shared_prefix is None:
                continue
            if getattr(self.engine, "prefix", None) is None:
                logger.info(
                    "class %r declares shared_prefix but the engine's "
                    "prefix cache is disabled (prefix_pages=0) — skipping "
                    "pre-warm", pol.name)
                continue
            self.engine.prewarm_prefix(pol.shared_prefix, pin=True)
            observe.log_event("prefix_prewarm", slo_class=pol.name,
                              tokens=int(np.asarray(pol.shared_prefix).size))

    # ----------------------------------------------------------------- admit
    def submit(self, prompt, *, slo_class: str = "standard",
               max_new_tokens: int = 16, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               eos_token: Optional[int] = None,
               deadline_s: Optional[float] = None,
               max_retries: int = 1) -> "Future[GenerationResult]":
        """Admit one generation through the SLO ladder. ALWAYS returns a
        future that reaches a terminal state: admitted work flows through
        the engine; denied work completes immediately as ``shed`` (or
        ``error`` when the circuit breaker is open)."""
        policy = self.classes.get(slo_class)
        if policy is None:
            raise ValueError(f"unknown SLO class {slo_class!r}; "
                             f"known: {sorted(self.classes)}")
        if faults.should_fire("burst_arrival"):
            self._inject_burst()
        return self._admit(prompt, policy, max_new_tokens, temperature,
                           top_k, top_p, eos_token, deadline_s, max_retries)

    def _admit(self, prompt, policy: ClassPolicy, max_new_tokens: int,
               temperature: float, top_k: int, top_p: float,
               eos_token: Optional[int], deadline_s: Optional[float],
               max_retries: int) -> "Future[GenerationResult]":
        # Completing a caller-visible future (_deny / _shed_victim) runs
        # its done-callbacks synchronously on THIS thread — foreign code
        # inside our critical section if it happened under self._lock (a
        # callback that blocks on another thread needing this lock would
        # deadlock the frontend). Denial/displacement
        # completions are therefore DEFERRED until the lock is released.
        deferred: List[Callable[[], None]] = []
        try:
            with self._lock:
                # The only completer reached under the lock is
                # add_done_callback on a FRESH, not-yet-completed future —
                # it registers, never invokes, the callback; denial paths
                # defer their set_result into `deferred` below.
                return self._admit_locked(
                    prompt, policy, max_new_tokens, temperature, top_k,
                    top_p, eos_token, deadline_s, max_retries, deferred)
        finally:
            for complete in deferred:
                complete()

    def _admit_locked(self, prompt, policy: ClassPolicy,
                      max_new_tokens: int, temperature: float, top_k: int,
                      top_p: float, eos_token: Optional[int],
                      deadline_s: Optional[float], max_retries: int,
                      deferred: List[Callable[[], None]]
                      ) -> "Future[GenerationResult]":
        now = self._clock()
        p_len = int(np.asarray(prompt).size)  # honest prompt_len on
        self._update_state(now)               # denied-result metadata

        # 1. circuit breaker: a thrashing engine gets NO new work —
        #    fast-fail terminally as "error" instead of queueing into
        #    a supervisor that keeps dying. Per-engine: only when
        #    EVERY routable engine is open (a cluster with one
        #    healthy sibling keeps admitting)
        if self._breaker_open_fraction(now) >= 1.0:
            return self._deny(policy, "circuit_open", terminal="error",
                              prompt_len=p_len, deferred=deferred)

        # 2. shedding state refuses the classes configured for it
        if self.state == "shedding" and policy.reject_in_shedding:
            return self._deny(policy, "shedding_state", prompt_len=p_len,
                              deferred=deferred)

        # 3. per-class in-flight concurrency cap (queued + active)
        cap = policy.max_concurrent
        if cap is not None and self._inflight[policy.name] >= cap:
            return self._deny(policy, "concurrency", prompt_len=p_len,
                              deferred=deferred)

        # 5. effective deadline: request > class default > engine
        #    default (None = no deadline, no predictive shed)
        if deadline_s is None:
            deadline_s = policy.deadline_s
        if deadline_s is None:
            deadline_s = getattr(self.engine, "default_deadline_s", None)

        # 6. degradation ladder: trim degradable classes FIRST, so the
        #    predictive estimate below prices the trimmed answer (the
        #    degraded counter increments only on actual ADMISSION —
        #    a trimmed-then-denied request was shed, not degraded)
        degraded = False
        if self.state != "ok" and policy.degradable:
            degraded = True
            max_new_tokens = min(max_new_tokens,
                                 self.degraded_max_new_tokens)
            top_k, top_p = 0, 1.0
        # 6b. speculative-decoding degraded-mode knob: in "shedding"
        #     a disable_spec class decodes non-speculatively — the
        #     draft model's compute goes back to the target (recorded
        #     on the result like the degraded flag; the engine reads
        #     it off the request at admission)
        spec_disabled = (self.state == "shedding"
                         and policy.disable_spec)

        # 7. predictive early shed: if the estimated TTFT plus the
        #    time to decode the (possibly trimmed) answer already
        #    blows the deadline, shedding NOW costs nothing —
        #    admitting costs queue space and decode steps the SLO can
        #    never recover, and a completion that lands PAST its
        #    deadline is worth exactly as little as a shed
        if deadline_s is not None:
            est = self.estimate_ttft_s(priority=policy.priority)
            if est is not None:
                p50 = self._rolling.p50
                if p50 is None:
                    p50 = self._est_decode_s or 0.0
                est += max_new_tokens * p50
                if est > deadline_s * self.shed_margin:
                    return self._deny(policy, "predicted_deadline",
                                      prompt_len=p_len,
                                      degraded=degraded,
                                      spec_disabled=spec_disabled,
                                      deferred=deferred)

        # 8. build + validate the request NOW — an invalid submission
        #    must raise to its caller BEFORE it can burn a rate token
        #    or displace a queued victim it will never replace
        eos = (self.engine.cfg.eos_token if eos_token is None
               else eos_token)
        req = GenerationRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token=eos, deadline_s=deadline_s,
            max_retries=max_retries, priority=policy.priority,
            slo_class=policy.name, degraded=degraded,
            spec_disabled=spec_disabled)
        self.engine.validate_request(req)

        # 8b. per-class token bucket — after the cheap caps and the
        #     predictive check so denials there never burn rate
        #     budget, but BEFORE the queue bounds so a rate-limited
        #     arrival cannot displace a queued victim for nothing
        bucket = self._buckets.get(policy.name)
        if bucket is not None and not bucket.try_take(now):
            return self._deny(policy, "rate_limit", prompt_len=p_len,
                              degraded=degraded,
                              spec_disabled=spec_disabled,
                              deferred=deferred)

        # 9. queue-depth bounds: per-class share first, then the total
        #    bound with shed-lowest-first — an important arrival
        #    displaces the worst queued request instead of being
        #    refused behind it. A denial here refunds the rate token.
        sched = self.engine.scheduler
        snapshot = sched.pending_snapshot()
        eff_quota = self._class_quota(policy)
        if eff_quota is not None:
            queued = sum(1 for it in snapshot
                         if it[0].slo_class == policy.name)
            if queued >= eff_quota:
                if bucket is not None:
                    bucket.refund()
                return self._deny(policy, "queue_full", prompt_len=p_len,
                                  degraded=degraded,
                                  spec_disabled=spec_disabled,
                                  deferred=deferred)
        if (self.max_queue_total is not None
                and len(snapshot) >= self.max_queue_total):
            victim = sched.steal_lowest_pending(policy.priority)
            if victim is None:
                # nothing lower-priority to displace: the arrival is
                # itself the worst — it sheds
                if bucket is not None:
                    bucket.refund()
                return self._deny(policy, "queue_full", prompt_len=p_len,
                                  degraded=degraded,
                                  spec_disabled=spec_disabled,
                                  deferred=deferred)
            self._shed_victim(victim, deferred)

        # 10. hand to the engine. Its own max_queue gate may still
        #     shed — it completes the future IMMEDIATELY and counts
        #     the terminal itself, so that case is slo_shed
        #     (engine_queue), never slo_admitted: the admitted counter
        #     means "actually queued", not "passed the frontend"
        fut = self.engine.submit_request(req)
        if fut.done():
            # the engine's gate shed it: refund the rate token (a
            # denial never burns budget) and keep the predictive
            # model untouched — nothing was actually queued
            if bucket is not None:
                bucket.refund()
            observe.metrics().counter(
                "dl4j_tpu_slo_shed_total",
                **{"class": policy.name, "reason": "engine_queue"}).inc()
            return fut
        self._est_tokens = 0.9 * self._est_tokens + 0.1 * max_new_tokens
        self._inflight[policy.name] += 1
        fut.add_done_callback(self._make_done_cb(policy.name))
        observe.metrics().counter("dl4j_tpu_slo_admitted_total",
                                  **{"class": policy.name}).inc()
        if degraded:
            observe.metrics().counter("dl4j_tpu_slo_degraded_total",
                                      **{"class": policy.name}).inc()
        return fut

    def _make_done_cb(self, cls: str):
        def _done(_fut) -> None:
            with self._lock:
                self._inflight[cls] = max(0, self._inflight[cls] - 1)
        return _done

    def _class_quota(self, policy: ClassPolicy) -> Optional[int]:
        """The class's queue bound under the CURRENT ladder state: under
        pressure the lowest classes' share shrinks first (halved in
        ``degraded``, quartered in ``shedding`` for priorities below the
        best class) — "the lowest class sheds first" even before the
        total bound engages."""
        quota = policy.max_queued
        if quota is None:
            return None
        level = _STATE_LEVEL[self.state]
        if level and policy.priority > min(
                p.priority for p in self.classes.values()):
            quota = max(1, quota // (2 ** level))
        return quota

    # ----------------------------------------------------------------- denial
    def _terminal_result(self, reason: str, cls: str, prompt_len: int = 0,
                         degraded: bool = False,
                         spec_disabled: bool = False) -> GenerationResult:
        return GenerationResult(
            tokens=np.zeros((0,), np.int32), finish_reason=reason,
            prompt_len=prompt_len, ttft_s=None, intertoken_s=[],
            slo_class=cls, degraded=degraded, spec_disabled=spec_disabled)

    def _deny(self, policy: ClassPolicy, slo_reason: str,
              terminal: str = "shed", prompt_len: int = 0,
              degraded: bool = False, spec_disabled: bool = False,
              deferred: Optional[List[Callable[[], None]]] = None
              ) -> "Future[GenerationResult]":
        """Complete a denied admission terminally (never an exception:
        overload is an expected state, and callers always get an answer).
        Counts ONCE in the slo_shed family AND once in the shared
        terminal-reason taxonomy.

        ``deferred`` is the post-lock completion list from ``_admit``:
        ``set_result`` fires done-callbacks synchronously, so completing
        here — under ``self._lock`` — would run foreign code inside the
        frontend's critical section (deadlock if it blocks on a thread
        that needs this lock)."""
        fut: "Future[GenerationResult]" = Future()
        result = self._terminal_result(
            terminal, policy.name, prompt_len=prompt_len,
            degraded=degraded, spec_disabled=spec_disabled)
        if deferred is not None:
            deferred.append(lambda: fut.set_result(result))
        else:
            fut.set_result(result)
        observe.metrics().counter(
            "dl4j_tpu_slo_shed_total",
            **{"class": policy.name, "reason": slo_reason}).inc()
        count_terminal(terminal)
        observe.log_event("slo_shed", slo_class=policy.name,
                          reason=slo_reason, state=self.state,
                          terminal=terminal)
        return fut

    def _shed_victim(self, item: Tuple,
                     deferred: Optional[List[Callable[[], None]]] = None
                     ) -> None:
        """Complete a stolen pending item (queue-bound displacement) as a
        terminal ``shed``.  Completion is deferred past lock release for
        the same reason as ``_deny`` — the victim's owner may have hung a
        done-callback on the future."""
        req, fut, _t = item
        result = self._terminal_result(
            "shed", req.slo_class, prompt_len=int(req.prompt.size),
            degraded=req.degraded)
        if deferred is not None:
            deferred.append(
                lambda: None if fut.done() else fut.set_result(result))
        elif not fut.done():
            fut.set_result(result)
        observe.metrics().counter(
            "dl4j_tpu_slo_shed_total",
            **{"class": req.slo_class, "reason": "queue_full"}).inc()
        count_terminal("shed")
        observe.log_event("slo_shed", slo_class=req.slo_class,
                          reason="queue_full", state=self.state,
                          displaced=True)

    # ------------------------------------------------------------- estimation
    def estimate_ttft_s(self, priority: Optional[int] = None
                        ) -> Optional[float]:
        """Predicted submit->first-token wall time for an arrival NOW at
        ``priority`` (None = behind the whole queue).

        Model: the slot bank serves ``max_slots`` sequences per decode
        step; a queued request waits for the busy slots plus the queued
        work that admits AHEAD of it (its own priority or better — the
        pending queue is priority-ordered) to drain, i.e. roughly
        ``(queue_ahead + busy) / max_slots`` service "waves", each lasting
        (EWMA generation length) × (rolling decode-step p50). Deliberately
        simple — the estimate only needs to be right about HOPELESS
        (order-of-magnitude-late) requests, which is what predictive
        shedding acts on. None when no decode latency signal exists yet
        (cold start: never early-shed blind)."""
        p50 = self._rolling.p50
        if p50 is None:
            p50 = self._est_decode_s
        if p50 is None or p50 <= 0:
            return None
        sched = self.engine.scheduler
        if priority is None:
            ahead = len(sched.pending)
        else:
            ahead = sum(1 for it in sched.pending_snapshot()
                        if it[0].priority <= priority)
        # busy slots are on average HALF-done — counting them as full
        # service waves would overestimate TTFT ~2× at steady state and
        # shed viable interactive work
        waves = ((ahead + 0.5 * len(sched.slots))
                 / max(1, sched.max_slots))
        return waves * self._est_tokens * p50

    # ------------------------------------------------------------ the ladder
    def _signals(self) -> Tuple[int, Optional[float]]:
        """(pending queue depth, rolling decode p99) — the two overload
        signals. Split out as a method so tests can monkeypatch it."""
        self._rolling.poll()
        return len(self.engine.scheduler.pending), self._rolling.p99

    def _update_state(self, now: float) -> None:
        """Re-evaluate the ladder. Called on every admission (there is no
        background ticker — between arrivals the gauge holds the last
        evaluated state). Escalation jumps straight to the highest matched
        level; de-escalation steps down one level per iteration but loops
        while the exit condition keeps holding, so the first arrival after
        a calm lull lands in the TRUE state instead of being needlessly
        degraded by a stale one."""
        self._update_breaker(now)
        q, p99 = self._signals()
        th = self.thresholds
        while True:
            level = _STATE_LEVEL[self.state]
            if q >= th.shedding_queue or (p99 is not None
                                          and p99 >= th.shedding_p99_s):
                target = 2
            elif q >= th.degraded_queue or (p99 is not None
                                            and p99 >= th.degraded_p99_s):
                target = max(level, 1)
            else:
                target = level
            if target == level and level > 0:
                # de-escalation: only below the hysteresis exit band of
                # the CURRENT level
                enter_q = (th.shedding_queue if level == 2
                           else th.degraded_queue)
                enter_p = (th.shedding_p99_s if level == 2
                           else th.degraded_p99_s)
                if (q <= th.exit_fraction * enter_q
                        and (p99 is None
                             or p99 <= th.exit_fraction * enter_p)):
                    target = level - 1
            if target == level:
                return
            self._transition(OVERLOAD_STATES[target], q, p99)

    def _transition(self, new_state: str, q: int,
                    p99: Optional[float]) -> None:
        old = self.state
        self.state = new_state
        self.states_visited.add(new_state)
        self._g_state.set(float(_STATE_LEVEL[new_state]))
        observe.metrics().counter("dl4j_tpu_slo_transitions_total",
                                  to=new_state).inc()
        observe.log_event("slo_state", from_state=old, to_state=new_state,
                          queue_depth=q,
                          decode_p99_ms=None if p99 is None
                          else round(p99 * 1e3, 3))
        logger.info("SLO state %s -> %s (queue=%d, rolling decode p99=%s)",
                    old, new_state, q,
                    "n/a" if p99 is None else f"{p99 * 1e3:.1f}ms")

    # ------------------------------------------------------- circuit breaker
    def _cluster_engines(self) -> list:
        """The engines the breaker watches: a ClusterRouter's LIVE
        members (a dead engine can never restart again — its stale
        window must not veto the all-open fast-fail), the router's full
        list when nothing is live, or the single engine itself."""
        live = getattr(self.engine, "live_engines", None)
        if callable(live):
            engs = live()
            if engs:
                return list(engs)
        engs = getattr(self.engine, "engines", None)
        return list(engs) if engs else [self.engine]

    def _breaker_open_fraction(self, now: float) -> float:
        engs = self._cluster_engines()
        n_open = sum(
            1 for i, e in enumerate(engs)
            if now < self._breaker_open_until.get(
                int(getattr(e, "engine_id", i)), -1.0))
        return n_open / max(1, len(engs))

    def _update_breaker(self, now: float) -> None:
        for i, eng in enumerate(self._cluster_engines()):
            eid = int(getattr(eng, "engine_id", i))
            times = self._restart_times.setdefault(eid, deque())
            cur = int(getattr(eng, "restarts", 0))
            seen = self._seen_restarts.setdefault(eid, cur)
            if cur > seen:
                times.extend([now] * (cur - seen))
            self._seen_restarts[eid] = cur
            while times and now - times[0] > self.breaker_window_s:
                times.popleft()
            was_open = now < self._breaker_open_until.get(eid, -1.0)
            if not was_open and len(times) >= self.breaker_restarts:
                self._breaker_open_until[eid] = now + self.breaker_cooldown_s
                self.breaker_opens += 1
                # consume the window: the breaker re-opens only on NEW
                # restarts after the cooldown, not on the same thrash burst
                times.clear()
                observe.log_event(
                    "slo_breaker", action="open", engine=eid,
                    restarts_in_window=self.breaker_restarts,
                    cooldown_s=self.breaker_cooldown_s)
                logger.warning(
                    "SLO circuit breaker OPEN for engine %d: %d restarts "
                    "inside %.0fs — fast-failing admissions for %.1fs",
                    eid, self.breaker_restarts, self.breaker_window_s,
                    self.breaker_cooldown_s)
        # the gauge reports the open FRACTION (1.0 == full fast-fail);
        # single-engine keeps the historical 0.0/1.0 values
        self._g_breaker.set(self._breaker_open_fraction(now))

    @property
    def breaker_open(self) -> bool:
        """True when admissions fast-fail: EVERY routable engine's
        breaker is open (the single-engine degenerate case is unchanged)."""
        return self._breaker_open_fraction(self._clock()) >= 1.0

    # ---------------------------------------------------------- chaos: burst
    def _inject_burst(self) -> None:
        """``burst_arrival`` fault hook: flood the admission path with
        ``burst_size`` synthetic arrivals of the LOWEST class — the chaos
        harness's way of driving the ladder without a client fleet. The
        synthetic futures go through normal admission (they may shed) and
        are retained in :attr:`burst_futures` so every injected request is
        still provably terminal."""
        lowest = max(self.classes.values(), key=lambda p: p.priority)
        vocab = int(self.engine.cfg.vocab_size)
        prompt = np.asarray([1 % vocab, 2 % vocab], np.int32)
        for _ in range(self.burst_size):
            fut = self._admit(prompt, lowest,
                              max_new_tokens=max(1, int(self._est_tokens)),
                              temperature=0.0, top_k=0, top_p=1.0,
                              eos_token=-1, deadline_s=None, max_retries=0)
            self.burst_futures.append(fut)
        observe.log_event("slo_burst_injected", size=self.burst_size,
                          slo_class=lowest.name)

    # -------------------------------------------------------------- snapshot
    def snapshot(self) -> Dict[str, object]:
        """Compact state dump (harnesses, debugging)."""
        with self._lock:
            return {
                "state": self.state,
                "states_visited": sorted(self.states_visited),
                "breaker_open": self.breaker_open,
                "breaker_opens": self.breaker_opens,
                "inflight": dict(self._inflight),
                "est_tokens_per_request": round(self._est_tokens, 2),
                "rolling_decode_p50_ms": None if self._rolling.p50 is None
                else round(self._rolling.p50 * 1e3, 3),
                "rolling_decode_p99_ms": None if self._rolling.p99 is None
                else round(self._rolling.p99 * 1e3, 3),
                "burst_requests": len(self.burst_futures),
            }
