"""Multi-engine cluster router — whole-engine loss as a managed failure
domain.

Counterpart of ``deeplearning4j_tpu/serving/cluster.py``, the same host
policy over the port's engines: N :class:`GenerativeEngine` instances
behind one :class:`ClusterRouter`, so the failure unit the system absorbs
grows from "a worker thread" (the supervisor's restarts) to "an entire
engine" (its restart budget spent, or the hard ``engine_death`` fault).

**Routing.** Each arrival is scored against every routable engine on two
axes, cheapest signal first:

* **prefix affinity** — the engine's radix tree (:meth:`RadixPrefixCache
  .match`) is the affinity oracle: the engine holding the longest cached
  prefix of the prompt serves it in O(suffix) instead of O(prompt), so
  shared-prompt traffic lands where its KV pages already live.
* **load** — busy slots plus queue depth, normalised by ``max_slots``.
  Affinity yields to load once the cached engine is more than
  ``affinity_max_imbalance`` waves deeper than the least-loaded engine.

**Health.** The router watches each engine's ``restarts`` counter through
a sliding window: an engine absorbing ``quarantine_restarts`` crashes
within ``quarantine_window_s`` is QUARANTINED for
``quarantine_cooldown_s`` — deprioritised for new arrivals, never a hard
exclusion: if every engine is quarantined, the least-bad one serves.

**Migration.** Engine death is final. The dying worker thread runs the
router's ``on_unrecoverable`` hook as its last act — nothing races it —
and the hook applies the supervisor's re-admission discipline cluster
wide: in-flight requests with retry budget left re-admit at the FRONT of
a survivor's queue with their ORIGINAL submit time and priority
(deadlines keep counting; the pending order never inverts), queued
requests migrate without charging a retry (they never held a slot), and
everything else retires terminally as ``error`` — one labelled terminal
count per request. Pinned per-class prefixes re-warm on the destination
engines (fire-and-forget 1-token generations; the recorded pin intents
re-pin on insert). Survivors record no ``new_shape``: migrated requests
restart from the prompt against units already captured.

The router quacks like an engine where the SLO frontend needs it to
(``submit_request``/``validate_request``/``cfg``/``prewarm_prefix`` plus
a combined scheduler view), so ``SLOFrontend(ClusterRouter([...]))``
composes.

Telemetry: ``dl4j_tpu_cluster_engines_live``,
``dl4j_tpu_cluster_routed_total{engine,reason}``,
``dl4j_tpu_cluster_deaths_total``, ``dl4j_tpu_cluster_migrated_total``,
``dl4j_tpu_cluster_migration_failed_total``,
``dl4j_tpu_cluster_quarantined_total``,
``dl4j_tpu_cluster_prefix_rewarm_total``; JSONL kinds ``cluster_route``,
``cluster_migrate``, ``cluster_quarantine``.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch import observe
from deeplearning4j_tpu_torch.serving.engine import GenerativeEngine
from deeplearning4j_tpu_torch.serving.scheduler import (
    GenerationRequest, GenerationResult)

logger = logging.getLogger(__name__)


class _ClusterSchedulerView:
    """The combined scheduler the SLO frontend steers by: pending depth,
    busy slots and capacity summed over LIVE engines only, so the
    frontend's wave estimates — and therefore its admission ladder —
    degrade proportionally when an engine dies instead of pretending the
    dead capacity still exists. Slot keys are ``(engine_id, slot)``."""

    def __init__(self, router: "ClusterRouter"):
        self._router = router

    def _live(self) -> List[GenerativeEngine]:
        live = self._router.live_engines()
        # a fully-dead cluster still needs a non-empty denominator for
        # the frontend's max(1, ...) guards; report the original shape
        return live or list(self._router.engines)

    @property
    def max_slots(self) -> int:
        return sum(e.scheduler.max_slots for e in self._live())

    @property
    def pending(self) -> List[tuple]:
        out: List[tuple] = []
        for e in self._live():
            out.extend(e.scheduler.pending_snapshot())
        return out

    @property
    def slots(self) -> Dict[tuple, object]:
        out: Dict[tuple, object] = {}
        for e in self._live():
            for slot, st in list(e.scheduler.slots.items()):
                out[(e.engine_id, slot)] = st
        return out

    def pending_snapshot(self) -> List[tuple]:
        return self.pending

    def has_work(self) -> bool:
        return any(e.scheduler.has_work() for e in self._live())

    def occupancy(self) -> float:
        cap = self.max_slots
        return len(self.slots) / cap if cap else 0.0

    def steal_lowest_pending(self, than_priority: int) -> Optional[tuple]:
        """Shed the GLOBALLY worst queued item: find the engine holding
        the worst victim (snapshot scan), then delegate to its scheduler's
        atomic steal. A racing admit may hand us a different — but by
        construction no better — victim from that engine; None when no
        engine queues anything lower-priority."""
        worst_sched, worst_key = None, None
        for e in self._live():
            for item in e.scheduler.pending_snapshot():
                if item[0].priority <= than_priority:
                    continue
                key = (item[0].priority, item[2])
                if worst_key is None or key > worst_key:
                    worst_key, worst_sched = key, e.scheduler
        if worst_sched is None:
            return None
        return worst_sched.steal_lowest_pending(than_priority)


class ClusterRouter:
    """Health- and affinity-routed serving over N engines; see the module
    docstring for the design. Engines must share the model contract
    (vocab, prompt bucket) — a request routable to one must be routable
    to all, or migration could strand work."""

    def __init__(self, engines: Sequence[GenerativeEngine], *,
                 quarantine_restarts: int = 3,
                 quarantine_window_s: float = 30.0,
                 quarantine_cooldown_s: float = 5.0,
                 affinity_max_imbalance: float = 2.0):
        engines = list(engines)
        if not engines:
            raise ValueError("ClusterRouter needs at least one engine")
        head = engines[0]
        for e in engines[1:]:
            if (e.cfg.vocab_size != head.cfg.vocab_size
                    or e.max_prompt != head.max_prompt):
                raise ValueError(
                    "cluster engines must share vocab_size and max_prompt "
                    "(a request routable to one must be routable to all)")
        if len({e.engine_id for e in engines}) != len(engines):
            # default-constructed engines all carry id 0 — renumber so
            # metrics/JSONL rows and the _dead set can tell them apart
            for i, e in enumerate(engines):
                e.engine_id = i
        self.engines = engines
        self.quarantine_restarts = int(quarantine_restarts)
        self.quarantine_window_s = float(quarantine_window_s)
        self.quarantine_cooldown_s = float(quarantine_cooldown_s)
        self.affinity_max_imbalance = float(affinity_max_imbalance)
        self._lock = threading.RLock()
        self._dead: set = set()                       # engine_ids, final
        self._quarantined_until: Dict[int, float] = {}
        self._restart_seen: Dict[int, int] = {
            e.engine_id: e.restarts for e in engines}
        self._restart_times: Dict[int, Deque[float]] = {
            e.engine_id: deque() for e in engines}
        self._pin_intents: List[Tuple[int, ...]] = []  # ordered, deduped
        self.deaths = 0
        self.migrations = 0
        # migrated request objects, for harnesses asserting bit-identical
        # outputs across a migration (bounded: telemetry, not state)
        self.migrated_requests: Deque[GenerationRequest] = deque(maxlen=4096)
        self.scheduler = _ClusterSchedulerView(self)
        m = observe.metrics()
        self._obs = {
            "live": m.gauge("dl4j_tpu_cluster_engines_live"),
            "deaths": m.counter("dl4j_tpu_cluster_deaths_total"),
            "migrated": m.counter("dl4j_tpu_cluster_migrated_total"),
            "migration_failed":
                m.counter("dl4j_tpu_cluster_migration_failed_total"),
            "quarantined": m.counter("dl4j_tpu_cluster_quarantined_total"),
            "rewarm": m.counter("dl4j_tpu_cluster_prefix_rewarm_total"),
        }
        self._obs["live"].set(float(len(engines)))
        for e in engines:
            # bind per-engine: the hook runs on e's dying worker thread
            e.on_unrecoverable = (
                lambda exc, eng=e: self._on_engine_death(eng, exc))

    # ------------------------------------------------------- engine facade
    # the attributes the SLO frontend (and plain callers) read off an
    # engine, delegated so SLOFrontend(ClusterRouter([...])) composes
    @property
    def cfg(self):
        return self.engines[0].cfg

    @property
    def max_prompt(self) -> int:
        return self.engines[0].max_prompt

    @property
    def default_deadline_s(self):
        return self.engines[0].default_deadline_s

    @property
    def max_restarts(self) -> int:
        return self.engines[0].max_restarts

    @property
    def restarts(self) -> int:
        """Cluster-total crash recoveries — the legacy single-keyed read;
        the frontend's per-engine breaker walks :attr:`engines` instead."""
        return sum(e.restarts for e in self.engines)

    @property
    def prefix(self):
        return self.engines[0].prefix

    def validate_request(self, req: GenerationRequest) -> None:
        self.engines[0].validate_request(req)

    # ------------------------------------------------------------- routing
    def live_engines(self) -> List[GenerativeEngine]:
        with self._lock:
            return [e for e in self.engines
                    if e.engine_id not in self._dead
                    and e._error is None and not e._stop_flag]

    def _health_check(self, now: float) -> None:
        """Slide each live engine's restart window; quarantine thrashers.
        Caller holds the router lock."""
        for e in self.engines:
            eid = e.engine_id
            if eid in self._dead:
                continue
            cur = int(e.restarts)
            new = cur - self._restart_seen.get(eid, 0)
            self._restart_seen[eid] = cur
            times = self._restart_times.setdefault(eid, deque())
            for _ in range(max(0, new)):
                times.append(now)
            while times and now - times[0] > self.quarantine_window_s:
                times.popleft()
            if (len(times) >= self.quarantine_restarts
                    and now >= self._quarantined_until.get(eid, -1.0)):
                self._quarantined_until[eid] = (
                    now + self.quarantine_cooldown_s)
                times.clear()  # a fresh thrash re-opens, not this one
                self._obs["quarantined"].inc()
                observe.log_event("cluster_quarantine", engine=eid,
                                  permanent=False,
                                  cooldown_s=self.quarantine_cooldown_s)
                logger.warning(
                    "engine %d quarantined for %.1fs (%d restarts inside "
                    "%.1fs window)", eid, self.quarantine_cooldown_s,
                    self.quarantine_restarts, self.quarantine_window_s)

    def _routable(self) -> List[GenerativeEngine]:
        now = time.monotonic()
        with self._lock:
            self._health_check(now)
            live = [e for e in self.engines
                    if e.engine_id not in self._dead
                    and e._error is None and not e._stop_flag]
            healthy = [e for e in live
                       if now >= self._quarantined_until.get(
                           e.engine_id, -1.0)]
        # quarantine deprioritises, never strands: a cluster whose every
        # engine is in cooldown still serves from the least-bad one
        return healthy or live

    @staticmethod
    def _load(e: GenerativeEngine) -> float:
        s = e.scheduler
        return (len(s.slots) + len(s.pending)) / max(1, s.max_slots)

    @staticmethod
    def _affinity(e: GenerativeEngine, prompt) -> int:
        if e.prefix is None:
            return 0
        m = e.prefix.match(prompt, max_suffix=e.suffix_bucket)
        return int(m.matched) if m is not None else 0

    def _select(self, req: GenerationRequest
                ) -> Optional[Tuple[GenerativeEngine, str, int, float]]:
        """Pick the engine for ``req``: longest usable cached prefix wins,
        load breaks ties (and overrides affinity past the imbalance cap),
        engine id makes the order total and deterministic."""
        cands = self._routable()
        if not cands:
            return None
        loads = {e.engine_id: self._load(e) for e in cands}
        min_load = min(loads.values())
        best = best_key = None
        for e in cands:
            aff = self._affinity(e, req.prompt)
            if loads[e.engine_id] - min_load > self.affinity_max_imbalance:
                aff = 0  # cache locality must not pile onto a drowning engine
            key = (-aff, loads[e.engine_id], e.engine_id)
            if best_key is None or key < best_key:
                best_key, best = key, e
        reason = "affinity" if -best_key[0] > 0 else "load"
        return best, reason, -best_key[0], best_key[1]

    # ---------------------------------------------------------- submission
    def submit(self, prompt, *, max_new_tokens: int = 16,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 1.0,
               eos_token: Optional[int] = None,
               deadline_s: Optional[float] = None, max_retries: int = 1,
               priority: int = 1, slo_class: str = "standard"
               ) -> "Future[GenerationResult]":
        """Same contract as :meth:`GenerativeEngine.submit`, routed."""
        eos = self.cfg.eos_token if eos_token is None else eos_token
        req = GenerationRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=temperature, top_k=top_k, top_p=top_p, eos_token=eos,
            deadline_s=deadline_s, max_retries=max_retries,
            priority=priority, slo_class=slo_class)
        return self.submit_request(req)

    def submit_request(self, req: GenerationRequest
                       ) -> "Future[GenerationResult]":
        """Route a pre-built request (the SLO frontend's entry point) to
        the affinity/load winner. The chosen engine applies its own
        default deadline and ``max_queue`` shed. An engine that died or
        stopped inside the selection race window is marked and the next
        candidate tried; only a fully-dead cluster raises."""
        last_exc: Optional[BaseException] = None
        for _ in range(len(self.engines)):
            sel = self._select(req)
            if sel is None:
                break
            eng, reason, aff, load = sel
            try:
                fut = eng.submit_request(req)
            except RuntimeError as exc:
                # died/stopped between selection and enqueue — the death
                # hook (or stop()) already settled its queue; route on
                last_exc = exc
                with self._lock:
                    if eng._error is not None:
                        self._dead.add(eng.engine_id)
                        self._obs["live"].set(float(len({
                            e.engine_id for e in self.engines}
                            - self._dead)))
                continue
            observe.metrics().counter(
                "dl4j_tpu_cluster_routed_total",
                engine=str(eng.engine_id), reason=reason).inc()
            observe.log_event("cluster_route", engine=eng.engine_id,
                              reason=reason, affinity_tokens=aff,
                              load=round(load, 3))
            return fut
        raise RuntimeError("no live engine in cluster") from last_exc

    # ------------------------------------------------------------ migration
    def _on_engine_death(self, eng: GenerativeEngine,
                         exc: Exception) -> None:
        """The ``on_unrecoverable`` hook: runs ONCE on ``eng``'s dying
        worker thread (or the caller's thread in inline mode) after the
        supervisor gave up. Drains the dead scheduler and migrates —
        see the module docstring for the re-admission discipline. What
        this hook retires or migrates, ``fail_all`` afterwards never
        sees: each request exits exactly once."""
        with self._lock:
            if eng.engine_id in self._dead:
                return
            self._dead.add(eng.engine_id)
            n_live = len({e.engine_id for e in self.engines} - self._dead)
            # two engines can die concurrently, each on its own worker
            # thread — the counter bump must share the de-dup critical
            # section or increments are lost
            self.deaths += 1
        self._obs["deaths"].inc()
        self._obs["live"].set(float(n_live))
        observe.log_event("cluster_quarantine", engine=eng.engine_id,
                          permanent=True, error=repr(exc))
        logger.error("engine %d is DEAD (%r) — migrating its requests "
                     "across %d survivors", eng.engine_id, exc, n_live)
        sched, cache = eng.scheduler, eng.cache
        items: List[tuple] = []
        # in-flight first: active slots in ascending order is admission
        # (arrival) order, and they are strictly older than anything
        # still queued behind them
        for slot in sched.active_slots():
            st = sched.slots.pop(slot)
            cache.free_slot(slot)
            req = st.request
            if req.retries_used < req.max_retries:
                # the cluster-wide retry charge: a migration consumes one
                # re-admission, exactly like a supervised restart did
                req.retries_used += 1
                items.append((req, st.future, st.submit_t))
            else:
                self._obs["migration_failed"].inc()
                eng._finish_unslotted(req, st.future, "error")
        with sched._plock:
            queued = list(sched.pending)
            sched.pending.clear()
        items.extend(queued)  # queued work migrates without a retry charge
        groups: Dict[int, List[tuple]] = {}
        dests: Dict[int, GenerativeEngine] = {}
        n_failed = 0
        for item in items:
            sel = self._select(item[0])
            if sel is None:
                n_failed += 1
                self._obs["migration_failed"].inc()
                eng._finish_unslotted(item[0], item[1], "error")
                continue
            dest = sel[0]
            groups.setdefault(dest.engine_id, []).append(item)
            dests[dest.engine_id] = dest
        for eid, group in groups.items():
            dest = dests[eid]
            dest.adopt_requests(group)
            with self._lock:
                # concurrent deaths migrate on separate threads; keep the
                # tally and the audit list consistent with each other
                self.migrations += len(group)
                self.migrated_requests.extend(item[0] for item in group)
            self._obs["migrated"].inc(len(group))
            observe.log_event("cluster_migrate", from_engine=eng.engine_id,
                              to_engine=eid, n=len(group))
            self._rewarm_pins(dest)
        if n_failed:
            logger.error("%d requests could not migrate off dead engine "
                         "%d (no survivor / retry budget spent)",
                         n_failed, eng.engine_id)

    # --------------------------------------------------------- prefix pins
    def prewarm_prefix(self, prompt, *, pin: bool = True):
        """Pre-warm (and by default pin) a shared prefix on EVERY live
        engine, and record the intent so a later migration re-warms it on
        the destination. The frontend's ``ClassPolicy.shared_prefix``
        calls this exactly as it would the single-engine method."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if pin:
            toks = tuple(int(t) for t in prompt)
            with self._lock:
                if toks not in self._pin_intents:
                    self._pin_intents.append(toks)
        res = None
        for e in self.live_engines():
            res = e.prewarm_prefix(prompt, pin=pin)
        return res

    def _rewarm_pins(self, dest: GenerativeEngine) -> None:
        """Re-warm recorded pin intents on a migration destination,
        fire-and-forget: record the pin intent now (so the insert
        re-pins), skip prefixes the destination already holds, and let a
        1-token generation carry the pages in behind the migrated work."""
        # racy emptiness pre-check is benign: a concurrent pin either lands
        # before the locked copy below (re-warmed now) or is re-warmed by
        # the NEXT migration; never dropped, only possibly delayed.
        if dest.prefix is None or not self._pin_intents:
            return
        with self._lock:
            intents = list(self._pin_intents)
        for toks in intents:
            arr = np.asarray(toks, np.int32)
            m = dest.prefix.match(arr)
            dest.prefix.pin(arr)  # records the intent either way
            if m is not None and m.matched >= arr.size - 1:
                continue  # already resident (and now re-pinned)
            try:
                dest.submit(arr, max_new_tokens=1, eos_token=-1,
                            priority=0, slo_class="prefix_rewarm")
            except RuntimeError:
                continue  # destination raced to death; its own hook runs
            self._obs["rewarm"].inc()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ClusterRouter":
        for e in self.live_engines():
            e.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        for e in self.engines:
            e.stop(timeout=timeout)

    def check_invariants(self) -> None:
        """Page/refcount invariants on every LIVE engine (a dead engine's
        accounting died with it)."""
        for e in self.live_engines():
            e.check_invariants()
