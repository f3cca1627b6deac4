"""Slot-based continuous-batching scheduler — iteration-level scheduling.

Counterpart of ``deeplearning4j_tpu/serving/scheduler.py`` (Orca, OSDI '22):
a fixed bank of ``max_slots`` slots rides one decode step; between
iterations the engine retires finished slots and admits queued requests
into the freed ones. Pure host-side policy and state — no torch, no device
work. Timing uses ``time.perf_counter`` only.

Slot lifecycle::

    FREE --admit(prefill ok)--> ACTIVE --finish(eos|length)--> FREE
                                   \\--evict(overflow|oom|stopped)--> FREE
                                   \\--expire(deadline)--> FREE
                                   \\--engine failure (error)--> FREE
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Deque, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch import observe

# Terminal states, the JAX package's taxonomy. "shed" = the bounded queue
# rejected the request; "deadline" = its per-request deadline expired;
# "error" = the engine loop failed under it.
FINISH_REASONS = ("eos", "length", "overflow", "oom", "stopped",
                  "shed", "deadline", "error")


def count_terminal(reason: str) -> None:
    """Increment the ONE terminal-outcome counter family
    ``dl4j_tpu_serving_evicted_total{reason}``."""
    if reason not in FINISH_REASONS:
        raise ValueError(f"unknown finish reason {reason!r}")
    observe.metrics().counter(
        "dl4j_tpu_serving_evicted_total", reason=reason).inc()


@dataclasses.dataclass
class GenerationRequest:
    """One text-generation request (token-id space)."""

    prompt: np.ndarray               # (t,) int32 token ids
    max_new_tokens: int = 16
    temperature: float = 0.0         # <= 0 -> greedy
    top_k: int = 0                   # 0 -> disabled
    top_p: float = 1.0               # 1.0 -> disabled
    eos_token: int = -1              # -1 -> never stop on a token
    deadline_s: Optional[float] = None  # submit -> terminal budget (wall)
    max_retries: int = 1             # crash re-admissions before "error"
    retries_used: int = 0            # supervisor bookkeeping, not user-set
    priority: int = 1                # 0 = most important; ties FIFO

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens <= 0:
            raise ValueError("max_new_tokens must be positive")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 disables), "
                             f"got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (1.0 disables), "
                             f"got {self.top_p}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0 (None disables), "
                             f"got {self.deadline_s}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, "
                             f"got {self.max_retries}")
        if self.priority < 0:
            raise ValueError(f"priority must be >= 0, got {self.priority}")


@dataclasses.dataclass
class GenerationResult:
    """Completed (or evicted) generation + its latency raw material."""

    tokens: np.ndarray               # generated ids (no prompt, no eos)
    finish_reason: str
    prompt_len: int
    ttft_s: Optional[float]          # submit -> first token (perf_counter)
    intertoken_s: List[float]        # successive decode-token gaps


@dataclasses.dataclass
class _Slot:
    request: GenerationRequest
    future: "Future[GenerationResult]"
    submit_t: float
    prompt_len: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    ttft_s: Optional[float] = None
    intertoken_s: List[float] = dataclasses.field(default_factory=list)
    last_token_t: Optional[float] = None


class SlotScheduler:
    """Pending queue + slot bank. Thread-safe for one engine loop plus
    submitting client threads: every structural mutation of ``pending``
    holds ``_plock``."""

    def __init__(self, max_slots: int):
        self.max_slots = int(max_slots)
        self.pending: Deque[tuple] = deque()
        self.slots: Dict[int, _Slot] = {}
        self._plock = threading.Lock()

    # ------------------------------------------------------------ submission
    def submit(self, request: GenerationRequest) -> "Future[GenerationResult]":
        fut: "Future[GenerationResult]" = Future()
        with self._plock:
            self.pending.append((request, fut, time.perf_counter()))
        return fut

    # --------------------------------------------------------------- queries
    def active_slots(self) -> List[int]:
        return sorted(self.slots)

    def free_slot_ids(self) -> List[int]:
        return [s for s in range(self.max_slots) if s not in self.slots]

    def has_work(self) -> bool:
        return bool(self.slots) or bool(self.pending)

    def occupancy(self) -> float:
        return len(self.slots) / self.max_slots if self.max_slots else 0.0

    # --------------------------------------------------- priority admission
    def peek_best_pending(self) -> Optional[tuple]:
        """The pending item to admit NEXT: lowest ``priority`` first, then
        earliest submit time. Not removed — the engine checks the page
        pool first."""
        with self._plock:
            best, best_key = None, None
            for i, item in enumerate(self.pending):
                key = (item[0].priority, item[2], i)
                if best_key is None or key < best_key:
                    best_key, best = key, item
            return best

    def remove_pending(self, item: tuple) -> bool:
        """Remove ``item`` (by identity); False when it is gone already."""
        with self._plock:
            for i, it in enumerate(self.pending):
                if it is item:
                    del self.pending[i]
                    return True
        return False

    # ------------------------------------------------------------- lifecycle
    def admit(self, slot: int, request: GenerationRequest,
              future: "Future[GenerationResult]", submit_t: float,
              first_token: int, now: float) -> None:
        """Install a prefilled request into ``slot`` with its first sampled
        token (TTFT is measured here)."""
        st = _Slot(request=request, future=future, submit_t=submit_t,
                   prompt_len=int(request.prompt.size))
        st.tokens.append(int(first_token))
        st.ttft_s = now - submit_t
        st.last_token_t = now
        self.slots[slot] = st

    def on_decode_token(self, slot: int, token: int, now: float) -> None:
        st = self.slots[slot]
        st.tokens.append(int(token))
        if st.last_token_t is not None:
            st.intertoken_s.append(now - st.last_token_t)
        st.last_token_t = now

    def should_finish(self, slot: int) -> Optional[str]:
        """``"eos"``/``"length"`` when the slot's sequence is complete."""
        st = self.slots[slot]
        if st.tokens and st.tokens[-1] == st.request.eos_token:
            return "eos"
        if len(st.tokens) >= st.request.max_new_tokens:
            return "length"
        return None

    def retire(self, slot: int, reason: str) -> GenerationResult:
        """Remove ``slot`` and complete its future. The caller frees the
        slot's cache pages and counts the terminal reason."""
        if reason not in FINISH_REASONS:
            raise ValueError(f"unknown finish reason {reason!r}")
        st = self.slots.pop(slot)
        toks = st.tokens
        if reason == "eos" and toks and toks[-1] == st.request.eos_token:
            toks = toks[:-1]
        result = GenerationResult(
            tokens=np.asarray(toks, np.int32), finish_reason=reason,
            prompt_len=st.prompt_len, ttft_s=st.ttft_s,
            intertoken_s=list(st.intertoken_s))
        if not st.future.done():
            st.future.set_result(result)
        return result

    def fail_all(self, exc: Exception, reason: str = "error") -> None:
        """Engine failure/shutdown: fail every in-flight and queued future
        so blocked callers wake instead of hanging."""
        for slot in list(self.slots):
            st = self.slots.pop(slot, None)
            if st is not None and not st.future.done():
                st.future.set_exception(exc)
                count_terminal(reason)
        self.fail_pending(exc, reason=reason)

    def fail_pending(self, exc: Exception, reason: str = "error") -> None:
        """Fail ONLY the queued-but-never-admitted futures."""
        drained: List[tuple] = []
        while True:
            with self._plock:
                try:
                    drained.append(self.pending.popleft())
                except IndexError:
                    break
        for _req, fut, _t in drained:
            if not fut.done():
                fut.set_exception(exc)
                count_terminal(reason)
