"""Lightweight span tracer emitting Chrome trace events.

Counterpart of ``deeplearning4j_tpu/observe/tracing.py``: nested spans on
the monotonic clock, one track per thread, a bounded event buffer (newest
kept). The serving engine records ``serving_prefill`` and
``serving_decode`` spans here, ``CompiledGraph`` its ``jit_trace`` (the
warm-up run) and ``xla_compile`` (the capture) spans.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

_MAX_EVENTS = 20000


class SpanTracer:
    """Nested-span recorder emitting Chrome trace events."""

    def __init__(self, max_events: Optional[int] = _MAX_EVENTS):
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=max_events)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()

    def _us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    @contextlib.contextmanager
    def span(self, name: str, category: str = "step", **args):
        """Record a complete ('X') event around the with-block."""
        start = self._us()
        try:
            yield self
        finally:
            ev = {"name": name, "cat": category, "ph": "X", "ts": start,
                  "dur": self._us() - start, "pid": 0,
                  "tid": threading.get_ident() % 1_000_000, "args": args}
            with self._lock:
                self.events.append(ev)

    def complete_between(self, name: str, perf_start: float,
                         perf_end: float, category: str = "step",
                         **args) -> None:
        """Record a complete event from two ``time.perf_counter()``
        readings (the tracer's own clock)."""
        ev = {"name": name, "cat": category, "ph": "X",
              "ts": (perf_start - self._t0) * 1e6,
              "dur": (perf_end - perf_start) * 1e6, "pid": 0,
              "tid": threading.get_ident() % 1_000_000, "args": args}
        with self._lock:
            self.events.append(ev)

    def to_dict(self) -> Dict[str, Any]:
        with self._lock:
            events = list(self.events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_DEFAULT: Optional[SpanTracer] = None
_DEFAULT_LOCK = threading.Lock()


def default_tracer() -> SpanTracer:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = SpanTracer()
        return _DEFAULT


def reset_default_tracer() -> SpanTracer:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
    return default_tracer()
