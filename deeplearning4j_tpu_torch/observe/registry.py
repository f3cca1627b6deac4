"""Process-wide metrics registry — counters, gauges, streaming histograms.

Counterpart of ``deeplearning4j_tpu/observe/registry.py``, cut to what the
port writes: :class:`Counter`, :class:`Gauge` and :class:`Histogram`
(p50/p95/p99 over log-spaced buckets), created or fetched by ``(name,
labels)`` in one :class:`MetricsRegistry`, and :func:`log_event`, the
JSONL event log. Metric names and event kinds are the JAX package's, so a
dashboard reads either package the same way. Every instrument is safe to
write from any thread.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

# log-spaced latency bucket bounds (seconds), 100 µs to ~56 min
_DEFAULT_BOUNDS: Tuple[float, ...] = tuple(
    round(1e-4 * (2.0 ** k), 10) for k in range(26))


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class Gauge(Counter):
    """Last-written level."""

    kind = "gauge"

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Histogram:
    """Streaming histogram; quantiles interpolate inside the owning
    log-spaced bucket (error bounded by the 2x bucket ratio)."""

    kind = "histogram"

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...] = (),
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.labels = labels
        self.bounds: Tuple[float, ...] = (tuple(bounds) if bounds is not None
                                          else _DEFAULT_BOUNDS)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        if math.isnan(v):
            return
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self.counts[lo] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def quantile(self, q: float) -> Optional[float]:
        """Estimated q-quantile (q in [0, 1]); None when empty."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
            vmin, vmax = self.min, self.max
        if not total:
            return None
        rank = q * total
        cum = 0.0
        for i, c in enumerate(counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(vmin, self.bounds[0])
                hi = self.bounds[i] if i < len(self.bounds) else vmax
                frac = (rank - cum) / c
                return lo + (hi - lo) * max(0.0, min(1.0, frac))
            cum += c
        return vmax

    def percentiles(self) -> Dict[str, Optional[float]]:
        return {"p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Instrument container: create-or-get by (name, labels)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                Any] = {}

    def _get(self, cls, name: str, labels: Dict[str, str], **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, key[1], **kw)
                self._instruments[key] = inst
            elif type(inst) is not cls:
                raise TypeError(
                    f"metric '{name}' already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
        return inst

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: str) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, bounds: Optional[Sequence[float]] = None,
                  **labels: str) -> Histogram:
        return self._get(Histogram, name, labels, bounds=bounds)

    def instruments(self) -> List[Any]:
        with self._lock:
            return list(self._instruments.values())

    def family_total(self, name: str) -> float:
        """Sum of a counter/gauge family across all label sets."""
        return sum(i.value for i in self.instruments()
                   if i.name == name and not isinstance(i, Histogram))


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def default_registry() -> MetricsRegistry:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = MetricsRegistry()
        return _DEFAULT


def reset_default_registry() -> MetricsRegistry:
    """Drop every instrument and start a fresh default registry (tests)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
    return default_registry()


OBS_LOG_ENV = "DL4J_TPU_OBS_LOG"

_LOG_LOCK = threading.Lock()
# paths whose writes failed: logging to them is off (one warning a path),
# so an unwritable log costs one set lookup an event, never an exception
# inside a training or serving loop
_LOG_FAILED_PATHS: set = set()


def reset_log_state() -> None:
    """Forget failed JSONL log paths (tests; or after freeing disk)."""
    with _LOG_LOCK:
        _LOG_FAILED_PATHS.clear()


def log_event(kind: str, **fields: Any) -> None:
    """Append one JSON line to the file ``DL4J_TPU_OBS_LOG`` names (a no-op
    when it is unset): ``ts`` (epoch seconds), ``kind`` and the kind's
    fields, as the JAX package writes them. A path that cannot be written
    warns once and is not written again in this process; pointing the
    variable at another path, or :func:`reset_log_state`, turns logging
    back on."""
    path = os.environ.get(OBS_LOG_ENV)
    if not path or path in _LOG_FAILED_PATHS:
        return
    rec = {"ts": round(time.time(), 6), "kind": kind}
    rec.update(fields)
    try:
        line = json.dumps(rec, default=str)
    except (TypeError, ValueError):
        line = json.dumps({"ts": rec["ts"], "kind": kind,
                           "error": "unserializable event"})
    try:
        with _LOG_LOCK, open(path, "a", encoding="utf-8") as fh:
            fh.write(line + "\n")
    except OSError as e:
        with _LOG_LOCK:
            first = path not in _LOG_FAILED_PATHS
            _LOG_FAILED_PATHS.add(path)
        if first:
            logger.warning(
                "%s: cannot write %s (%s); JSONL event logging is off for "
                "this path for the rest of the process", OBS_LOG_ENV, path,
                e)
