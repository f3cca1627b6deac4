"""Deterministic fault injection at a fixed catalog of named points.

Counterpart of ``deeplearning4j_tpu/faults/injection.py``, with the same
points, schedules and random streams, so one schedule fires on exactly
the same calls in both packages:

* **Off means off.** With ``DL4J_TPU_FAULTS`` unset and nothing armed,
  :func:`should_fire` is one module-bool read and one environment lookup:
  no lock, no device work, no host synchronization.
* **Deterministic.** Each armed point draws from its own
  ``random.Random`` seeded from (seed, point name), as the JAX package
  seeds it.
* **Observable.** Each fire increments
  ``dl4j_tpu_faults_injected_total{point=...}`` and writes a
  ``fault_injected`` event (``observe.log_event``).

Arming::

    DL4J_TPU_FAULTS=decode_step_error:1:4,page_oom:0.2   # env schedule
    faults.arm("worker_death", prob=1.0, after_n=10, max_fires=1)

The env syntax is ``point:prob[:after_n]``, comma separated; :func:`arm`
adds ``max_fires`` and ``seed``. Call sites use :func:`should_fire` (a
branch), :func:`maybe_fail` (raise :class:`InjectedFault`) or
:func:`maybe_sleep` (added latency).

Graceful preemption is separate from the ``preemption`` fault point: the
fault is a hard kill (the fit loop raises; a supervisor restores and
resumes), :func:`request_preemption` is the soft path a SIGTERM handler
takes (the fit loops take one final snapshot and return).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
import zlib
from typing import Dict, Optional

from deeplearning4j_tpu_torch import observe

logger = logging.getLogger(__name__)

FAULTS_ENV = "DL4J_TPU_FAULTS"

#: The injection points, each hooked at one class of call site:
#:   page_oom              serving/cache.py ensure_capacity -> "oom"
#:   decode_step_error     serving/engine.py step           -> raise
#:   slow_decode           serving/engine.py step           -> sleep
#:   worker_death          serving/engine.py _serve_loop    -> raise; also
#:                         inside the async checkpoint writer
#:                         (parallel/checkpoint.py)         -> raise
#:   checkpoint_torn_write parallel/checkpoint.py save      -> truncate file
#:   backend_init_fail     parallel/mesh.py ParallelInference start and
#:                         _run_batch                       -> raise
#:   burst_arrival         serving/frontend.py submit       -> inject a
#:                         burst of lowest-class arrivals
#:   preemption            the fit loops (MultiLayerNetwork,
#:                         ComputationGraph, SameDiff), once a batch
#:                                                          -> raise
#:   engine_death          serving/engine.py _serve_loop    -> raise with
#:                         the restart budget spent: an unrestartable kill
#:                         (a ClusterRouter migrates the engine's requests)
FAULT_POINTS = (
    "page_oom",
    "decode_step_error",
    "slow_decode",
    "worker_death",
    "checkpoint_torn_write",
    "backend_init_fail",
    "burst_arrival",
    "preemption",
    "engine_death",
)


class InjectedFault(RuntimeError):
    """Raised by a firing point; ``point`` names it, so recovery paths
    and tests can attribute the failure."""

    def __init__(self, point: str):
        super().__init__(f"injected fault: {point}")
        self.point = point


@dataclasses.dataclass
class FaultSpec:
    """One armed point and its firing schedule."""

    point: str
    prob: float = 1.0            # fire probability of each eligible call
    after_n: int = 0             # skip the first N eligible calls
    max_fires: Optional[int] = None   # stop firing after this many
    seed: int = 0
    calls: int = 0               # bookkeeping (under the module lock)
    fires: int = 0

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(
                f"unknown fault point {self.point!r}; known: {FAULT_POINTS}")
        if not 0.0 <= self.prob <= 1.0:
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.after_n < 0:
            raise ValueError(f"after_n must be >= 0, got {self.after_n}")
        # one stream a (seed, point), seeded as the JAX package seeds it
        self._rng = random.Random(
            (self.seed << 32) ^ zlib.crc32(self.point.encode()))


# one lock guards the armed table and the env-parse cache; points are
# polled at host-side step boundaries, never inside a captured region
_LOCK = threading.Lock()
_ARMED: Dict[str, FaultSpec] = {}
_ANY_ARMED = False          # the idle gate: one bool read
_ENV_CACHE: tuple = ("", ())  # (raw env value, parsed specs)


def _parse_env(raw: str):
    """``point:prob[:after_n]``, comma separated → FaultSpecs. A malformed
    entry is skipped with one warning instead of failing the process."""
    specs = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        try:
            spec = FaultSpec(
                point=parts[0],
                prob=float(parts[1]) if len(parts) > 1 else 1.0,
                after_n=int(parts[2]) if len(parts) > 2 else 0)
        except (ValueError, IndexError) as e:
            logger.warning("%s: ignoring malformed entry %r (%s)",
                           FAULTS_ENV, entry, e)
            continue
        specs.append(spec)
    return tuple(specs)


def _lookup(point: str) -> Optional[FaultSpec]:
    """The armed spec for ``point``: a programmatic arm wins over the
    env schedule. Call under ``_LOCK``."""
    global _ENV_CACHE
    spec = _ARMED.get(point)
    if spec is not None:
        return spec
    raw = os.environ.get(FAULTS_ENV, "")
    if not raw:
        return None
    if _ENV_CACHE[0] != raw:
        _ENV_CACHE = (raw, _parse_env(raw))
    for s in _ENV_CACHE[1]:
        if s.point == point:
            return s
    return None


def arm(point: str, prob: float = 1.0, after_n: int = 0,
        max_fires: Optional[int] = None, seed: int = 0) -> FaultSpec:
    """Arm ``point`` (tests, chaos runs); wins over an env schedule for
    the same point."""
    global _ANY_ARMED
    spec = FaultSpec(point=point, prob=prob, after_n=after_n,
                     max_fires=max_fires, seed=seed)
    with _LOCK:
        _ARMED[point] = spec
        _ANY_ARMED = True
    return spec


def disarm(point: str) -> None:
    global _ANY_ARMED
    with _LOCK:
        _ARMED.pop(point, None)
        _ANY_ARMED = bool(_ARMED)


def reset() -> None:
    """Disarm every programmatic point, drop the env-parse cache (a
    changed ``DL4J_TPU_FAULTS`` re-parses with fresh counters) and clear a
    pending graceful-preemption request."""
    global _ANY_ARMED, _ENV_CACHE
    with _LOCK:
        _ARMED.clear()
        _ANY_ARMED = False
        _ENV_CACHE = ("", ())
    _PREEMPTION.clear()


def active() -> bool:
    """Is anything armed (programmatically or by the env)?"""
    return _ANY_ARMED or bool(os.environ.get(FAULTS_ENV))


def fire_counts() -> Dict[str, int]:
    """point → times fired, programmatic and env arms together."""
    with _LOCK:
        out = {s.point: s.fires for s in _ENV_CACHE[1] if s.fires}
        for s in _ARMED.values():
            if s.fires:
                out[s.point] = out.get(s.point, 0) + s.fires
    return out


def should_fire(point: str) -> bool:
    """Does the schedule armed for ``point`` fire on this call? Idle, it
    is a bool read and one env lookup."""
    if not _ANY_ARMED and not os.environ.get(FAULTS_ENV):
        return False
    with _LOCK:
        spec = _lookup(point)
        if spec is None:
            return False
        spec.calls += 1
        if spec.calls <= spec.after_n:
            return False
        if spec.max_fires is not None and spec.fires >= spec.max_fires:
            return False
        if spec.prob < 1.0 and spec._rng.random() >= spec.prob:
            return False
        spec.fires += 1
    observe.metrics().counter(
        "dl4j_tpu_faults_injected_total", point=point).inc()
    observe.log_event("fault_injected", point=point)
    logger.warning("fault injected: %s (fire %d)", point, spec.fires)
    return True


def maybe_fail(point: str) -> None:
    """Raise :class:`InjectedFault` when the schedule fires."""
    if should_fire(point):
        raise InjectedFault(point)


def maybe_sleep(point: str, seconds: float) -> None:
    """Sleep ``seconds`` when the schedule fires (``slow_decode``)."""
    if should_fire(point):
        time.sleep(seconds)


# ---------------------------------------------------------------------------
# graceful preemption
# ---------------------------------------------------------------------------

_PREEMPTION = threading.Event()


def request_preemption() -> None:
    """Ask every running fit loop to snapshot and return at its next step
    boundary: the SIGTERM handler's one job. Async-signal-safe by design
    (one ``Event.set``, no lock, no logging: the handler may interrupt a
    thread that holds the log's lock); ``nn.listeners.notify_preemption``
    logs at the polling site."""
    _PREEMPTION.set()


def preemption_requested() -> bool:
    """Polled by the fit loops once a batch (an Event read)."""
    return _PREEMPTION.is_set()


def clear_preemption() -> None:
    """Drop a pending graceful-preemption request."""
    _PREEMPTION.clear()
