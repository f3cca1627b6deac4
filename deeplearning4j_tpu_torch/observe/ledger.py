"""Recompile ledger — every compile of a cached unit, with its cause.

Counterpart of ``deeplearning4j_tpu/observe/ledger.py``. In the JAX
package a compile is a jit trace + XLA compile; in the port it is a
CUDA-graph capture (``ops/capture.py``) on the card, and the first eager
run of a unit for a signature on the CPU, where nothing is captured —
as ``jax.jit`` still compiles on the CPU. Both report here the same way.
``SameDiff.output`` and the serving engine's three step functions report
every compile — a cached unit seeing a new input signature, or one
rebuilt after an invalidation — as one :class:`CompileEvent` carrying:

* ``graph``/``key``: which model and which cached unit (exec / prefill /
  write_prompt / decode ...),
* ``signature``: the input shape/dtype signature that compiled,
* ``cause``: ``first_compile`` | ``new_shape`` | ``graph_mutation`` |
  ``constant_rebind`` | ``variable_rebind`` | ``cache_hit`` (the JAX
  package's persistent export cache; the port has none, so it never
  records it, but accepts the name) | ``state_moved`` (the port's own: a
  training unit captured anew for a signature it had captured, because a
  tensor it writes or reads in place moved — a trainer that rebound a
  parameter instead of writing into it),
* ``stats``: the live ``OptimizeStats`` when the optimizer produced one,
  so warm-up (``trace_seconds``) and capture (``compile_seconds``) times
  appear in the event once ``CompiledGraph`` measures them.

Events also increment ``dl4j_tpu_recompiles_total`` (plus a per-cause
counter) in the default metrics registry. The JAX package's JSONL event
log is not ported.

The port adds one kind of event the JAX package has no need of: a
training step routed to eager execution instead of a capture
(:meth:`RecompileLedger.routed`, a :class:`RoutedEvent` with its reason —
the masked cuDNN LSTM step reads its mask on the host). It is not a
compile and moves no recompile counter; the trainers count every routed
step in ``dl4j_tpu_capture_skipped_total{unit,reason}``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, Optional, Tuple

from deeplearning4j_tpu_torch.observe.registry import default_registry

CAUSES = ("first_compile", "new_shape", "graph_mutation",
          "constant_rebind", "variable_rebind", "cache_hit", "state_moved")

_MAX_EVENTS = 2000

# frames inside the observe package are plumbing, not callsites; callsites
# are reported relative to the repository root
_OBS_DIR = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_OBS_DIR))


def _caller_callsite() -> Optional[str]:
    """Repo-relative ``path:line`` of the nearest stack frame outside the
    observe package: the source site that registered the compile."""
    f = sys._getframe(1)
    while f is not None:
        fname = f.f_code.co_filename
        if not os.path.abspath(fname).startswith(_OBS_DIR):
            rel = os.path.relpath(fname, _REPO_ROOT)
            if rel.startswith(".."):
                rel = fname
            return f"{rel.replace(os.sep, '/')}:{f.f_lineno}"
        f = f.f_back
    return None


@dataclasses.dataclass
class CompileEvent:
    seq: int
    graph: str            # model identity ("samediff", "serving", ...)
    key: str              # cached-unit kind ("exec", "decode", ...)
    signature: str        # input shape/dtype signature
    cause: str
    timestamp: float      # epoch seconds (display only; never subtracted)
    stats: Any = None     # OptimizeStats (live reference) or None
    callsite: Optional[str] = None  # "path:line" of the registering site

    def to_dict(self) -> Dict[str, Any]:
        out = {"seq": self.seq, "graph": self.graph, "key": self.key,
               "signature": self.signature, "cause": self.cause,
               "timestamp": self.timestamp, "callsite": self.callsite}
        st = self.stats
        if st is not None:
            out["trace_seconds"] = getattr(st, "trace_seconds", None)
            out["compile_seconds"] = getattr(st, "compile_seconds", None)
            out["optimize_seconds"] = getattr(st, "optimize_seconds", None)
            out["nodes_before"] = getattr(st, "nodes_before", None)
            out["nodes_after"] = getattr(st, "nodes_after", None)
            fusions = getattr(st, "fusions", None)
            if fusions:
                out["fusions"] = dict(fusions)
        return out


@dataclasses.dataclass(frozen=True)
class RoutedEvent:
    """A unit's signature run eagerly instead of captured, and why."""

    graph: str
    key: str
    signature: str
    reason: str

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class RecompileLedger:
    """Bounded, thread-safe event log of compilations (and of the
    signatures routed to eager execution)."""

    def __init__(self, max_events: int = _MAX_EVENTS):
        self._events: "deque[CompileEvent]" = deque(maxlen=max_events)
        self._routed: Dict[RoutedEvent, None] = {}
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, *, graph: str, key: str, signature: str, cause: str,
               stats: Any = None,
               callsite: Optional[str] = None) -> CompileEvent:
        if cause not in CAUSES:
            raise ValueError(f"unknown recompile cause '{cause}'; "
                             f"valid: {list(CAUSES)}")
        if callsite is None:
            callsite = _caller_callsite()
        with self._lock:
            self._seq += 1
            ev = CompileEvent(seq=self._seq, graph=graph, key=key,
                              signature=signature, cause=cause,
                              timestamp=time.time(), stats=stats,
                              callsite=callsite)
            self._events.append(ev)
        m = default_registry()
        m.counter("dl4j_tpu_recompiles_total").inc()
        m.counter("dl4j_tpu_recompile_cause_total", cause=cause).inc()
        return ev

    def events(self) -> Tuple[CompileEvent, ...]:
        with self._lock:
            return tuple(self._events)

    def routed(self, *, graph: str, key: str, signature: str,
               reason: str) -> None:
        """Record (once) that ``key``'s ``signature`` runs eagerly for
        ``reason``, decided before any capture."""
        ev = RoutedEvent(graph, key, signature, reason)
        with self._lock:
            self._routed.setdefault(ev, None)

    def routed_events(self) -> Tuple[RoutedEvent, ...]:
        with self._lock:
            return tuple(self._routed)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def summary(self) -> Dict[str, Any]:
        evs = self.events()
        by_cause: Dict[str, int] = {}
        by_callsite: Dict[str, int] = {}
        for ev in evs:
            by_cause[ev.cause] = by_cause.get(ev.cause, 0) + 1
            cs = ev.callsite or "<unknown>"
            by_callsite[cs] = by_callsite.get(cs, 0) + 1
        compile_s = [getattr(ev.stats, "compile_seconds", None)
                     for ev in evs if ev.stats is not None]
        compile_s = [s for s in compile_s if s is not None]
        return {"total": len(evs), "by_cause": by_cause,
                "by_callsite": by_callsite,
                "compile_seconds_sum": round(sum(compile_s), 4)
                if compile_s else None}


_DEFAULT: Optional[RecompileLedger] = None
_DEFAULT_LOCK = threading.Lock()


def default_ledger() -> RecompileLedger:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = RecompileLedger()
        return _DEFAULT


def reset_default_ledger() -> RecompileLedger:
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = None
    return default_ledger()


# ---------------------------------------------------------------------------
# helpers the runtimes call
# ---------------------------------------------------------------------------


def _dtype_name(a: Any) -> str:
    """numpy's name for ``a``'s dtype — torch dtypes by the same names
    (``float32``, ``int32``, ``bfloat16``, ``bool``)."""
    dt = getattr(a, "dtype", None)
    if dt is None:
        return type(a).__name__
    if type(dt).__module__ == "torch":
        return str(dt).replace("torch.", "")
    import numpy as np

    return np.dtype(dt).name


def signature_of(*arrays: Any, **named: Any) -> str:
    """Compact shape/dtype signature of a feed set, e.g.
    ``0:float32[32,128]|y:int32[32]``: positional arrays labelled by
    position, then name->array pairs sorted by name; None entries are
    skipped. Torch tensors and numpy arrays of one shape and dtype give
    the same string (the JAX package's for the numpy array)."""
    parts = []
    items = [(str(i), a) for i, a in enumerate(arrays)]
    items += sorted(named.items())
    for name, a in items:
        if a is None:
            continue
        shape = ",".join(str(int(d)) for d in getattr(a, "shape", ()))
        parts.append(f"{name}:{_dtype_name(a)}[{shape}]")
    return "|".join(parts)


def note_jit_signature(fn: Any, *, graph: str, key: str, signature: str,
                       stats: Any = None,
                       cause_if_new_fn: str = "first_compile",
                       callsite: Optional[str] = None) -> Optional[str]:
    """Record a compile event iff ``signature`` is new for ``fn``.

    The seen-signature set rides on the cached unit object, so the exact
    cache-invalidation paths that drop the unit also drop its history — a
    rebuilt unit reports ``cause_if_new_fn`` (the invalidation cause), a
    cached unit seeing a fresh signature reports ``new_shape`` (a new
    capture). ``stats`` is attached only to the new-unit event.
    ``callsite`` defaults to the nearest caller frame outside the observe
    package. Returns the cause recorded, or None on a plain cache hit."""
    try:
        sigs = fn._obs_sigs
    except AttributeError:
        try:
            fn._obs_sigs = sigs = set()
        except (AttributeError, TypeError):
            return None  # the unit refuses attributes; never fail a call
    if signature in sigs:
        return None
    new_fn = not sigs
    cause = cause_if_new_fn if new_fn else "new_shape"
    sigs.add(signature)
    if callsite is None:
        callsite = _caller_callsite()
    default_ledger().record(graph=graph, key=key, signature=signature,
                            cause=cause, stats=stats if new_fn else None,
                            callsite=callsite)
    return cause
