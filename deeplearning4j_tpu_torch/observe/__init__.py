"""Runtime telemetry of the port: metrics registry, span tracer and the
recompile ledger.

Counterpart of ``deeplearning4j_tpu/observe``. :func:`log_event` appends
one JSON line to the file ``DL4J_TPU_OBS_LOG`` names. :func:`ledger` is the
:class:`RecompileLedger` fed by every compile of a cached unit — a
CUDA-graph capture on the card (``ops/capture.py``), the first eager run
for a signature on the CPU — with its shape/dtype signature and cause
(``SameDiff.output``; the serving engine's prefill, write-prompt and
decode steps).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.observe.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    OBS_LOG_ENV,
    default_registry,
    log_event,
    reset_default_registry,
    reset_log_state,
)
from deeplearning4j_tpu_torch.observe.tracing import (
    SpanTracer,
    default_tracer,
    reset_default_tracer,
)
from deeplearning4j_tpu_torch.observe.ledger import (
    CompileEvent,
    RecompileLedger,
    default_ledger,
    note_jit_signature,
    reset_default_ledger,
    signature_of,
)

# short accessors — the names call sites use
metrics = default_registry
tracer = default_tracer
ledger = default_ledger


def reset() -> None:
    """Fresh registry, tracer and ledger (test isolation)."""
    reset_default_registry()
    reset_default_tracer()
    reset_default_ledger()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "CompileEvent", "RecompileLedger",
    "metrics", "tracer", "ledger", "default_registry", "default_tracer",
    "default_ledger", "note_jit_signature", "signature_of", "reset",
    "log_event", "reset_log_state", "OBS_LOG_ENV",
]
