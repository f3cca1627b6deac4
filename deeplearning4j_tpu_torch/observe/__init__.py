"""Runtime telemetry of the port: metrics registry and span tracer.

Counterpart of ``deeplearning4j_tpu/observe``. The recompile ledger
(``note_jit_signature``) has no meaning in eager PyTorch and is not
ported; see ROADMAP.md.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.observe.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    reset_default_registry,
)
from deeplearning4j_tpu_torch.observe.tracing import (
    SpanTracer,
    default_tracer,
    reset_default_tracer,
)

# short accessors — the names call sites use
metrics = default_registry
tracer = default_tracer


def reset() -> None:
    """Fresh registry and tracer (test isolation)."""
    reset_default_registry()
    reset_default_tracer()


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "metrics", "tracer", "default_registry", "default_tracer", "reset",
]
