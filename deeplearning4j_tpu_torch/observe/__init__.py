"""Runtime telemetry of the port: metrics registry, span tracer and the
recompile ledger.

Counterpart of ``deeplearning4j_tpu/observe``. :func:`log_event` appends
one JSON line to the file ``DL4J_TPU_OBS_LOG`` names. :func:`ledger` is the
:class:`RecompileLedger` fed by every compile of a cached unit — a
CUDA-graph capture on the card (``ops/capture.py``), the first eager run
for a signature on the CPU — with its shape/dtype signature and cause
(``SameDiff.output``; the serving engine's prefill, write-prompt and
decode steps). :func:`summary` is the compact cross-layer snapshot, and
:func:`dispatch_summary` its helper-dispatch section: how often each op
took its kernel or its generic, and why (``usable``, ``not_usable``,
``crossover`` — a measured crossover of ``ops/tuning.py`` —,
``forced_generic``, ``forced_kernel``, ``no_helper``).
"""

from __future__ import annotations

from typing import Any, Dict

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
    RoutedEvent,
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


def _ms(seconds) -> Any:
    return None if seconds is None else round(seconds * 1e3, 3)


def dispatch_summary() -> Dict[str, int]:
    """Helper-dispatch decisions (``dl4j_tpu_helper_dispatch_total``) as a
    compact ``op/impl/reason -> count`` map — how many times resolve picked
    the CUDA kernel or the generic, and why. A routing regression (flash
    deferring everywhere after a crossover moved) shows up here instead of
    only as a throughput delta."""
    out: Dict[str, int] = {}
    for inst in metrics().instruments():
        if inst.name != "dl4j_tpu_helper_dispatch_total":
            continue
        lbl = dict(inst.labels)
        key = f"{lbl.get('op')}/{lbl.get('impl')}/{lbl.get('reason')}"
        out[key] = out.get(key, 0) + int(inst.value)
    return dict(sorted(out.items()))


def summary() -> Dict[str, Any]:
    """Compact cross-layer snapshot, in the JAX package's sections:
    recompiles, helper-dispatch decisions, train-step and serving latency
    percentiles, speculation, the prefix cache, the SLO frontend,
    checkpointing, robustness and request-level serving. Empty sections
    are left out: a line carries only what the run exercised."""
    m = metrics()
    out: Dict[str, Any] = {}

    led = ledger().summary()
    if led["total"]:
        out["recompiles"] = led

    disp = dispatch_summary()
    if disp:
        out["dispatch"] = disp

    steps = m.family_total("dl4j_tpu_train_steps_total")
    if steps:
        h = m.merged_histogram("dl4j_tpu_train_step_seconds")
        pct = h.percentiles()
        out["train"] = {
            "steps": int(steps),
            "examples": int(
                m.family_total("dl4j_tpu_train_examples_total")),
            "step_p50_ms": _ms(pct["p50"]),
            "step_p95_ms": _ms(pct["p95"]),
            "step_p99_ms": _ms(pct["p99"]),
        }

    gen = m.counter("dl4j_tpu_serving_generated_tokens_total").value
    if gen:
        dec = m.histogram("dl4j_tpu_serving_decode_step_seconds").percentiles()
        ttft = m.histogram("dl4j_tpu_serving_ttft_seconds").percentiles()
        itl = m.histogram("dl4j_tpu_serving_intertoken_seconds").percentiles()
        out["generate"] = {
            "generated_tokens": int(gen),
            "admitted": int(
                m.counter("dl4j_tpu_serving_admitted_total").value),
            "evicted": int(
                m.family_total("dl4j_tpu_serving_evicted_total")),
            "decode_p50_ms": _ms(dec["p50"]),
            "decode_p99_ms": _ms(dec["p99"]),
            "ttft_p50_ms": _ms(ttft["p50"]),
            "ttft_p99_ms": _ms(ttft["p99"]),
            "intertoken_p50_ms": _ms(itl["p50"]),
            "intertoken_p99_ms": _ms(itl["p99"]),
        }

    proposed = m.counter("dl4j_tpu_spec_proposed_tokens_total").value
    if proposed:
        accepted = m.counter("dl4j_tpu_spec_accepted_tokens_total").value
        ratio = m.histogram("dl4j_tpu_spec_accept_ratio").percentiles()
        out["spec"] = {
            "proposed_tokens": int(proposed),
            "accepted_tokens": int(accepted),
            "rejected_tokens": int(
                m.counter("dl4j_tpu_spec_rejected_tokens_total").value),
            "acceptance_rate": round(accepted / proposed, 4),
            "accept_ratio_p50": None if ratio["p50"] is None
            else round(ratio["p50"], 3),
        }

    lookups = m.counter("dl4j_tpu_prefix_lookups_total").value
    if lookups:
        hits = m.counter("dl4j_tpu_prefix_hits_total").value
        out["prefix"] = {
            "lookups": int(lookups),
            "hits": int(hits),
            "hit_rate": round(hits / lookups, 4),
            "hit_tokens": int(
                m.counter("dl4j_tpu_prefix_hit_tokens_total").value),
            "cow_copies": int(
                m.counter("dl4j_tpu_prefix_cow_copies_total").value),
            "inserted_pages": int(
                m.counter("dl4j_tpu_prefix_inserted_pages_total").value),
            "evicted_pages": int(
                m.counter("dl4j_tpu_prefix_evicted_pages_total").value),
            "tree_pages": int(m.gauge("dl4j_tpu_prefix_tree_pages").value),
            "pinned_pages": int(
                m.gauge("dl4j_tpu_prefix_pinned_pages").value),
        }

    slo_admitted = m.family_total("dl4j_tpu_slo_admitted_total")
    slo_shed = m.family_total("dl4j_tpu_slo_shed_total")
    if slo_admitted or slo_shed:
        admitted_by_class: Dict[str, int] = {}
        shed_by: Dict[str, int] = {}
        transitions: Dict[str, int] = {}
        for inst in m.instruments():
            lbl = dict(inst.labels)
            if inst.name == "dl4j_tpu_slo_admitted_total" and lbl:
                admitted_by_class[lbl.get("class", "?")] = int(inst.value)
            elif inst.name == "dl4j_tpu_slo_shed_total" and lbl:
                key = f"{lbl.get('class')}/{lbl.get('reason')}"
                shed_by[key] = shed_by.get(key, 0) + int(inst.value)
            elif inst.name == "dl4j_tpu_slo_transitions_total" and lbl:
                transitions[lbl.get("to", "?")] = int(inst.value)
        out["slo"] = {
            "state": int(m.gauge("dl4j_tpu_slo_state").value),
            "breaker_open": int(m.gauge("dl4j_tpu_slo_breaker_open").value),
            "admitted": dict(sorted(admitted_by_class.items())),
            "shed": dict(sorted(shed_by.items())),
            "degraded": int(m.family_total("dl4j_tpu_slo_degraded_total")),
            "transitions": dict(sorted(transitions.items())),
        }

    # preemption-proof training (docs/ROBUSTNESS.md § Preemption-proof
    # training): async checkpoint pipeline health + resume/preemption
    # counts — reported whenever the async writer or supervisor ran
    ck_async = m.counter("dl4j_tpu_ckpt_async_saves_total").value
    ck_resumes = m.counter("dl4j_tpu_ckpt_resumes_total").value
    ck_preempt = m.counter("dl4j_tpu_train_preemptions_total").value
    if ck_async or ck_resumes or ck_preempt:
        wh = m.histogram("dl4j_tpu_ckpt_write_seconds").percentiles()
        out["training"] = {
            "async_saves": int(ck_async),
            "write_p50_ms": _ms(wh["p50"]),
            "write_p99_ms": _ms(wh["p99"]),
            "queue_depth": int(m.gauge("dl4j_tpu_ckpt_queue_depth").value),
            "dropped": int(m.counter("dl4j_tpu_ckpt_dropped_total").value),
            "blocked": int(m.counter("dl4j_tpu_ckpt_blocked_total").value),
            "resumes": int(ck_resumes),
            "preemptions": int(ck_preempt),
        }

    robustness = {
        "faults_injected": int(
            m.family_total("dl4j_tpu_faults_injected_total")),
        "engine_restarts": int(
            m.counter("dl4j_tpu_serving_engine_restarts_total").value),
        "retries": int(m.counter("dl4j_tpu_serving_retries_total").value),
        "shed": int(m.counter("dl4j_tpu_serving_evicted_total",
                              reason="shed").value),
        "checkpoint_corrupt": int(
            m.counter("dl4j_tpu_checkpoint_corrupt_total").value),
        "checkpoint_fallbacks": int(
            m.counter("dl4j_tpu_checkpoint_fallback_total").value),
    }
    if any(robustness.values()):
        # reported when ANY of it happened — a real (un-injected) torn
        # checkpoint or shed burst must be as visible as a chaos run
        out["robustness"] = robustness

    reqs = m.counter("dl4j_tpu_serving_requests_total").value
    if reqs:
        h = m.histogram("dl4j_tpu_serving_request_seconds")
        pct = h.percentiles()
        occ = m.histogram("dl4j_tpu_serving_batch_occupancy")
        out["serving"] = {
            "requests": int(reqs),
            "batches": int(m.counter("dl4j_tpu_serving_batches_total").value),
            "p50_ms": _ms(pct["p50"]),
            "p95_ms": _ms(pct["p95"]),
            "p99_ms": _ms(pct["p99"]),
            "batch_occupancy_mean": round(occ.mean, 4) if occ.count else None,
        }
    return out


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "SpanTracer",
    "CompileEvent", "RecompileLedger", "RoutedEvent",
    "metrics", "tracer", "ledger", "default_registry", "default_tracer",
    "default_ledger", "note_jit_signature", "signature_of", "reset",
    "log_event", "reset_log_state", "OBS_LOG_ENV", "summary",
    "dispatch_summary",
]
