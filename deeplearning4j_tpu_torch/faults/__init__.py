"""Fault injection and the graceful-preemption flag.

Counterpart of ``deeplearning4j_tpu/faults``: the catalog of named fault
points the recovery paths are proven against (serving restarts and
retries, checkpoint fallback, supervised resume), armed by :func:`arm`
or the ``DL4J_TPU_FAULTS`` schedule, and the flag a SIGTERM handler sets
so the fit loops snapshot and exit cleanly. Imports neither torch nor the
model runtimes (only ``observe``): any layer may import it.
"""

from deeplearning4j_tpu_torch.faults.injection import (
    FAULT_POINTS,
    FAULTS_ENV,
    FaultSpec,
    InjectedFault,
    active,
    arm,
    clear_preemption,
    disarm,
    fire_counts,
    maybe_fail,
    maybe_sleep,
    preemption_requested,
    request_preemption,
    reset,
    should_fire,
)

__all__ = [
    "FAULT_POINTS", "FAULTS_ENV", "FaultSpec", "InjectedFault",
    "active", "arm", "clear_preemption", "disarm", "fire_counts",
    "maybe_fail", "maybe_sleep", "preemption_requested",
    "request_preemption", "reset", "should_fire",
]
