"""Fault injection and failure policy (port of ``repro.faults``).

A deterministic, seedable fault-injection registry (:class:`FaultPlan`,
consulted by the :func:`fault_point`/:func:`fault_value` hooks at the
refresh worker, feature extraction, the coreset service's ingest and the
process tree's store reads and publishes) plus
the :class:`FailurePolicy` record that ``AsyncRefresher``, the trainer and
the coreset service interpret when real work fails.
"""
from repro_torch.faults.plan import (
    ENV_VAR,
    FAULT_KINDS,
    FaultInjected,
    FaultPlan,
    FaultSpec,
    active_plan,
    clear,
    fault_point,
    fault_value,
    injected,
    install,
    install_from_env,
)
from repro_torch.faults.policy import EXHAUSTION_MODES, FailurePolicy

__all__ = [
    "ENV_VAR",
    "EXHAUSTION_MODES",
    "FAULT_KINDS",
    "FailurePolicy",
    "FaultInjected",
    "FaultPlan",
    "FaultSpec",
    "active_plan",
    "clear",
    "fault_point",
    "fault_value",
    "injected",
    "install",
    "install_from_env",
]
