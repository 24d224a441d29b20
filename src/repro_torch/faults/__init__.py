"""Supervision of background work (port of ``repro.faults``: the policy)."""
from repro_torch.faults.policy import EXHAUSTION_MODES, FailurePolicy

__all__ = ["EXHAUSTION_MODES", "FailurePolicy"]
