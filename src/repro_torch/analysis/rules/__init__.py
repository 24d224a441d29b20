"""The four concrete passes of the port's repro-lint.

Registration order is documentation order; ``repro_torch.analysis.engine.
all_rules`` instantiates this list.  ``host_sync`` stands where the
reference has ``jit_safety`` and ``cuda_contract`` where it has
``pallas_contract``; ``concurrency`` and ``api_hygiene`` keep their rule
ids over the port's paths.
"""
from repro_torch.analysis.rules.host_sync import HostSyncRule
from repro_torch.analysis.rules.cuda_contract import CudaContractRule
from repro_torch.analysis.rules.concurrency import ConcurrencyRule
from repro_torch.analysis.rules.api_hygiene import ApiHygieneRule

ALL_RULES = (
    HostSyncRule,
    CudaContractRule,
    ConcurrencyRule,
    ApiHygieneRule,
)

__all__ = [
    "ALL_RULES",
    "HostSyncRule",
    "CudaContractRule",
    "ConcurrencyRule",
    "ApiHygieneRule",
]
