"""repro-lint for the PyTorch/CUDA port (port of ``repro.analysis``).

The port's speed rests on the same invariants as the reference's, in
other words: the greedy loops of device-resident engines keep their state
on the card, every hand-written CUDA kernel is bound with the C signature
it was compiled with and counted where it launches, nothing falls back
from a kernel to its plain twin, and the async refresh machinery stays
race-free.  They are checked by a project-owned rule engine over ``ast``
and the text of ``kernels/csrc/*.cu``; nothing here imports torch:

  * :mod:`repro_torch.analysis.index` — shared file/symbol index (a copy
    of the reference's);
  * :mod:`repro_torch.analysis.engine` — the ``Rule`` protocol and runner;
  * :mod:`repro_torch.analysis.findings` / :mod:`.suppress` — ``Finding``
    records and the reference's inline suppression syntax
    ``# repro-lint: disable=RULE  # reason``, so one pragma serves both
    linters;
  * :mod:`repro_torch.analysis.rules` — the four passes: host syncs (in
    place of jit-safety), the CUDA wrapper contract (in place of the
    Pallas contract), concurrency, API hygiene;
  * :mod:`repro_torch.analysis.report` — human and JSON reporters;
  * ``python -m repro_torch.analysis`` — the CLI (exit 0 clean / 1
    findings / 2 usage or internal error), ``src/repro_torch`` by default.
"""
from repro_torch.analysis.engine import AnalysisResult, Rule, all_rules, run_analysis
from repro_torch.analysis.findings import Finding, SEVERITIES
from repro_torch.analysis.index import FileIndex, ModuleInfo

__all__ = [
    "AnalysisResult",
    "Rule",
    "all_rules",
    "run_analysis",
    "Finding",
    "SEVERITIES",
    "FileIndex",
    "ModuleInfo",
]
