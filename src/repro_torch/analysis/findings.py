"""Structured lint findings: what every rule emits and every reporter reads.

A copy of ``repro.analysis.findings``.
"""
from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One diagnostic, anchored to a source line.

    Attributes:
      path: file path as given to the runner (repo-relative in CI).
      line: 1-based line of the offending node (suppressions match here).
      rule_id: stable kebab-case id (``--rules`` filter / ``disable=`` key).
      message: human sentence; says what is wrong *and* which invariant it
        breaks, since the reader is usually three call frames from the
        context that makes the line a bug.
      severity: 'error' | 'warning'.  Both fail the CI gate unsuppressed;
        the split exists so downstream tooling can triage.
      suppressed: True once an inline suppression matched (kept in the
        JSON report for auditability; excluded from the exit-code count).
    """

    path: str
    line: int
    rule_id: str
    message: str
    severity: str = "error"
    suppressed: bool = False

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def format(self) -> str:
        tag = " [suppressed]" if self.suppressed else ""
        return (
            f"{self.path}:{self.line}: {self.severity}: "
            f"[{self.rule_id}] {self.message}{tag}"
        )
