"""Rule protocol and the analysis runner.

Port of ``repro.analysis.engine``.  A ``Rule`` sees the whole
:class:`~repro_torch.analysis.index.FileIndex` (the host-sync pass needs
cross-module reachability and the CUDA contract pass reads ``_build.py``
beside every wrapper; per-file rules just loop over ``index.modules``) and yields :class:`Finding`s.  The runner owns the
lifecycle: build index once → run every selected rule → apply inline
suppressions → fold in parse/pragma findings.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.index import FileIndex
from repro_torch.analysis.suppress import apply_suppressions


class Rule:
    """One named check.  Subclasses set ``rule_ids`` (every id they may
    emit — the ``--rules`` filter and ``--list-rules`` read it) and
    implement :meth:`run`."""

    rule_ids: tuple[str, ...] = ()
    description: str = ""

    def run(self, index: FileIndex) -> Iterable[Finding]:
        raise NotImplementedError


def all_rules() -> list[Rule]:
    """The registered pass instances, in documentation order."""
    from repro_torch.analysis.rules import ALL_RULES

    return [cls() for cls in ALL_RULES]


@dataclasses.dataclass
class AnalysisResult:
    findings: list[Finding]  # every finding, suppressed ones flagged

    @property
    def active(self) -> list[Finding]:
        return [f for f in self.findings if not f.suppressed]

    @property
    def suppressed(self) -> list[Finding]:
        return [f for f in self.findings if f.suppressed]

    @property
    def exit_code(self) -> int:
        return 1 if self.active else 0


def run_analysis(
    paths: list[str],
    rules: list[Rule] | None = None,
    rule_filter: set[str] | None = None,
) -> AnalysisResult:
    """Parse ``paths``, run the passes, apply suppressions.

    Args:
      paths: files/directories to analyze (directories recurse over *.py).
      rules: pass instances; defaults to :func:`all_rules`.
      rule_filter: when set, keep only findings whose rule_id is in it
        (parse errors and malformed pragmas always survive the filter —
        they mean the analysis itself is compromised).
    """
    index = FileIndex.build(paths)
    if rules is None:
        rules = all_rules()
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(rule.run(index))
    if rule_filter is not None:
        findings = [f for f in findings if f.rule_id in rule_filter]
    findings.extend(index.parse_findings)
    findings.extend(index.pragma_findings)
    by_path = {m.path: m.suppressions for m in index.modules}
    findings = apply_suppressions(findings, by_path)
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return AnalysisResult(findings=findings)
