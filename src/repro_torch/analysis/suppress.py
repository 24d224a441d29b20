"""Narrow inline suppressions: ``# repro-lint: disable=RULE  # reason``.

A copy of ``repro.analysis.suppress``: the same pragma serves both linters.

A suppression silences findings of the named rule(s) on *its own line
only* — there is no file- or block-scope form, so a suppression can never
hide a regression introduced ten lines below it.  The trailing ``# reason``
is mandatory: a suppression without one is itself a finding
(``suppression-missing-reason``), because "why is this line exempt" is
exactly the information the next reader needs.

Syntax::

    risky_call()  # repro-lint: disable=host-sync  # finalize runs on host

    two()  # repro-lint: disable=rule-a,rule-b  # one reason covers both
"""
from __future__ import annotations

import dataclasses
import re

from repro_torch.analysis.findings import Finding

_PRAGMA = re.compile(
    r"#\s*repro-lint:\s*disable=(?P<rules>[A-Za-z0-9_,\-\s]+?)"
    r"(?:\s*#\s*(?P<reason>.*\S))?\s*$"
)
# A line is a pragma *candidate* only when 'repro-lint' appears after a
# comment hash; prose that merely mentions the tool is not a pragma.
_CANDIDATE = re.compile(r"#\s*repro-lint\b")

SUPPRESSION_RULE_ID = "suppression-missing-reason"


@dataclasses.dataclass(frozen=True)
class Suppression:
    line: int
    rules: frozenset[str]
    reason: str


def parse_suppressions(
    path: str, source_lines: list[str]
) -> tuple[dict[int, frozenset[str]], list[Finding]]:
    """Scan a file's lines for suppression pragmas.

    Returns ({line: rule_ids}, findings) where findings are the malformed
    pragmas (missing reason / empty rule list) — these are ordinary
    error-severity findings, so an unjustified suppression fails the gate
    it was trying to dodge.
    """
    by_line: dict[int, frozenset[str]] = {}
    findings: list[Finding] = []
    for lineno, text in enumerate(source_lines, start=1):
        if _CANDIDATE.search(text) is None:
            continue
        m = _PRAGMA.search(text)
        if m is None:
            findings.append(
                Finding(
                    path,
                    lineno,
                    SUPPRESSION_RULE_ID,
                    "malformed repro-lint pragma (want "
                    "'# repro-lint: disable=RULE  # reason')",
                )
            )
            continue
        rules = frozenset(
            r.strip() for r in m.group("rules").split(",") if r.strip()
        )
        reason = (m.group("reason") or "").strip()
        if not rules:
            findings.append(
                Finding(
                    path, lineno, SUPPRESSION_RULE_ID,
                    "suppression names no rules",
                )
            )
            continue
        if not reason:
            findings.append(
                Finding(
                    path,
                    lineno,
                    SUPPRESSION_RULE_ID,
                    "suppression has no justification; append "
                    "'# <reason>' after the rule list",
                )
            )
            continue
        by_line[lineno] = by_line.get(lineno, frozenset()) | rules
    return by_line, findings


def apply_suppressions(
    findings: list[Finding], by_path: dict[str, dict[int, frozenset[str]]]
) -> list[Finding]:
    """Mark findings whose (path, line) carries a matching pragma."""
    out = []
    for f in findings:
        rules = by_path.get(f.path, {}).get(f.line)
        if rules is not None and f.rule_id in rules:
            f = dataclasses.replace(f, suppressed=True)
        out.append(f)
    return out
