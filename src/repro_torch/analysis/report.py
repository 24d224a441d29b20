"""Human and JSON reporters for analysis results.

Port of ``repro.analysis.report``: the same text and the same JSON
document (schema 1).
"""
from __future__ import annotations

import json

from repro_torch.analysis.engine import AnalysisResult

JSON_SCHEMA_VERSION = 1


def render_human(result: AnalysisResult, verbose: bool = False) -> str:
    """One finding per line, grep-able, suppressed ones only with -v."""
    lines = [
        f.format()
        for f in result.findings
        if verbose or not f.suppressed
    ]
    active = result.active
    summary = (
        f"{len(active)} finding(s)"
        f" ({len(result.suppressed)} suppressed)"
        if result.suppressed
        else f"{len(active)} finding(s)"
    )
    if active or verbose:
        lines.append(summary)
    else:
        lines.append(f"clean — {summary}")
    return "\n".join(lines)


def render_json(result: AnalysisResult) -> str:
    """Machine-readable report (CI uploads this as an artifact).

    Suppressed findings are included with ``"suppressed": true`` so the
    artifact is an audit trail of every exemption, not just the failures.
    """
    by_rule: dict[str, int] = {}
    for f in result.active:
        by_rule[f.rule_id] = by_rule.get(f.rule_id, 0) + 1
    doc = {
        "schema": JSON_SCHEMA_VERSION,
        "findings": [f.to_dict() for f in result.findings],
        "counts": {
            "active": len(result.active),
            "suppressed": len(result.suppressed),
            "by_rule": by_rule,
        },
        "exit_code": result.exit_code,
    }
    return json.dumps(doc, indent=2, sort_keys=True)
