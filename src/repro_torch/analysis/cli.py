"""Command-line entry point: ``python -m repro_torch.analysis [paths...]``.

Port of ``repro.analysis.cli`` with the port's tree as the default path.

Exit codes: 0 = clean (suppressed findings allowed), 1 = unsuppressed
findings, 2 = usage/configuration error.  ``--format json`` emits the
machine-readable report CI uploads as an artifact.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Sequence

from repro_torch.analysis.engine import all_rules, run_analysis
from repro_torch.analysis.report import render_human, render_json

EXIT_CLEAN = 0
EXIT_FINDINGS = 1
EXIT_USAGE = 2


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description=(
            "repro-lint for the PyTorch/CUDA port: host syncs on traced "
            "and device-resident paths, CUDA wrapper contracts, "
            "concurrency discipline, API hygiene"
        ),
    )
    parser.add_argument(
        "paths",
        nargs="*",
        default=["src/repro_torch"],
        help="files or directories to analyze (default: src/repro_torch)",
    )
    parser.add_argument(
        "--format",
        choices=("human", "json"),
        default="human",
        help="report format (default: human)",
    )
    parser.add_argument(
        "--rules",
        default=None,
        help="comma-separated rule_id filter (e.g. flat-engine-knob)",
    )
    parser.add_argument(
        "--list-rules",
        action="store_true",
        help="list every rule_id with its description and exit",
    )
    parser.add_argument(
        "--verbose",
        action="store_true",
        help="also show suppressed findings in human output",
    )
    return parser


def _known_rule_ids() -> dict[str, str]:
    out: dict[str, str] = {}
    for rule in all_rules():
        for rid in rule.rule_ids:
            out[rid] = rule.description
    return out


def main(argv: Sequence[str] | None = None) -> int:
    parser = build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:  # argparse exits 2 on bad flags already
        return EXIT_USAGE if e.code not in (0, None) else EXIT_CLEAN

    known = _known_rule_ids()
    if args.list_rules:
        for rid in sorted(known):
            print(f"{rid}: {known[rid]}")
        return EXIT_CLEAN

    rule_filter = None
    if args.rules:
        rule_filter = frozenset(
            r.strip() for r in args.rules.split(",") if r.strip()
        )
        unknown = rule_filter - set(known)
        if unknown:
            print(
                f"error: unknown rule id(s): {', '.join(sorted(unknown))} "
                f"(--list-rules shows all)",
                file=sys.stderr,
            )
            return EXIT_USAGE

    missing = [p for p in args.paths if not Path(p).exists()]
    if missing:
        print(
            f"error: no such file or directory: {', '.join(missing)}",
            file=sys.stderr,
        )
        return EXIT_USAGE

    try:
        result = run_analysis(args.paths, rule_filter=rule_filter)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return EXIT_USAGE

    if args.format == "json":
        print(render_json(result))
    else:
        print(render_human(result, verbose=args.verbose))
    return EXIT_FINDINGS if result.active else EXIT_CLEAN


if __name__ == "__main__":  # pragma: no cover - exercised via __main__.py
    sys.exit(main())
