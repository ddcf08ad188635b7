"""CLI of the port's lint: ``python -m repro_torch.analysis [paths...]``.

Exit status 0 when the tree is clean (or every finding is grandfathered
by ``--baseline``), 1 when any gating finding survives suppression, 2 on
usage errors — so CI and pre-commit can gate on it.

- ``--format sarif`` emits a SARIF 2.1.0 log (``--output`` to a file);
- ``--baseline FILE.sarif`` subtracts known fingerprints:
  only *new* findings gate, grandfathered ones are reported as such;
- ``--fix`` applies mechanical autofixes in place and re-lints (the
  exit code reflects the post-fix tree); ``--scaffold`` additionally
  inserts TODO-suppression comments for findings with no mechanical fix.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.analysis.core import get_rules, lint_paths


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="invariant analyzer for the FeDLRT PyTorch/CUDA port",
    )
    ap.add_argument(
        "paths", nargs="*", default=["src"],
        help="files or directories to lint (default: src)",
    )
    ap.add_argument(
        "--select", metavar="IDS",
        help="comma-separated rule ids to run (default: all)",
    )
    ap.add_argument(
        "--ignore", metavar="IDS",
        help="comma-separated rule ids to skip",
    )
    ap.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalog and exit",
    )
    ap.add_argument(
        "--no-hints", action="store_true",
        help="omit the autofix hints from output",
    )
    ap.add_argument(
        "--format", choices=("text", "sarif"), default="text",
        help="output format (sarif = SARIF 2.1.0)",
    )
    ap.add_argument(
        "--output", metavar="FILE",
        help="write the report to FILE instead of stdout",
    )
    ap.add_argument(
        "--baseline", metavar="SARIF",
        help="SARIF baseline: findings whose fingerprint it contains are "
             "grandfathered and do not gate",
    )
    ap.add_argument(
        "--fix", action="store_true",
        help="apply mechanical autofixes in place, then re-lint",
    )
    ap.add_argument(
        "--scaffold", action="store_true",
        help="with --fix: insert TODO-suppression scaffolds for findings "
             "that have no mechanical fix",
    )
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in get_rules():
            print(f"{rule.id}  [{rule.severity}]  {rule.title}")
            if rule.hint:
                print(f"        fix: {rule.hint}")
        return 0
    if args.scaffold and not args.fix:
        print("repro-torch-lint: --scaffold requires --fix", file=sys.stderr)
        return 2

    select = args.select.split(",") if args.select else None
    ignore = args.ignore.split(",") if args.ignore else None
    try:
        findings = lint_paths(args.paths, select=select, ignore=ignore)
    except ValueError as e:
        print(f"repro-torch-lint: {e}", file=sys.stderr)
        return 2

    if args.fix and findings:
        from repro_torch.analysis.fixes import apply_all

        results = apply_all(findings, scaffold=args.scaffold)
        applied = sum(r.applied for r in results)
        scaffolded = sum(r.scaffolded for r in results)
        print(
            f"repro-torch-lint: applied {applied} fix(es), "
            f"scaffolded {scaffolded} suppression(s)",
            file=sys.stderr,
        )
        findings = lint_paths(args.paths, select=select, ignore=ignore)

    root = os.getcwd()
    gating = findings
    grandfathered = []
    if args.baseline:
        from repro_torch.analysis.sarif import diff_baseline, load_baseline

        try:
            known = load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"repro-torch-lint: cannot read baseline: {e}", file=sys.stderr)
            return 2
        gating, grandfathered = diff_baseline(findings, known, root)

    if args.format == "sarif":
        from repro_torch.analysis.sarif import dump_sarif

        report = dump_sarif(findings, root)
    else:
        shown = gating if args.baseline else findings
        lines = [f.render(show_hint=not args.no_hints) for f in shown]
        report = "\n".join(lines)

    if args.output:
        with open(args.output, "w", encoding="utf-8") as fh:
            fh.write(report + "\n")
    elif report:
        print(report)

    if grandfathered:
        print(
            f"repro-torch-lint: {len(grandfathered)} grandfathered finding(s) "
            "tracked in the baseline",
            file=sys.stderr,
        )
    if gating:
        print(
            f"repro-torch-lint: {len(gating)} finding(s) "
            f"in {len({f.path for f in gating})} file(s)"
            + (" beyond the baseline" if args.baseline else ""),
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
