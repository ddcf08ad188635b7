"""SARIF 2.1.0 emission and baseline diffing for the port's lint.

``python -m repro_torch.analysis --format sarif`` serializes findings as a
SARIF log, the interchange format CI systems ingest natively.
``--baseline FILE`` subtracts a log's fingerprints from the current run,
so a gate fails on **new** findings only while tracked ones age out
visibly. The port's own tree lints clean and keeps no baseline file.

Fingerprints must survive unrelated edits: they hash the rule id, the
repo-relative path, the *text* of the flagged line (whitespace-stripped),
and the occurrence index of that (rule, line-text) pair within the file —
stable under line drift and reordering, invalidated exactly when the
flagged code itself changes.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)
TOOL_NAME = "repro-torch-lint"

#: SARIF `level` per lint severity
_LEVELS = {"error": "error", "warning": "warning"}


def _rel(path: str, root: Optional[str]) -> str:
    """Repo-relative posix path (fingerprints and SARIF URIs must not
    depend on the checkout location)."""
    p = os.path.abspath(path)
    if root:
        try:
            p = os.path.relpath(p, os.path.abspath(root))
        except ValueError:  # different drive (windows)
            pass
    return p.replace(os.sep, "/")


def _line_text(path: str, line: int, cache: Dict[str, List[str]]) -> str:
    if path not in cache:
        try:
            with open(path, encoding="utf-8") as fh:
                cache[path] = fh.read().splitlines()
        except OSError:
            cache[path] = []
    lines = cache[path]
    if 1 <= line <= len(lines):
        return lines[line - 1].strip()
    return ""


def fingerprints(findings: Sequence[Finding],
                 root: Optional[str] = None) -> List[str]:
    """One stable fingerprint per finding (order-aligned with input).

    sha256 over (rule, relative path, stripped flagged-line text,
    occurrence index of that triple within the file) — two identical
    violations on identical lines get distinct indices, and moving a
    flagged line does not change its print.
    """
    cache: Dict[str, List[str]] = {}
    counts: Dict[Tuple[str, str, str], int] = {}
    prints: List[str] = []
    for f in findings:
        rel = _rel(f.path, root)
        text = _line_text(f.path, f.line, cache)
        key = (f.rule, rel, text)
        idx = counts.get(key, 0)
        counts[key] = idx + 1
        h = hashlib.sha256(
            "\x1f".join((f.rule, rel, text, str(idx))).encode("utf-8")
        ).hexdigest()
        prints.append(h)
    return prints


def to_sarif(findings: Sequence[Finding],
             root: Optional[str] = None) -> dict:
    """A SARIF 2.1.0 log dict for one lint run."""
    from repro_torch.analysis.core import get_rules

    rules_meta = []
    for rule in get_rules():
        desc = (rule.__doc__ or rule.title).strip().splitlines()[0]
        rules_meta.append({
            "id": rule.id,
            "name": type(rule).__name__,
            "shortDescription": {"text": rule.title or rule.id},
            "fullDescription": {"text": desc},
            "help": {"text": rule.hint or ""},
            "defaultConfiguration": {
                "level": _LEVELS.get(rule.severity, "error"),
            },
        })

    prints = fingerprints(findings, root)
    results = []
    for f, fp in zip(findings, prints):
        results.append({
            "ruleId": f.rule,
            "level": _LEVELS.get(f.severity, "error"),
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {"uri": _rel(f.path, root)},
                    "region": {
                        "startLine": max(1, f.line),
                        "startColumn": f.col + 1,
                    },
                },
            }],
            "fingerprints": {"reproLint/v1": fp},
        })

    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": TOOL_NAME,
                    "rules": rules_meta,
                },
            },
            "results": results,
        }],
    }


def dump_sarif(findings: Sequence[Finding],
               root: Optional[str] = None) -> str:
    return json.dumps(to_sarif(findings, root), indent=2, sort_keys=True)


def load_baseline(path: str) -> Set[str]:
    """Fingerprint set from a committed SARIF baseline file."""
    with open(path, encoding="utf-8") as fh:
        log = json.load(fh)
    prints: Set[str] = set()
    for run in log.get("runs", []):
        for res in run.get("results", []):
            fp = res.get("fingerprints", {}).get("reproLint/v1")
            if fp:
                prints.add(fp)
    return prints


def diff_baseline(findings: Sequence[Finding], baseline: Iterable[str],
                  root: Optional[str] = None
                  ) -> Tuple[List[Finding], List[Finding]]:
    """Split findings into (new, grandfathered) against baseline prints."""
    known = set(baseline)
    prints = fingerprints(findings, root)
    new: List[Finding] = []
    old: List[Finding] = []
    for f, fp in zip(findings, prints):
        (old if fp in known else new).append(f)
    return new, old
