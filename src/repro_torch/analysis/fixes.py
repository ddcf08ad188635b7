"""Mechanical autofix application for ``python -m repro_torch.analysis --fix``.

Rules attach a :class:`repro_torch.analysis.core.TextEdit` to a finding when
the repair is purely mechanical and meaning-preserving:

- RPL003's ``os.listdir`` → ``sorted(os.listdir(...))``;
- RPL005's unmasked factor-constructor kwarg → re-mask with the mask
  variable that is live at the write (``mask_coeff(expr, m)`` for ``S``,
  ``(expr) * m[..., None, :]`` for ``U``/``V``).

Findings without an edit can still be *scaffolded* (``--fix
--scaffold``): a suppression comment with a ``TODO`` justification is
inserted above the flagged line, turning an un-autofixable finding into
an auditable, greppable debt marker instead of a red CI.

Edits apply bottom-up (last line first) so earlier spans never shift,
and overlapping edits are dropped deterministically.  ``--fix`` re-lints
after writing; the round trip is a fixpoint (tested on seeded mutants):
applying fixes twice changes nothing the second time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.core import Finding, TextEdit


@dataclasses.dataclass
class FixResult:
    """What ``apply_fixes`` did to one file."""

    path: str
    applied: int = 0
    scaffolded: int = 0
    skipped: int = 0  # findings with no edit (and scaffolding off)


def _span_key(e: TextEdit) -> Tuple[int, int]:
    return (e.line, e.col)


def _apply_edit(lines: List[str], e: TextEdit) -> bool:
    """Splice one edit into the line list (1-based lines, 0-based cols)."""
    if not (1 <= e.line <= len(lines) and 1 <= e.end_line <= len(lines)):
        return False
    first = lines[e.line - 1]
    last = lines[e.end_line - 1]
    if e.col > len(first) or e.end_col > len(last):
        return False
    patched = first[: e.col] + e.replacement + last[e.end_col:]
    lines[e.line - 1: e.end_line] = patched.split("\n")
    return True


def _scaffold_comment(f: Finding, indent: str) -> str:
    return (
        f"{indent}# repro-lint: disable={f.rule} -- TODO justify: "
        f"{f.message}"
    )


def apply_fixes(
    path: str,
    findings: Sequence[Finding],
    *,
    scaffold: bool = False,
) -> FixResult:
    """Apply every finding's edit for one file; optionally scaffold
    suppressions for the rest.  Returns counts; writes only on change."""
    result = FixResult(path=path)
    mine = [f for f in findings if f.path == path]
    if not mine:
        return result
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    lines = source.split("\n")

    # 1) real edits, bottom-up, overlap-free
    edits: List[TextEdit] = []
    taken: List[Tuple[int, int, int, int]] = []
    for f in sorted(
        (f for f in mine if f.fix is not None),
        key=lambda f: _span_key(f.fix),  # type: ignore[arg-type]
        reverse=True,
    ):
        e = f.fix
        assert e is not None
        span = (e.line, e.col, e.end_line, e.end_col)
        if any(
            not (span[2:] <= t[:2] or t[2:] <= span[:2]) for t in taken
        ):
            result.skipped += 1
            continue
        taken.append(span)
        edits.append(e)
    for e in edits:  # already sorted descending: later spans first
        if _apply_edit(lines, e):
            result.applied += 1
        else:
            result.skipped += 1

    # 2) suppression scaffolds for findings with no mechanical edit —
    # grouped per line, inserted bottom-up so linenos stay valid
    if scaffold:
        by_line: Dict[int, List[Finding]] = {}
        for f in mine:
            if f.fix is None and 1 <= f.line <= len(lines):
                by_line.setdefault(f.line, []).append(f)
        for line in sorted(by_line, reverse=True):
            target = lines[line - 1]
            indent = target[: len(target) - len(target.lstrip())]
            seen: set = set()
            for f in by_line[line]:
                if f.rule in seen:
                    continue
                seen.add(f.rule)
                lines.insert(line - 1, _scaffold_comment(f, indent))
                result.scaffolded += 1
    else:
        result.skipped += sum(1 for f in mine if f.fix is None)

    patched = "\n".join(lines)
    if patched != source and (result.applied or result.scaffolded):
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(patched)
    return result


def apply_all(findings: Sequence[Finding], *,
              scaffold: bool = False) -> List[FixResult]:
    """Group findings by file and fix each; deterministic path order."""
    paths = sorted({f.path for f in findings})
    return [apply_fixes(p, findings, scaffold=scaffold) for p in paths]
