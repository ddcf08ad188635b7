"""The port's lint framework: rule plugins, suppressions, file walking.

``python -m repro_torch.analysis`` is the JAX package's ``repro-lint``
(:mod:`repro.analysis`) for the PyTorch/CUDA port: the same small AST
pass, rule ids, suppression grammar, SARIF output and ``--fix``, with the
path rules rooted at the ``repro_torch`` package and each rule grounded in
the port's own idioms (torch's global RNG, host syncs in the device-step
modules ``core/`` and ``kernels/``, ``torch.load`` / ``torch.save``, the
Hopper kernels' operand contract). It imports neither JAX nor the JAX
package.

Vocabulary:

- :class:`Finding` — one violation: rule id, severity, location, message,
  hint.
- :class:`Rule` — a plugin: ``id``/``title``/``severity``/``hint`` plus
  ``applies_to(ctx)`` (path-level scoping) and ``check(module)`` yielding
  findings.  Register with :func:`register_rule`.
- :class:`ModuleInfo` — one parsed file: source, AST, repo-relative
  classification (:class:`PathInfo`) and the parsed suppressions.

Suppression grammar (the JAX package's, so one pragma serves both lints;
every suppression is expected to carry a justification after ``--``):

- ``# repro-lint: disable=RPL003`` on any line spanned by the flagged
  statement suppresses those rule ids (comma-separated, or ``all``) for
  that statement; on a comment line of its own it governs the next
  statement.
- ``# repro-lint: disable-file=RPL004`` anywhere in the file suppresses
  the ids for the whole file.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*repro-lint:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<ids>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)"
)


@dataclasses.dataclass(frozen=True)
class TextEdit:
    """A mechanical source edit: replace the span [(line, col), (end_line,
    end_col)) — 1-based lines, 0-based columns, ast coordinates — with
    ``replacement``.  Carried on :class:`Finding.fix` and applied by
    ``repro-lint --fix`` (see :mod:`repro_torch.analysis.fixes`)."""

    line: int
    col: int
    end_line: int
    end_col: int
    replacement: str


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str = "error"
    hint: str = ""
    #: optional mechanical autofix (compare=False: two findings are the
    #: same violation regardless of whether a fix could be synthesized)
    fix: Optional[TextEdit] = dataclasses.field(default=None, compare=False)

    def render(self, *, show_hint: bool = True) -> str:
        out = f"{self.path}:{self.line}:{self.col + 1}: {self.rule} {self.message}"
        if show_hint and self.hint:
            out += f"  [fix: {self.hint}]"
        return out


@dataclasses.dataclass(frozen=True)
class PathInfo:
    """Repo-relative classification of a file (layout-aware rule scoping).

    ``repro`` is the path inside the ``repro_torch`` package as posix
    segments (``("repro_torch", "fed", "engine.py")``) when the file lives
    under it, else ``()``.  The boolean surfaces name the repo's top-level
    directories.
    """

    path: str
    repro: Tuple[str, ...]
    is_tests: bool
    is_benchmarks: bool
    is_examples: bool

    def under(self, *segments: str) -> bool:
        """True if the file lives under ``repro_torch/<segments...>``."""
        return self.repro[1 : 1 + len(segments)] == segments if self.repro else False

    @property
    def is_entry_point(self) -> bool:
        """Host-side entry-point surface: CLIs, benches, examples."""
        return self.is_benchmarks or self.is_examples or self.under("launch")


#: the package segment the path rules are rooted at
PACKAGE = "repro_torch"


def classify_path(path: str) -> PathInfo:
    parts = tuple(os.path.normpath(os.path.abspath(path)).split(os.sep))
    repro: Tuple[str, ...] = ()
    if PACKAGE in parts:
        repro = parts[parts.index(PACKAGE):]
    return PathInfo(
        path=path,
        repro=repro,
        is_tests="tests" in parts,
        is_benchmarks="benchmarks" in parts,
        is_examples="examples" in parts,
    )


class ModuleInfo:
    """One parsed source file plus its suppression table."""

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.info = classify_path(path)
        # line number -> set of suppressed ids; "__file__" key for file-wide
        self.line_suppressions: Dict[int, set] = {}
        self.file_suppressions: set = set()
        for lineno, text in enumerate(self.lines, start=1):
            for m in _SUPPRESS_RE.finditer(text):
                ids = {i.strip() for i in m.group("ids").split(",")}
                if m.group("scope"):
                    self.file_suppressions |= ids
                    continue
                self.line_suppressions.setdefault(lineno, set()).update(ids)
                # a suppression on a standalone comment line governs the
                # next statement: carry it forward across the rest of the
                # comment block (where the justification lives) onto the
                # first code line
                if text.lstrip().startswith("#"):
                    ln = lineno + 1
                    while ln <= len(self.lines) and (
                        not self.lines[ln - 1].strip()
                        or self.lines[ln - 1].lstrip().startswith("#")
                    ):
                        self.line_suppressions.setdefault(ln, set()).update(ids)
                        ln += 1
                    if ln <= len(self.lines):
                        self.line_suppressions.setdefault(ln, set()).update(ids)


class Rule:
    """Base rule plugin.  Subclasses set the class attributes and implement
    :meth:`check`; ``applies_to`` scopes the rule by repo layout."""

    id: str = "RPL000"
    title: str = ""
    severity: str = "error"
    hint: str = ""

    def applies_to(self, info: PathInfo) -> bool:  # pragma: no cover - default
        return True

    def check(self, mod: ModuleInfo) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, mod: ModuleInfo, node: ast.AST, message: str,
                *, hint: Optional[str] = None,
                severity: Optional[str] = None,
                fix: Optional[TextEdit] = None) -> Finding:
        return Finding(
            rule=self.id,
            path=mod.path,
            line=getattr(node, "lineno", 0),
            col=getattr(node, "col_offset", 0),
            message=message,
            severity=self.severity if severity is None else severity,
            hint=self.hint if hint is None else hint,
            fix=fix,
        )


#: rule registry: id -> Rule instance (populated by repro_torch.analysis.rules)
RULES: Dict[str, Rule] = {}


def register_rule(cls):
    """Class decorator: instantiate and register a :class:`Rule`."""
    rule = cls()
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    RULES[rule.id] = rule
    return cls


def get_rules(select: Optional[Iterable[str]] = None,
              ignore: Optional[Iterable[str]] = None) -> List[Rule]:
    import repro_torch.analysis.rules  # noqa: F401  (registers the catalog)

    ids = sorted(RULES)
    if select:
        wanted = set(select)
        unknown = wanted - set(ids)
        if unknown:
            raise ValueError(f"unknown rule ids: {sorted(unknown)}")
        ids = [i for i in ids if i in wanted]
    if ignore:
        ids = [i for i in ids if i not in set(ignore)]
    return [RULES[i] for i in ids]


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    """Expand files/directories into .py files (skips hidden dirs and
    ``__pycache__``), deterministic order."""
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if not d.startswith(".") and d != "__pycache__"
                )
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def parse_module(path: str) -> Tuple[Optional[ModuleInfo], Optional[Finding]]:
    try:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        tree = ast.parse(source, filename=path)
    except (OSError, SyntaxError) as e:
        return None, Finding(
            rule="RPL000", path=path,
            line=getattr(e, "lineno", 0) or 0, col=0,
            message=f"could not parse: {e}", severity="error",
        )
    return ModuleInfo(path, source, tree), None


def lint_file(path: str, rules: Sequence[Rule]) -> List[Finding]:
    mod, err = parse_module(path)
    if err is not None:
        return [err]
    assert mod is not None
    out: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(mod.info):
            continue
        for f in rule.check(mod):
            # re-locate the node the finding anchored to for suppression:
            # Finding carries only line/col, so consult the line table
            if {f.rule, "all"} & mod.file_suppressions:
                continue
            if {f.rule, "all"} & mod.line_suppressions.get(f.line, set()):
                continue
            out.append(f)
    return out


def lint_paths(paths: Sequence[str],
               *,
               select: Optional[Iterable[str]] = None,
               ignore: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the (selected) rule catalog over ``paths``; returns findings
    sorted by location."""
    rules = get_rules(select, ignore)
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path, rules))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


# ---------------------------------------------------------------------------
# small AST helpers shared by the rule catalog
# ---------------------------------------------------------------------------


def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains, "" when not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def call_name(node: ast.Call) -> str:
    return dotted_name(node.func)
