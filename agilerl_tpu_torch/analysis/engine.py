"""graftcheck engine (the port's copy) — file discovery, per-file analysis,
report assembly.

The analysis modules themselves are pure stdlib and the pass over the whole
package takes milliseconds; note that invoking through
``python -m agilerl_tpu_torch.analysis`` still executes the parent package
``__init__`` first (torch, a second or two of startup). The runtime half
lives in :mod:`.runtime` and is lazily imported by this package's
``__init__`` so the linter itself never adds to that.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .findings import Finding, assign_fingerprints
from .pragmas import parse_pragmas, suppressed
from .rules import ALL_RULES, RULES_BY_ID
from .rules.base import FileContext

_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", ".pytest_cache"}


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    errors: List[Tuple[str, str]] = field(default_factory=list)
    suppressed: int = 0  #: findings silenced by pragmas

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


def resolve_rules(select: Optional[Sequence[str]] = None,
                  disable: Optional[Sequence[str]] = None):
    """Per-rule enable/disable: ``select`` keeps only those ids, ``disable``
    drops ids from the (possibly selected) set. Unknown ids raise."""
    ids = [r.id for r in ALL_RULES]
    for given in list(select or []) + list(disable or []):
        if given.upper() not in RULES_BY_ID:
            raise ValueError(
                f"unknown rule id {given!r} (known: {', '.join(ids)})")
    active = [r for r in ALL_RULES
              if not select or r.id in {s.upper() for s in select}]
    if disable:
        drop = {d.upper() for d in disable}
        active = [r for r in active if r.id not in drop]
    return active


def package_root(path: Union[str, Path]) -> Path:
    """Scan root for ``path``: ascend through enclosing packages (dirs with
    ``__init__.py``) so a single-file scan of
    ``agilerl_tpu_torch/training/x.py`` still categorises as ``training/``. For a
    non-package dir (e.g. a fixture tree) the dir itself is the root."""
    p = Path(path).resolve()
    cur = p.parent if p.is_file() else p
    while (cur / "__init__.py").exists() and cur.parent != cur:
        cur = cur.parent
    return cur


def iter_python_files(path: Path) -> Iterable[Path]:
    if path.is_file():
        if path.suffix == ".py":
            yield path
        return
    for sub in sorted(path.rglob("*.py")):
        if not any(part in _SKIP_DIRS for part in sub.parts):
            yield sub


def analyze_file(path: Path, root: Path, rules) -> Tuple[List[Finding], int,
                                                         Optional[str]]:
    """Lint one file. Returns (findings, n_suppressed, parse_error)."""
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return [], 0, f"{type(e).__name__}: {e}"
    relpath = path.resolve().relative_to(root).as_posix()
    ctx = FileContext(relpath, source, tree)
    line_pragmas, file_pragmas = parse_pragmas(source)
    kept: List[Finding] = []
    n_suppressed = 0
    for rule in rules:
        for finding in rule.check(ctx):
            # the span covers the whole enclosing statement, so a pragma on
            # any physical line of a black-wrapped statement still applies
            span = finding.span if finding.span != (0, 0) else (
                finding.line, finding.line)
            if suppressed(finding.rule, span, line_pragmas, file_pragmas):
                n_suppressed += 1
            else:
                kept.append(finding)
    return kept, n_suppressed, None


def analyze(paths: Sequence[Union[str, Path]],
            select: Optional[Sequence[str]] = None,
            disable: Optional[Sequence[str]] = None) -> Report:
    """Lint every python file under ``paths`` with the active rule set."""
    rules = resolve_rules(select, disable)
    report = Report()
    for given in paths:
        p = Path(given).resolve()
        if not p.exists():
            report.errors.append((str(given), "path does not exist"))
            continue
        root = package_root(p)
        for f in iter_python_files(p):
            findings, n_sup, err = analyze_file(f, root, rules)
            report.files_scanned += 1
            report.suppressed += n_sup
            if err is not None:
                report.errors.append((str(f), err))
            report.findings.extend(findings)
    report.findings = assign_fingerprints(report.findings)
    return report


def default_target() -> Path:
    """The installed port package directory — what a bare
    ``python -m agilerl_tpu_torch.analysis`` scans."""
    return Path(__file__).resolve().parent.parent
