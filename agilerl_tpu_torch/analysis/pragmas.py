"""``# graftcheck: disable=GXnnn`` pragma parsing.

Two scopes:

- **line pragma** — ``# graftcheck: disable=GX001`` (or ``disable=GX001,GX004``
  or ``disable=all``) on any physical line of the flagged statement suppresses
  those rules for that statement.
- **file pragma** — ``# graftcheck: disable-file=GX003`` anywhere in the file
  suppresses the rule for the whole file (use sparingly; prefer line pragmas
  next to the justification comment).

Pragmas are matched per physical line with a regex rather than the tokenizer:
a pragma-shaped string inside a string literal would also count, which is the
same tradeoff ``# noqa`` makes and keeps parsing trivially robust on files the
AST cannot parse.
"""

from __future__ import annotations

import re
from typing import Dict, Set, Tuple

_PRAGMA_RE = re.compile(
    r"#\s*graftcheck:\s*disable(?P<scope>-file)?\s*=\s*"
    r"(?P<ids>all|[A-Za-z0-9]+(?:\s*,\s*[A-Za-z0-9]+)*)"
)

ALL = "all"


def parse_pragmas(source: str) -> Tuple[Dict[int, Set[str]], Set[str]]:
    """Return ``(line_pragmas, file_pragmas)``: a map of 1-based line number to
    the set of disabled rule ids on that line (``{"all"}`` for disable=all),
    and the set of file-wide disabled ids."""
    line_pragmas: Dict[int, Set[str]] = {}
    file_pragmas: Set[str] = set()
    for lineno, line in enumerate(source.splitlines(), start=1):
        if "graftcheck" not in line:
            continue
        m = _PRAGMA_RE.search(line)
        if not m:
            continue
        ids = {ALL if s.strip().lower() == ALL else s.strip().upper()
               for s in m.group("ids").split(",")}
        if m.group("scope"):
            file_pragmas |= ids
        else:
            line_pragmas.setdefault(lineno, set()).update(ids)
    return line_pragmas, file_pragmas


def suppressed(rule: str, span: Tuple[int, int],
               line_pragmas: Dict[int, Set[str]],
               file_pragmas: Set[str]) -> bool:
    """True when ``rule`` is disabled for a statement spanning physical lines
    ``span = (first, last)`` (inclusive) — a pragma on any line of a multi-line
    statement counts, so black-formatted call chains stay suppressible."""
    if ALL in file_pragmas or rule in file_pragmas:
        return True
    first, last = span
    for ln in range(first, last + 1):
        ids = line_pragmas.get(ln)
        if ids and (ALL in ids or rule in ids):
            return True
    return False
