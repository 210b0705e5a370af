"""Finding record + stable fingerprinting for graftcheck.

A finding's **fingerprint** is what the baseline keys on, and it must survive
unrelated edits: it hashes the repo-relative path, the rule id, the stripped
source text of the flagged line, and the occurrence index among identical
(path, rule, text) triples — never the line number. Adding code above a
baselined finding therefore does not invalidate it; editing the flagged line
itself does (which is exactly when a human should re-look).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List


@dataclass
class Finding:
    rule: str           #: rule id, e.g. "GX001"
    path: str           #: repo-relative posix path of the offending file
    line: int           #: 1-based line of the offending node
    col: int            #: 0-based column of the offending node
    message: str        #: what is wrong, with the offending expression named
    hint: str           #: one-line fix hint (the rule's canonical remedy)
    text: str = ""      #: stripped source text of the flagged line
    fingerprint: str = field(default="", compare=False)
    #: physical (first, last) line of the enclosing statement — the range a
    #: line pragma may appear on; not serialized
    span: tuple = field(default=(0, 0), compare=False)

    def key(self) -> tuple:
        return (self.path, self.line, self.col, self.rule)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "hint": self.hint,
            "text": self.text,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: {self.rule} "
                f"{self.message} [fix: {self.hint}]")


def _digest(path: str, rule: str, text: str, index: int) -> str:
    blob = f"{path}::{rule}::{text}::{index}".encode("utf-8")
    return hashlib.sha256(blob).hexdigest()[:16]


def assign_fingerprints(findings: Iterable[Finding]) -> List[Finding]:
    """Assign occurrence-indexed fingerprints, stably: findings are ordered by
    (path, line, col) first so the Nth identical line in a file keeps the same
    index across runs regardless of rule-visit order."""
    ordered = sorted(findings, key=Finding.key)
    seen: Dict[tuple, int] = {}
    for f in ordered:
        k = (f.path, f.rule, f.text)
        idx = seen.get(k, 0)
        seen[k] = idx + 1
        f.fingerprint = _digest(f.path, f.rule, f.text, idx)
    return ordered
