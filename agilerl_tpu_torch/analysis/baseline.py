"""Baseline file — accepted legacy findings, committed next to the repo.

The port's baseline (``analysis_baseline_torch.json``) is the ratchet:
every finding in it is grandfathered; any finding NOT in it fails CI. Entries key on the finding
fingerprint (path + rule + source-line text + occurrence index, see
:mod:`.findings`), so line-number drift from unrelated edits never churns the
file, while editing a baselined line invalidates its entry and forces a
re-decision. ``--write-baseline`` regenerates the file; stale entries (in the
baseline but no longer found) are reported so the ratchet only tightens.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

from .findings import Finding

#: the port's own name: discovery walks up from the scanned path, and a
#: scan of ``agilerl_tpu_torch/`` must never pick up the JAX package's
#: ``analysis_baseline.json`` beside it at the repository root
BASELINE_FILENAME = "analysis_baseline_torch.json"
_VERSION = 1


def load_baseline(path: Union[str, Path]) -> Dict[str, dict]:
    """Return fingerprint -> entry. Missing file == empty baseline."""
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    if data.get("version") != _VERSION:
        raise ValueError(
            f"unsupported baseline version {data.get('version')!r} in {p} "
            f"(this graftcheck reads version {_VERSION})")
    return {e["fingerprint"]: e for e in data.get("findings", [])}


def write_baseline(path: Union[str, Path], findings: Iterable[Finding]) -> int:
    """Write all ``findings`` as the new baseline; returns the entry count.
    Entries are sorted by (path, rule, line) so regeneration diffs cleanly."""
    entries = [
        {
            "fingerprint": f.fingerprint,
            "rule": f.rule,
            "path": f.path,
            "line": f.line,
            "text": f.text,
        }
        for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line))
    ]
    payload = {
        "version": _VERSION,
        "tool": "graftcheck",
        "findings": entries,
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
    return len(entries)


def split_baselined(
    findings: Iterable[Finding], baseline: Dict[str, dict]
) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """Partition into (new, accepted, stale_entries): ``new`` fail the run,
    ``accepted`` matched the baseline, ``stale_entries`` are baseline rows no
    current finding matched (candidates for deletion)."""
    new: List[Finding] = []
    accepted: List[Finding] = []
    matched = set()
    for f in findings:
        if f.fingerprint in baseline:
            accepted.append(f)
            matched.add(f.fingerprint)
        else:
            new.append(f)
    stale = [e for fp, e in sorted(baseline.items()) if fp not in matched]
    return new, accepted, stale


def discover_baseline(start: Union[str, Path]) -> Optional[Path]:
    """Walk upward from ``start`` looking for :data:`BASELINE_FILENAME` —
    how the CLI finds the committed baseline regardless of cwd."""
    p = Path(start).resolve()
    if p.is_file():
        p = p.parent
    for candidate in [p, *p.parents]:
        f = candidate / BASELINE_FILENAME
        if f.exists():
            return f
    return None
