"""``python -m agilerl_tpu_torch.analysis`` — the port's graftcheck CLI (the
same flags and exit codes as ``python -m agilerl_tpu.analysis``).

Exit codes: 0 = clean (zero unbaselined findings), 1 = findings, 2 = usage
error. ``--write-baseline`` accepts the current findings as legacy and exits
0; CI then fails on any NEW finding while the committed baseline is burned
down over time.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from .baseline import (
    BASELINE_FILENAME,
    discover_baseline,
    load_baseline,
    split_baselined,
    write_baseline,
)
from .engine import analyze, default_target, resolve_rules
from .rules import ALL_RULES


def _build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m agilerl_tpu_torch.analysis",
        description="graftcheck — torch/CUDA-aware static analysis for "
                    "agilerl_tpu_torch (rules GX001-GX005)")
    parser.add_argument(
        "paths", nargs="*",
        help="files/directories to lint (default: the installed "
             "agilerl_tpu_torch package)")
    parser.add_argument(
        "--select", metavar="IDS",
        help="comma-separated rule ids to run (e.g. GX001,GX004)")
    parser.add_argument(
        "--disable", metavar="IDS",
        help="comma-separated rule ids to skip")
    parser.add_argument(
        "--format", choices=("human", "json"), default="human")
    parser.add_argument(
        "--baseline", metavar="PATH",
        help=f"baseline file (default: nearest {BASELINE_FILENAME} walking "
             f"up from the first scanned path)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore any baseline: report every finding")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="accept all current findings into the baseline file and exit 0")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="print the rule catalogue and exit")
    return parser


def _split_ids(spec: Optional[str]) -> Optional[List[str]]:
    if not spec:
        return None
    return [s.strip() for s in spec.split(",") if s.strip()]


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id}  {rule.name}\n       fix: {rule.hint}")
        return 0

    try:
        resolve_rules(_split_ids(args.select), _split_ids(args.disable))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.write_baseline and (args.select or args.disable):
        # a filtered scan sees only a subset of findings; writing it out
        # would erase every other rule's accepted entries from the ratchet
        print("error: --write-baseline requires a full-rule scan "
              "(drop --select/--disable)", file=sys.stderr)
        return 2

    paths = args.paths or [str(default_target())]
    report = analyze(paths, select=_split_ids(args.select),
                     disable=_split_ids(args.disable))
    for path, err in report.errors:
        print(f"error: {path}: {err}", file=sys.stderr)

    baseline_path: Optional[Path] = None
    if args.baseline:
        baseline_path = Path(args.baseline)
    elif not args.no_baseline:
        baseline_path = discover_baseline(paths[0])

    if args.write_baseline:
        target = baseline_path or Path(BASELINE_FILENAME)
        n = write_baseline(target, report.findings)
        print(f"graftcheck: wrote {n} baseline entries to {target}")
        return 0

    baseline = {}
    if baseline_path is not None and not args.no_baseline:
        try:
            baseline = load_baseline(baseline_path)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    new, accepted, stale = split_baselined(report.findings, baseline)

    if args.format == "json":
        print(json.dumps({
            "files_scanned": report.files_scanned,
            "suppressed": report.suppressed,
            "baseline": str(baseline_path) if baseline_path else None,
            "baselined": len(accepted),
            "stale_baseline_entries": stale,
            "findings": [f.to_dict() for f in new],
            "by_rule": _count_by_rule(new),
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        summary = (f"graftcheck: {report.files_scanned} files, "
                   f"{len(new)} finding(s)")
        if accepted:
            summary += f", {len(accepted)} baselined"
        if report.suppressed:
            summary += f", {report.suppressed} pragma-suppressed"
        if stale:
            summary += (f", {len(stale)} STALE baseline entr"
                        f"{'y' if len(stale) == 1 else 'ies'} "
                        f"(fixed or moved — prune with --write-baseline)")
        print(summary)

    if report.errors:
        return 2
    return 1 if new else 0


def _count_by_rule(findings) -> dict:
    out: dict = {}
    for f in findings:
        out[f.rule] = out.get(f.rule, 0) + 1
    return dict(sorted(out.items()))


if __name__ == "__main__":
    sys.exit(main())
