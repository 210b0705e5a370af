"""graftcheck for the port — torch/CUDA-aware static analysis + runtime
compile/sync guards; the counterpart of ``agilerl_tpu/analysis/``.

Static half (the analysis pass itself is stdlib-only and runs in
milliseconds; the CLI pays one parent-package import at startup)::

    python -m agilerl_tpu_torch.analysis               # lint the port
    python -m agilerl_tpu_torch.analysis --list-rules  # rule catalogue

Rules (the JAX ids and names, mapped to torch hazards): GX001 host sync in
a hot loop (``.item()``, ``.cpu()``, a branch on ``.any()``, data-dependent
shapes, ...), GX002 recompile hazards (``torch.compile`` / CUDA graph
capture in a loop), GX003 global-RNG draws (numpy, stdlib and torch's
global stream), GX004 non-atomic durability writes (``torch.save`` to a
path included), GX005 retry-wrapped collectives. Per-line
``# graftcheck: disable=GXnnn`` pragmas (the JAX spelling, so a pragma
copied from a JAX file works unchanged) and a committed baseline
(``analysis_baseline_torch.json``) gate CI on NEW findings only.

Runtime half (imported lazily — pulls in torch and the serving tier)::

    with CompileGuard(gen):              # zero new programs, or raise
        for batch in stream: gen.generate(batch, ...)
    with CompileGuard():                 # zero nvcc builds, or raise
        _build.build_all(names)
    with SyncGuard(max_syncs=0) as sg:   # count blocking device->host syncs
        agent.learn_from_buffer(memory)
"""

from __future__ import annotations

from .baseline import (
    BASELINE_FILENAME,
    discover_baseline,
    load_baseline,
    split_baselined,
    write_baseline,
)
from .engine import Report, analyze, analyze_file, default_target, resolve_rules
from .findings import Finding, assign_fingerprints
from .rules import ALL_RULES, RULES_BY_ID

__all__ = [
    "ALL_RULES", "RULES_BY_ID", "Finding", "Report",
    "analyze", "analyze_file", "assign_fingerprints", "default_target",
    "resolve_rules",
    "BASELINE_FILENAME", "discover_baseline", "load_baseline",
    "split_baselined", "write_baseline",
    # lazy (torch-importing) runtime guards:
    "CompileGuard", "CompileGuardError", "SyncGuard", "SyncGuardError",
]

_RUNTIME_NAMES = {"CompileGuard", "CompileGuardError",
                  "SyncGuard", "SyncGuardError"}


def __getattr__(name):
    """Lazy-load the runtime guards so the analysis modules themselves never
    import torch (the parent package does on ``python -m``, but in-process
    consumers of the linter API — tests, tooling — stay stdlib-fast)."""
    if name in _RUNTIME_NAMES:
        from . import runtime

        return getattr(runtime, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
