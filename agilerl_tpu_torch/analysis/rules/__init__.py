"""graftcheck rule registry — one module per hazard class."""

from __future__ import annotations

from typing import Dict, List

from .base import FileContext, Rule
from .gx001_host_sync import HostSyncInHotLoop
from .gx002_recompile import RecompileHazard
from .gx003_global_rng import GlobalRngDraw
from .gx004_durability import NonAtomicDurabilityWrite
from .gx005_retry_collectives import RetryWrappedCollective

ALL_RULES: List[Rule] = [
    HostSyncInHotLoop(),
    RecompileHazard(),
    GlobalRngDraw(),
    NonAtomicDurabilityWrite(),
    RetryWrappedCollective(),
]

RULES_BY_ID: Dict[str, Rule] = {r.id: r for r in ALL_RULES}

__all__ = [
    "ALL_RULES", "RULES_BY_ID", "FileContext", "Rule",
    "HostSyncInHotLoop", "RecompileHazard", "GlobalRngDraw",
    "NonAtomicDurabilityWrite", "RetryWrappedCollective",
]
