"""Metric log combination: the port of ``agilerl_tpu/utils/log_utils.py``.

Host-side accumulation of (value, weight) pairs per metric, reduced to
weighted means. The cross-host reduce is the single-process identity until
the distribution slice (``torch.distributed`` gathers).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class CombineLogs:
    """Accumulate (value, weight) pairs per metric and reduce to weighted means."""

    def __init__(self):
        self._logs: Dict[str, List] = {}

    def accum(self, metrics: Dict[str, float], weight: float = 1.0) -> None:
        for k, v in metrics.items():
            self._logs.setdefault(k, []).append((float(v), float(weight)))

    def reduce(self, across_hosts: bool = False) -> Dict[str, float]:
        """Weighted mean per metric. ``across_hosts`` reduces over this
        process only: the port runs one process per run until the
        distribution slice."""
        out = {}
        for k, pairs in self._logs.items():
            vals = np.array([p[0] for p in pairs])
            wts = np.array([p[1] for p in pairs])
            num, den = float((vals * wts).sum()), float(wts.sum())
            out[k] = num / max(den, 1e-12)
        return out

    def clear(self) -> None:
        self._logs = {}


DistributeCombineLogs = CombineLogs  # the reference's alias
