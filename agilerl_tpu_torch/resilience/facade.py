"""From ``agilerl_tpu/resilience/facade.py``: ``max_fitness``, the helper the
online flywheel's entry point feeds its best-fitness bookkeeping with. The
``Resilience`` facade (snapshots, preemption, retry) is not ported yet."""

from __future__ import annotations

from typing import Optional

import numpy as np


def max_fitness(fitnesses) -> Optional[float]:
    """Best fitness of an eval round (None when the round produced nothing
    finite). Accepts any sequence, including numpy arrays (whose truth value
    is ambiguous, so no ``if fitnesses`` here)."""
    arr = np.asarray(list(fitnesses), dtype=float)
    if arr.size == 0 or not np.isfinite(arr).any():
        return None
    return float(np.nanmax(arr[np.isfinite(arr)]))
