"""Array-backed segment trees: the port's own copy of
``agilerl_tpu/components/segment_tree.py`` (numpy only, as there).

The PER buffer itself samples from a dense cumulative sum on the device
(``components/replay_buffer.py``); these trees are kept for API parity and
for host-side consumers: a flat numpy heap (``tree[1]`` is the root),
vectorised batch updates and an O(log N) prefix-sum descent.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


class SegmentTree:
    def __init__(self, capacity: int, operation: Callable, init_value: float):
        assert capacity > 0 and (capacity & (capacity - 1)) == 0, (
            "capacity must be a positive power of 2")
        self.capacity = capacity
        self.operation = operation
        self.init_value = init_value
        self.tree = np.full(2 * capacity, init_value, dtype=np.float64)

    def __setitem__(self, idx, val) -> None:
        idx = np.atleast_1d(np.asarray(idx, dtype=np.int64)) + self.capacity
        val = np.broadcast_to(np.asarray(val, dtype=np.float64), idx.shape)
        self.tree[idx] = val
        # vectorised upward propagation, level by level
        parents = np.unique(idx // 2)
        while parents.size and parents[0] >= 1:
            self.tree[parents] = self.operation(self.tree[2 * parents],
                                                self.tree[2 * parents + 1])
            parents = np.unique(parents // 2)
            if parents.size and parents[-1] == 0:
                parents = parents[parents >= 1]

    def __getitem__(self, idx):
        return self.tree[np.asarray(idx) + self.capacity]

    def reduce(self, start: int = 0, end: int = None) -> float:
        """Aggregate over [start, end)."""
        if end is None:
            end = self.capacity
        result = self.init_value
        start += self.capacity
        end += self.capacity
        while start < end:
            if start & 1:
                result = self.operation(result, self.tree[start])
                start += 1
            if end & 1:
                end -= 1
                result = self.operation(result, self.tree[end])
            start //= 2
            end //= 2
        return float(result)


class SumSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.add, 0.0)

    def sum(self, start: int = 0, end: int = None) -> float:
        return self.reduce(start, end)

    def retrieve(self, upperbound: float) -> int:
        """The highest i such that prefix_sum(i) <= upperbound."""
        idx = 1
        while idx < self.capacity:
            left = 2 * idx
            if self.tree[left] > upperbound:
                idx = left
            else:
                upperbound -= self.tree[left]
                idx = left + 1
        return idx - self.capacity


class MinSegmentTree(SegmentTree):
    def __init__(self, capacity: int):
        super().__init__(capacity, np.minimum, float("inf"))

    def min(self, start: int = 0, end: int = None) -> float:
        return self.reduce(start, end)
