"""Transition container and replay dataset: the port of
``agilerl_tpu/components/data.py``. Each process of a data-parallel run
folds its rank into the dataset's seed, so the ranks draw different batches
without a DataLoader."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.modules.base import split_key
from agilerl_tpu_torch.utils.rng import derive_key


@dataclasses.dataclass
class Transition:
    obs: Any
    action: Any
    reward: Any
    next_obs: Any
    done: Any

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Transition":
        return Transition(**{k: d[k] for k in ("obs", "action", "reward", "next_obs", "done")})


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class ReplayDataset:
    """An endless iterator of ``buffer.sample(batch_size)``, each drawn from
    a generator on the buffer's device split off this dataset's own (seeded
    with ``seed`` plus the process's rank)."""

    def __init__(self, buffer, batch_size: int, seed: Optional[int] = None):
        self.buffer = buffer
        self.batch_size = batch_size
        self.key = derive_key(seed=(seed or 0) * 1_000_003 + _process_index())

    def __iter__(self):
        while True:
            yield self.buffer.sample(self.batch_size,
                                     key=split_key(self.key, self.buffer.device))
