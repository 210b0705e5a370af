"""Sampler: the port of ``agilerl_tpu/components/sampler.py``, the uniform /
PER / paired n-step dispatch over the replay buffers."""

from __future__ import annotations

from typing import Optional

import torch

from agilerl_tpu_torch.components.replay_buffer import (
    MultiStepReplayBuffer,
    PrioritizedReplayBuffer,
    draw_indices,
    drain_staging,
)
from agilerl_tpu_torch.utils.spaces import as_tensor


class Sampler:
    """Dispatches sampling by buffer type.

    - ``dataset``: the next item of an epoch iterator;
    - a PER memory: ``(batch, idxs, weights)``, plus the paired n-step batch
      at the SAME indices when ``n_step_memory`` is given;
    - a plain memory: a uniform sample; ``idxs`` forces an index-aligned
      gather; with ``n_step_memory`` the shared indices come from the
      memory's own generator (or ``key``) and the weights are ones.
    """

    def __init__(self, memory=None, dataset=None, per: bool = False, n_step: bool = False,
                 n_step_memory=None):
        self.memory = memory
        self.dataset = dataset
        self.n_step_memory = n_step_memory
        self.per = per or isinstance(memory, PrioritizedReplayBuffer)
        self.n_step = (n_step or n_step_memory is not None
                       or isinstance(memory, MultiStepReplayBuffer))
        self._iter = iter(dataset) if dataset is not None else None

    def flush(self) -> None:
        """Drain staged rows into the rings before sampling (the paired-ring
        contract of ``replay_buffer.drain_staging``)."""
        drain_staging(self.memory, self.n_step_memory)

    def sample(self, batch_size: int, beta: Optional[float] = None, idxs=None,
               key: Optional[torch.Generator] = None, draws: Optional[torch.Tensor] = None):
        """``draws`` stand in for the memory's own: PER's uniforms, or the
        uniform indices."""
        if self._iter is not None:
            return next(self._iter)
        self.flush()
        if self.per:
            batch, idx, weights = self.memory.sample(
                batch_size, beta=beta if beta is not None else 0.4, key=key, draws=draws)
            if self.n_step_memory is not None:
                return batch, idx, weights, self.n_step_memory.sample_from_indices(idx)
            return batch, idx, weights
        if idxs is not None:
            return self.memory.sample_from_indices(idxs)
        if self.n_step_memory is not None:
            if draws is None:
                key = key if key is not None else self.memory._draw_key()
                draws = draw_indices(key, batch_size, len(self.memory))
            idx = as_tensor(draws, self.memory.device).long()
            weights = torch.ones(batch_size, dtype=torch.float32, device=idx.device)
            return (self.memory.sample_from_indices(idx), idx, weights,
                    self.n_step_memory.sample_from_indices(idx))
        return self.memory.sample(batch_size, key=key, draws=draws)
