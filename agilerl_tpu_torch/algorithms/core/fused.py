"""Sample + learn + priority write-back as one call: the port of
``agilerl_tpu/algorithms/core/fused.py``.

Each off-policy algorithm's ``learn_from_buffer`` is built from these
helpers and its own train core, and makes no host sync: the ring cursors
are host integers, the draws are made on the device, and the loss comes
back as a device tensor. The random draws (uniform indices, PER's uniforms
in [0, 1)) are made first, from the agent's generator; the helpers take
them as arguments, so a caller can feed in another stream's draws (the
tests feed the JAX package's). PER writes its priorities back in place, in
the same call.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from agilerl_tpu_torch.components.replay_buffer import (
    BufferState,
    PERState,
    PrioritizedReplayBuffer,
    _gather,
    _per_sample,
    _per_update,
    drain_staging,
)
from agilerl_tpu_torch.utils.spaces import preprocess_observation

PyTree = Any


def preprocess_batch(batch: dict, obs_space, device=None) -> dict:
    """obs / next_obs as the networks take them."""
    batch = dict(batch)
    batch["obs"] = preprocess_observation(obs_space, batch["obs"], device)
    batch["next_obs"] = preprocess_observation(obs_space, batch["next_obs"], device)
    return batch


def uniform_sample(state: BufferState,
                   idx: torch.Tensor) -> Tuple[PyTree, torch.Tensor, torch.Tensor]:
    """``(batch, idx, weights of ones)`` at drawn ring indices ``idx``, so a
    paired n-step batch can be gathered at the same positions."""
    return _gather(state, idx), idx, torch.ones(idx.shape[0], dtype=torch.float32,
                                                device=idx.device)


# the JAX package's names for the buffer's own functions: PER's inverse-CDF
# sample at uniform draws, its priority write-back in the learn call, and the
# index-aligned gather from the paired n-step ring
per_sample = _per_sample
per_write_back = _per_update
gather_paired = _gather


def resolve_states(memory, n_step_memory=None) -> Tuple[Any, Optional[BufferState], bool]:
    """The host prologue of ``learn_from_buffer``: drain the staging (the
    n-step fold's displaced raw rows go to the main buffer first, so the
    paired rings stay index-aligned) and return ``(sample_state,
    n_step_state | None, per)``; ``sample_state`` is a ``PERState`` when
    ``per``, else a ``BufferState``."""
    drain_staging(memory, n_step_memory)
    per = isinstance(memory, PrioritizedReplayBuffer)
    state = memory.per_state if per else memory.state
    nstate = getattr(n_step_memory, "state", None) if n_step_memory is not None else None
    return state, nstate, per


def draw_sample(state: Any, per: bool, gen: torch.Generator, batch_size: int) -> torch.Tensor:
    """The draws of one sample, made first: PER's uniforms in [0, 1), or
    uniform ring indices."""
    if per:
        return torch.rand(batch_size, generator=gen, device=gen.device)
    return torch.randint(0, max(state.size, 1), (batch_size,), generator=gen,
                         device=gen.device)
