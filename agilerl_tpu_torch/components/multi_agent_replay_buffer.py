"""The multi-agent replay buffer: the port of
``agilerl_tpu/components/multi_agent_replay_buffer.py``.

One device ring (``components/replay_buffer.ReplayBuffer``) whose
transition is a dict of agents, ``{"obs": {agent: ...}, "action": {agent:
...}, "reward": ..., "next_obs": ..., "done": ...}``: agents are branches of
the tree, so ``save_to_memory`` and ``stage_to_memory`` go through ``add``
and ``stage`` unchanged, and ``sample`` returns the same dict of ``[B,
...]`` rows.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
from agilerl_tpu_torch.ops import DeviceLike


class MultiAgentReplayBuffer(ReplayBuffer):
    """``device=None`` means the card (raising without one)."""

    def __init__(self, max_size: int, agent_ids: List[str], device: DeviceLike = None,
                 seed: Optional[int] = None, flush_every: Optional[int] = None):
        super().__init__(max_size, device=device, seed=seed, flush_every=flush_every)
        self.agent_ids = list(agent_ids)

    def _transition(self, obs, action, reward, next_obs, done) -> Dict[str, Any]:
        return {
            "obs": {a: obs[a] for a in self.agent_ids},
            "action": {a: action[a] for a in self.agent_ids},
            "reward": {a: reward[a] for a in self.agent_ids},
            "next_obs": {a: next_obs[a] for a in self.agent_ids},
            "done": {a: done[a] for a in self.agent_ids},
        }

    def save_to_memory(self, obs: Dict[str, Any], action: Dict[str, Any],
                       reward: Dict[str, Any], next_obs: Dict[str, Any], done: Dict[str, Any],
                       is_vectorised: bool = False) -> None:
        """Write one transition (``[N, ...]`` rows per agent when
        ``is_vectorised``)."""
        self.add(self._transition(obs, action, reward, next_obs, done), batched=is_vectorised)

    def stage_to_memory(self, obs: Dict[str, Any], action: Dict[str, Any],
                        reward: Dict[str, Any], next_obs: Dict[str, Any], done: Dict[str, Any],
                        is_vectorised: bool = False) -> None:
        """Queue one transition; written ``flush_every`` transitions at a
        time (the training loop flushes before every sample)."""
        self.stage(self._transition(obs, action, reward, next_obs, done), batched=is_vectorised)
