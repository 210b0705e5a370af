"""CQN: the port of ``agilerl_tpu/algorithms/cqn.py``, conservative
Q-learning for offline RL on discrete actions: DQN's TD backup plus
``cql_alpha * mean(logsumexp(Q(s, .)) - Q(s, a))``, which pushes down the
values of actions absent from the data.

One deviation from the JAX package: ``learn_from_buffer`` runs the
conservative loss too (the JAX package's fused path runs DQN's TD core,
without the penalty; its ``learn`` has it).
"""

from __future__ import annotations

from typing import Dict

import torch

from agilerl_tpu_torch.algorithms.dqn import DQN


class CQN(DQN):
    def __init__(self, observation_space, action_space, cql_alpha: float = 1.0, **kwargs):
        self.cql_alpha = float(cql_alpha)
        super().__init__(observation_space, action_space, **kwargs)

    @property
    def init_dict(self) -> Dict:
        return dict(super().init_dict, cql_alpha=self.cql_alpha)

    def _loss(self, q: torch.Tensor, q_sel: torch.Tensor, td: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
        cql = torch.mean(torch.logsumexp(q, dim=-1) - q_sel)
        return super()._loss(q, q_sel, td, weights) + self.cql_alpha * cql
