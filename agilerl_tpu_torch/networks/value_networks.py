"""State-value network V(s): the port of ``agilerl_tpu/networks/value_networks.py``."""

from __future__ import annotations

import torch

from agilerl_tpu_torch.networks.base import EvolvableNetwork


class ValueNetwork(EvolvableNetwork):
    """obs -> scalar value (the PPO critic)."""

    def __init__(self, observation_space, **kwargs):
        super().__init__(observation_space, num_outputs=1, **kwargs)

    def __call__(self, obs, **kw) -> torch.Tensor:
        return type(self).apply(self.config, self.params, obs, **kw)[..., 0]
