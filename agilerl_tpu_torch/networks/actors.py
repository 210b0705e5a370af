"""Actor networks: the port of ``agilerl_tpu/networks/actors.py``
(``DeterministicActor``: obs -> tanh -> the Box action range;
``StochasticActor``: the head's outputs parametrise the action space's
distribution, with the normal's ``log_std`` in ``params["dist"]``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from agilerl_tpu_torch.networks import distributions as D
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.utils.spaces import action_dim, space_kind


class DeterministicActor(EvolvableNetwork):
    """Deterministic policy for DDPG/TD3: obs -> tanh -> rescaled Box action."""

    def __init__(self, observation_space, action_space, **kwargs):
        assert space_kind(action_space) == "box", "DeterministicActor needs Box actions"
        self.action_space = action_space
        kwargs["head_config"] = {**kwargs.get("head_config", {}), "output_activation": "Tanh"}
        super().__init__(observation_space, num_outputs=action_dim(action_space), **kwargs)
        self.action_low = torch.as_tensor(action_space.low, dtype=torch.float32,
                                          device=self.device)
        self.action_high = torch.as_tensor(action_space.high, dtype=torch.float32,
                                           device=self.device)

    @staticmethod
    def rescale(action: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        """Map tanh output [-1, 1] onto [low, high]."""
        return low + (action + 1.0) * 0.5 * (high - low)

    def __call__(self, obs, **kw):
        raw = type(self).apply(self.config, self.params, obs, **kw)
        return self.rescale(raw, self.action_low, self.action_high)

    @property
    def init_dict(self):
        return {**super().init_dict, "action_space": self.action_space}


class StochasticActor(EvolvableNetwork):
    """Stochastic policy (PPO): the head outputs the parameters of the
    distribution that the action space implies."""

    def __init__(self, observation_space, action_space, **kwargs):
        self.action_space = action_space
        self.dist_config = D.dist_config_from_space(action_space)
        super().__init__(observation_space, num_outputs=D.head_output_dim(self.dist_config),
                         **kwargs)
        extra = D.extra_params(self.dist_config, self.device)
        if extra:
            self.params["dist"] = extra

    def logits(self, obs, **kw) -> torch.Tensor:
        return type(self).apply(self.config, self.params, obs, **kw)

    def __call__(self, obs, key: Optional[torch.Generator] = None,
                 action_mask: Optional[torch.Tensor] = None, deterministic: bool = False, **kw):
        """(action, log_prob, entropy): the mode when ``deterministic`` or
        without a generator, else a sample drawn from ``key``."""
        logits = self.logits(obs, **kw)
        dist_extra = self.params.get("dist")
        if deterministic or key is None:
            action = D.mode(self.dist_config, logits, mask=action_mask)
        else:
            action = D.sample(self.dist_config, logits, key, dist_extra, mask=action_mask)
        logp = D.log_prob(self.dist_config, logits, action, dist_extra, mask=action_mask)
        ent = D.entropy(self.dist_config, logits, dist_extra, mask=action_mask)
        return action, logp, ent

    def evaluate_actions(self, obs, actions, action_mask=None, **kw):
        logits = self.logits(obs, **kw)
        dist_extra = self.params.get("dist")
        logp = D.log_prob(self.dist_config, logits, actions, dist_extra, mask=action_mask)
        ent = D.entropy(self.dist_config, logits, dist_extra, mask=action_mask)
        return logp, ent

    def extra_template(self) -> Dict:
        """The parameter groups outside ``init_params`` (for ``params_from_numpy``)."""
        extra = D.extra_params(self.dist_config)
        return {"dist": extra} if extra else {}

    @property
    def init_dict(self):
        return {**super().init_dict, "action_space": self.action_space}
