"""Q-networks: the port of ``agilerl_tpu/networks/q_networks.py``
(``QNetwork``, ``RainbowQNetwork``, ``ContinuousQNetwork``).

``RainbowQNetwork`` is a dueling C51 net: an advantage stream (the head,
latent -> actions x atoms) and a value stream (``params["value"]``, latent
-> atoms), both noisy, layer-normed MLPs over one encoder; ``apply_dist``
gives the atoms' log-probabilities and ``apply`` their expected value on
``support``. A generator passed as ``key`` draws the noisy layers' noise;
without one the mean weights apply.

One deviation from the JAX package: an architecture mutation of the head
also morphs the value stream (its hidden sizes follow the head's, the
overlapping slabs preserved). The JAX package leaves the value stream at
its old widths, which its apply tolerates for node mutations but not for
a head layer mutation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.modules.base import config_replace, preserve_params
from agilerl_tpu_torch.modules.mlp import EvolvableMLP
from agilerl_tpu_torch.networks.base import ENCODER_TYPES, EvolvableNetwork, NetworkConfig
from agilerl_tpu_torch.utils.spaces import action_dim, space_kind


class QNetwork(EvolvableNetwork):
    """Discrete-action state-action values: Q(s) -> [num_actions]."""

    def __init__(self, observation_space, action_space, **kwargs):
        assert space_kind(action_space) in ("discrete", "multidiscrete"), (
            "QNetwork requires a discrete action space")
        self.action_space = action_space
        super().__init__(observation_space, num_outputs=action_dim(action_space), **kwargs)

    @property
    def init_dict(self):
        return dict(super().init_dict, action_space=self.action_space)


class ContinuousQNetwork(EvolvableNetwork):
    """Q(s, a): obs -> encoder -> latent (+) action -> head -> scalar. The
    action joins at the latent, so image encoders stay reusable."""

    def __init__(self, observation_space, action_space, **kwargs):
        self.action_space = action_space
        self.action_dim = action_dim(action_space)
        kwargs.setdefault("head_config", {})
        super().__init__(observation_space, num_outputs=1, **kwargs)
        # the head takes latent (+) action
        if self.config.head.num_inputs != self.config.latent_dim + self.action_dim:
            head = config_replace(self.config.head,
                                  num_inputs=self.config.latent_dim + self.action_dim)
            new_cfg = config_replace(self.config, head=head)
            self.params = preserve_params(self.params,
                                          self.init_params(self._next_key(), new_cfg))
            self.config = new_cfg

    @staticmethod
    def apply(config, params: Dict, obs: Any, action: torch.Tensor = None, **kw) -> torch.Tensor:
        latent = EvolvableNetwork.encode(config, params, obs, **kw)
        h = torch.cat([latent, action.float()], dim=-1)
        return EvolvableMLP.apply(config.head, params["head"], h)[..., 0]

    def __call__(self, obs, action, **kw):
        return type(self).apply(self.config, self.params, obs, action=action, **kw)

    @property
    def _head_extra_inputs(self) -> int:
        return self.action_dim

    @property
    def init_dict(self):
        return dict(super().init_dict, action_space=self.action_space)


@dataclasses.dataclass(frozen=True)
class RainbowConfig(NetworkConfig):
    num_atoms: int = 51
    num_actions: int = 2
    v_min: float = -100.0
    v_max: float = 100.0


def _value_config(config: RainbowConfig):
    return config_replace(config.head, num_outputs=config.num_atoms)


def noise_count(config: RainbowConfig) -> int:
    """Standard normals one noisy apply of a ``RainbowQNetwork`` takes from
    a ``modules.layers.NoiseStream``: ``in + out`` per noisy layer of the
    advantage and value streams."""
    total = 0
    for mlp in (config.head, _value_config(config)):
        sizes = (mlp.num_inputs,) + tuple(mlp.hidden_size) + (mlp.num_outputs,)
        total += sum(a + b for a, b in zip(sizes[:-1], sizes[1:]))
    return total


def support(config: RainbowConfig, device=None) -> torch.Tensor:
    """The atoms' values: ``linspace(v_min, v_max, num_atoms)`` in f32."""
    return torch.linspace(config.v_min, config.v_max, config.num_atoms, dtype=torch.float32,
                          device=device)


class RainbowQNetwork(EvolvableNetwork):
    """Dueling C51 Q-net with noisy streams. ``__call__`` gives expected
    Q-values, ``q_values=False`` the atoms' log-probabilities."""

    def __init__(self, observation_space, action_space, num_atoms: int = 51,
                 v_min: float = -100.0, v_max: float = 100.0, noise_std: float = 0.5,
                 config: Optional[RainbowConfig] = None, **kwargs):
        assert space_kind(action_space) == "discrete", "RainbowQNetwork needs a Discrete space"
        self.action_space = action_space
        num_actions = int(action_space.n)
        if config is None:
            kwargs["head_config"] = {**dict(kwargs.get("head_config") or {}), "noisy": True,
                                     "noise_std": noise_std, "layer_norm": True,
                                     "output_vanish": False}
            super().__init__(observation_space, num_outputs=num_actions * num_atoms, **kwargs)
            # lift the plain config, then initialise against it (value stream included)
            base = {f.name: getattr(self.config, f.name)
                    for f in dataclasses.fields(NetworkConfig)}
            self.config = RainbowConfig(**base, num_atoms=num_atoms, num_actions=num_actions,
                                        v_min=v_min, v_max=v_max)
            self.params = self.init_params(self._next_key(), self.config)
        else:
            super().__init__(observation_space, num_outputs=num_actions * num_atoms,
                             config=config, **kwargs)

    @staticmethod
    def init_params(gen: torch.Generator, config: RainbowConfig) -> Dict:
        if not isinstance(config, RainbowConfig):  # the plain config, before it is lifted
            return EvolvableNetwork.init_params(gen, config)
        return {
            "encoder": ENCODER_TYPES[config.encoder_kind].init_params(gen, config.encoder),
            "head": EvolvableMLP.init_params(gen, config.head),
            "value": EvolvableMLP.init_params(gen, _value_config(config)),
        }

    @staticmethod
    def apply_dist(config: RainbowConfig, params: Dict, obs: Any,
                   key: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        """The atoms' log-probabilities ``[..., actions, atoms]``."""
        latent = EvolvableNetwork.encode(config, params, obs, **kw)
        adv = EvolvableMLP.apply(config.head, params["head"], latent, key=key)
        val = EvolvableMLP.apply(_value_config(config), params["value"], latent, key=key)
        adv = adv.reshape(*adv.shape[:-1], config.num_actions, config.num_atoms)
        val = val.reshape(*val.shape[:-1], 1, config.num_atoms)
        q_atoms = val + adv - adv.mean(dim=-2, keepdim=True)
        return torch.log_softmax(q_atoms, dim=-1)

    @staticmethod
    def apply(config: RainbowConfig, params: Dict, obs: Any,
              key: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        logp = RainbowQNetwork.apply_dist(config, params, obs, key=key, **kw)
        return torch.sum(torch.exp(logp) * support(config, logp.device), dim=-1)

    def support(self) -> torch.Tensor:
        return support(self.config, self.device)

    def __call__(self, obs, key: Optional[torch.Generator] = None, q_values: bool = True, **kw):
        if q_values:
            return self.apply(self.config, self.params, obs, key=key, **kw)
        return self.apply_dist(self.config, self.params, obs, key=key, **kw)

    def apply_mutation(self, name: str, rng: Optional[np.random.Generator] = None) -> Dict:
        info = super().apply_mutation(name, rng=rng)
        if name.startswith("head."):
            # the value stream follows the head's new hidden sizes
            fresh = EvolvableMLP.init_params(self._next_key(), _value_config(self.config))
            self.params["value"] = preserve_params(self.params["value"], fresh)
        return info

    @property
    def init_dict(self):
        return dict(super().init_dict, action_space=self.action_space)
