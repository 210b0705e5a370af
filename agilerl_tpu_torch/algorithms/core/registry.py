"""Mutation registry: the port of ``agilerl_tpu/algorithms/core/registry.py``
(network groups, optimizer configs, hyperparameter mutation spaces). Pure
Python and numpy: the draws are the JAX package's, draw for draw."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_rng


@dataclasses.dataclass
class NetworkGroup:
    """One evolvable network role in an algorithm: an eval net plus any nets
    that must share its architecture (targets, twin critics)."""

    eval: str  # attribute name of the evaluated/trained network
    shared: Union[str, List[str], None] = None  # attrs rebuilt from eval after mutation
    policy: bool = False  # is this the acting policy?
    multiagent: bool = False

    def shared_names(self) -> List[str]:
        if self.shared is None:
            return []
        return [self.shared] if isinstance(self.shared, str) else list(self.shared)


@dataclasses.dataclass
class OptimizerConfig:
    """Metadata binding an optimizer attribute to its networks + lr HP."""

    name: str  # attribute name of the OptimizerWrapper
    networks: List[str]  # attribute names of the nets it optimises
    lr: str = "lr"  # attribute name of the learning-rate HP
    optimizer: str = "adam"
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RLParameter:
    """Mutation space for one scalar hyperparameter."""

    min: float
    max: float
    shrink_factor: float = 0.8
    grow_factor: float = 1.2
    dtype: type = float

    def mutate(self, value, rng: Optional[np.random.Generator] = None):
        """Randomly grow or shrink within [min, max]."""
        rng = derive_rng(rng)
        factor = self.grow_factor if rng.random() < 0.5 else self.shrink_factor
        new = float(np.clip(value * factor, self.min, self.max))
        if self.dtype is int:
            new = int(np.clip(int(round(new)), int(self.min), int(self.max)))
        return self.dtype(new)


@dataclasses.dataclass
class HyperparameterConfig:
    """Named collection of RLParameters."""

    params: Dict[str, RLParameter] = dataclasses.field(default_factory=dict)

    def __init__(self, **kwargs: RLParameter):
        self.params = dict(kwargs)

    def names(self) -> List[str]:
        return list(self.params.keys())

    def sample(self, rng: Optional[np.random.Generator] = None) -> Optional[str]:
        rng = derive_rng(rng)
        if not self.params:
            return None
        return str(rng.choice(self.names()))

    def __getitem__(self, k: str) -> RLParameter:
        return self.params[k]

    def __contains__(self, k: str) -> bool:
        return k in self.params

    def __bool__(self) -> bool:
        return bool(self.params)


class MutationRegistry:
    """Per-agent registry of network groups, optimizers and hooks."""

    def __init__(self, hp_config: Optional[HyperparameterConfig] = None):
        self.groups: List[NetworkGroup] = []
        self.optimizer_configs: List[OptimizerConfig] = []
        self.hooks: List[str] = []  # method names called after mutations
        self.hp_config = hp_config or HyperparameterConfig()

    def register_group(self, group: NetworkGroup) -> None:
        self.groups.append(group)

    def register_optimizer(self, cfg: OptimizerConfig) -> None:
        self.optimizer_configs.append(cfg)

    def register_hook(self, method_name: str) -> None:
        self.hooks.append(method_name)

    @property
    def policy_group(self) -> Optional[NetworkGroup]:
        for g in self.groups:
            if g.policy:
                return g
        return None

    def all_network_names(self) -> List[str]:
        names: List[str] = []
        for g in self.groups:
            names.append(g.eval)
            names.extend(g.shared_names())
        return names

    def validate(self) -> None:
        """Exactly one group must be the policy; raises on zero or several."""
        n_policy = sum(1 for g in self.groups if g.policy)
        if n_policy != 1:
            raise ValueError(
                f"An algorithm must register exactly one NetworkGroup with "
                f"policy=True (found {n_policy})"
            )
