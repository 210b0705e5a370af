"""Runtime-checkable protocol contracts of the framework's core interfaces:
the port's own copy of ``agilerl_tpu/protocols.py``.

Modules are ``(frozen config, params tree)`` pairs whose compute lives in
static ``apply(config, params, x)`` functions, so ``EvolvableModuleProtocol``
pins the params / state_dict / mutation surface; algorithms are stateful
shells over pure train steps, so ``EvolvableAlgorithmProtocol`` pins the
registry / clone / checkpoint surface the HPO engine relies on. Each is a
``typing.Protocol`` marked ``@runtime_checkable``: ``isinstance`` checks
the presence of members, not their signatures.
"""

from __future__ import annotations

from typing import (
    Any,
    Dict,
    Iterator,
    List,
    Optional,
    Protocol,
    TypeVar,
    runtime_checkable,
)

import numpy as np

import torch

from agilerl_tpu_torch.typing import MutationType

# a JAX key becomes a torch.Generator; parameters are trees of tensors
KeyArray = torch.Generator
Params = Any

__all__ = [
    "MutationMethodProtocol",
    "EvolvableModuleProtocol",
    "ModuleDictProtocol",
    "EvolvableNetworkProtocol",
    "OptimizerWrapperProtocol",
    "NetworkGroupProtocol",
    "OptimizerConfigProtocol",
    "HyperparameterConfigProtocol",
    "MutationRegistryProtocol",
    "EvolvableAlgorithmProtocol",
    "RLAlgorithmProtocol",
    "MultiAgentRLAlgorithmProtocol",
    "AgentWrapperProtocol",
    "VecEnvProtocol",
    "ReplayBufferProtocol",
]


@runtime_checkable
class MutationMethodProtocol(Protocol):
    """A mutation method's descriptor metadata (reference protocols.py:53).

    Attached by the ``@mutation`` decorator: the wrapped config-transforming
    function plus the mutation class it belongs to (LAYER/NODE/ACTIVATION)
    and whether shrinking params must be re-sliced rather than preserved.
    """

    fn: Any
    mutation_type: MutationType
    shrink_params: bool


@runtime_checkable
class EvolvableModuleProtocol(Protocol):
    """A mutation-capable (config, params) module (reference protocols.py:95).

    The reference's protocol revolves around ``nn.Module`` forward/state_dict;
    here the instance surface is the evolution + checkpoint contract, while
    compute is reachable via the class's static ``apply``.
    """

    config: Any
    params: Params

    @property
    def init_dict(self) -> Dict[str, Any]: ...

    @classmethod
    def get_mutation_methods(cls) -> Dict[str, MutationMethodProtocol]: ...

    def sample_mutation_method(
        self,
        new_layer_prob: float = 0.2,
        rng: Optional[np.random.Generator] = None,
    ) -> Optional[str]: ...

    def apply_mutation(
        self, name: str, rng: Optional[np.random.Generator] = None
    ) -> Dict: ...

    def clone(self) -> "EvolvableModuleProtocol": ...

    def state_dict(self) -> Params: ...

    def load_state_dict(self, params: Params) -> None: ...


T_Module = TypeVar("T_Module", bound=EvolvableModuleProtocol)


@runtime_checkable
class ModuleDictProtocol(Protocol):
    """Container of named evolvable modules (reference protocols.py:214)."""

    def __getitem__(self, k: str) -> Any: ...

    def __setitem__(self, k: str, v: Any) -> None: ...

    def __iter__(self) -> Iterator[str]: ...

    def __len__(self) -> int: ...

    def keys(self) -> Any: ...

    def values(self) -> Any: ...

    def items(self) -> Any: ...

    @property
    def params(self) -> Dict[str, Params]: ...

    def clone(self) -> "ModuleDictProtocol": ...


@runtime_checkable
class EvolvableNetworkProtocol(Protocol):
    """Encoder + head network with latent-space mutations
    (reference protocols.py:159).

    Same evolution surface as a module, plus the encoder/head split: the
    network owns an auto-selected encoder (MLP/CNN/MultiInput by observation
    space) and exposes latent mutations that rebuild the head boundary.
    """

    config: Any
    params: Params

    @property
    def init_dict(self) -> Dict[str, Any]: ...

    def mutation_methods(self) -> List[str]: ...

    def sample_mutation_method(
        self,
        new_layer_prob: float = 0.2,
        rng: Optional[np.random.Generator] = None,
    ) -> Optional[str]: ...

    def apply_mutation(
        self, name: str, rng: Optional[np.random.Generator] = None
    ) -> Dict: ...

    def change_activation(self, activation: str, output: bool = False) -> None: ...

    def clone(self) -> "EvolvableNetworkProtocol": ...

    def state_dict(self) -> Params: ...

    def load_state_dict(self, params: Params) -> None: ...


@runtime_checkable
class OptimizerWrapperProtocol(Protocol):
    """Optimizer lifecycle owner (reference protocols.py:81).

    Wraps an optax transformation: (re)init against a params pytree after
    architecture mutations, apply updates, mutate the learning rate in place.
    """

    lr: float

    def init(self, params: Any) -> None: ...

    def reinit(self, params: Any) -> None: ...

    def set_lr(self, lr: float) -> None: ...

    def update(self, grads: Any, params: Any) -> Any: ...

    def state_dict(self) -> Any: ...

    def load_state_dict(self, state: Any) -> None: ...


@runtime_checkable
class NetworkGroupProtocol(Protocol):
    """A policy/evaluation network group (reference protocols.py:278)."""

    eval: str
    shared: Any
    policy: bool

    def shared_names(self) -> List[str]: ...


@runtime_checkable
class OptimizerConfigProtocol(Protocol):
    """Which networks an optimizer owns (reference protocols.py:292)."""

    name: str
    networks: Any
    lr: str


@runtime_checkable
class HyperparameterConfigProtocol(Protocol):
    """Named RL hyperparameter search space (reference hpo/mutation.py usage)."""

    def names(self) -> List[str]: ...

    def sample(self, rng: Optional[np.random.Generator] = None) -> Optional[str]: ...

    def __getitem__(self, k: str) -> Any: ...

    def __contains__(self, k: str) -> bool: ...


@runtime_checkable
class MutationRegistryProtocol(Protocol):
    """Registry binding groups + optimizers + hooks (reference protocols.py:311)."""

    groups: List[Any]
    optimizer_configs: List[Any]
    hooks: List[str]

    def register_group(self, group: Any) -> None: ...

    def register_optimizer(self, cfg: Any) -> None: ...

    def register_hook(self, method_name: str) -> None: ...

    @property
    def policy_group(self) -> Optional[Any]: ...

    def all_network_names(self) -> List[str]: ...

    def validate(self) -> None: ...


@runtime_checkable
class EvolvableAlgorithmProtocol(Protocol):
    """The HPO engine's view of an algorithm (reference protocols.py:333).

    Tournament selection needs fitness/clone/index; Mutations needs the
    registry, evolvable_attributes, hp_config, reinit_optimizers and the
    mutation bookkeeping attrs; trainers and checkpointing need
    save/load_checkpoint. Every concrete algorithm (DQN ... GRPO) satisfies
    this structurally — asserted in tests/test_protocols.py.
    """

    registry: MutationRegistryProtocol
    fitness: List[float]
    scores: List[float]
    steps: List[int]
    index: int
    mut: Any

    def evolvable_attributes(self) -> Dict[str, Any]: ...

    @property
    def hp_config(self) -> Any: ...

    @property
    def init_dict(self) -> Dict[str, Any]: ...

    def clone(self, index: Optional[int] = None, wrap: bool = True) -> Any: ...

    def reinit_optimizers(self) -> None: ...

    def mutation_hook(self) -> None: ...

    def checkpoint_dict(self) -> Dict[str, Any]: ...

    def save_checkpoint(self, path: Any) -> None: ...

    def load_checkpoint(self, path: Any) -> None: ...

    def test(self, env: Any, *args: Any, **kwargs: Any) -> float: ...


@runtime_checkable
class RLAlgorithmProtocol(EvolvableAlgorithmProtocol, Protocol):
    """Single-agent algorithm: adds the acting/learning surface
    (reference protocols.py:333 get_action/learn members)."""

    observation_space: Any
    action_space: Any

    def get_action(self, obs: Any, *args: Any, **kwargs: Any) -> Any: ...

    def learn(self, experiences: Any, *args: Any, **kwargs: Any) -> Any: ...

    def preprocess_observation(self, obs: Any) -> Any: ...


@runtime_checkable
class MultiAgentRLAlgorithmProtocol(EvolvableAlgorithmProtocol, Protocol):
    """Multi-agent algorithm: dict-keyed spaces and grouped agents."""

    observation_spaces: Any
    action_spaces: Any
    agent_ids: List[str]

    def get_action(self, obs: Any, *args: Any, **kwargs: Any) -> Any: ...

    def learn(self, experiences: Any, *args: Any, **kwargs: Any) -> Any: ...

    def preprocess_observation(self, obs: Dict[str, Any]) -> Dict[str, Any]: ...


@runtime_checkable
class AgentWrapperProtocol(Protocol):
    """Wrapper delegating to an algorithm (reference protocols.py:418).

    RSNorm and AsyncAgentsWrapper satisfy this: they forward get_action/learn
    while transforming observations/experiences in between.
    """

    agent: Any

    def get_action(self, obs: Any, *args: Any, **kwargs: Any) -> Any: ...

    def learn(self, experiences: Any, *args: Any, **kwargs: Any) -> Any: ...


@runtime_checkable
class VecEnvProtocol(Protocol):
    """Vectorised env surface the trainers consume (reference
    vector/pz_vec_env.py + gymnasium VectorEnv overlap)."""

    num_envs: int

    def reset(self, *args: Any, **kwargs: Any) -> Any: ...

    def step(self, actions: Any) -> Any: ...


@runtime_checkable
class ReplayBufferProtocol(Protocol):
    """Experience store surface shared by all off-policy buffers."""

    def __len__(self) -> int: ...

    def add(self, *args: Any, **kwargs: Any) -> Any: ...

    def sample(self, *args: Any, **kwargs: Any) -> Any: ...

    def clear(self) -> None: ...
