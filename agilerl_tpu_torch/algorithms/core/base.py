"""Algorithm base class: the port of the part of
``agilerl_tpu/algorithms/core/base.py:EvolvableAlgorithm`` that GRPO uses.

An algorithm is a thin stateful shell around its network (config, params)
pairs, optimizer states, scalar hyperparameters and random streams. The JAX
key becomes a CPU ``torch.Generator``: ``next_key`` draws a seed from it and
returns a fresh generator on the device asked for (the counterpart of
``jax.random.split``). ``jit_fn`` is a plain cache of the built callables,
dropped after a mutation as the JAX package drops its jitted functions.

``RLAlgorithm`` (the single-agent base of PPO and the DQN family) and
``load_params_from_numpy`` (a JAX agent's network weights into the port)
come with the classic RL slice. ``MultiAgentRLAlgorithm`` and
``MultiAgentSetup`` (the base of MADDPG, MATD3 and IPPO: agent grouping by
id prefix, per-agent and centralised-critic net configs, ``test`` over a
dict-API vector env) come with the multi-agent slice; networks held in
dicts (per agent or per group) checkpoint, clone and load JAX weights as
single networks do.

Checkpoints (``checkpoint_dict``, ``save_checkpoint``, ``load_checkpoint``,
``load``) are a pickle of host numpy: every network's config and weights,
every optimizer's learning rate and state, the training attributes and the
hyperparameters, written atomically (``resilience/atomic.py``). The random
streams are not in them (a weight restore does not replay an old stream), so
a file loads on any device, with or without a card. The JAX package's
checkpoints pickle ``agilerl_tpu`` classes, so the port does not load them;
carry JAX weights with ``load_params_from_numpy`` instead.
"""

from __future__ import annotations

import enum
import pickle
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    MutationRegistry,
    NetworkGroup,
    OptimizerConfig,
)
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.rng import global_seed
from agilerl_tpu_torch.utils.spaces import (
    as_tensor,
    is_single_observation,
    preprocess_observation,
)
from agilerl_tpu_torch.utils.tree import tree_copy, tree_from_numpy, tree_map, tree_to_numpy

_SEED_BOUND = 2 ** 62


class EvolvableAlgorithm:
    """Base for all evolvable agents."""

    def __init__(
        self,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        device: DeviceLike = None,
        accelerator: Optional[Any] = None,
        name: Optional[str] = None,
        seed: Optional[int] = None,
    ):
        self.index = index
        self.device = device
        self.accelerator = accelerator
        self.algo = name or type(self).__name__
        self.registry = MutationRegistry(hp_config)
        self.fitness: List[float] = []
        self.scores: List[float] = []
        self.steps: List[int] = [0]
        self.mut = "None"  # last mutation applied, for logging
        seed = seed if seed is not None else global_seed()
        self._key = torch.Generator().manual_seed(int(seed))
        self.rng = np.random.default_rng(seed)
        self._jit_cache: Dict[str, Callable] = {}

    # -- rng ------------------------------------------------------------- #
    def next_key(self, device: DeviceLike = "cpu") -> torch.Generator:
        """A fresh generator on ``device``, seeded from the agent's stream."""
        seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=self._key))
        return torch.Generator(device=torch.device(device)).manual_seed(seed)

    def rng_state(self) -> Dict[str, Any]:
        """Host capture of both random streams: the CPU generator's state as
        a numpy byte array, and the numpy Generator's state."""
        return {"torch_key": self._key.get_state().numpy().copy(),
                "np_rng": self.rng.bit_generator.state}

    def set_rng_state(self, state: Dict[str, Any]) -> None:
        self._key.set_state(torch.from_numpy(np.asarray(state["torch_key"], np.uint8).copy()))
        bg = getattr(np.random, state["np_rng"]["bit_generator"])()
        bg.state = state["np_rng"]
        self.rng = np.random.Generator(bg)

    # -- registry -------------------------------------------------------- #
    def register_network_group(self, group: NetworkGroup) -> None:
        self.registry.register_group(group)

    def register_optimizer(self, cfg: OptimizerConfig) -> None:
        self.registry.register_optimizer(cfg)

    def register_mutation_hook(self, method_name: str) -> None:
        self.registry.register_hook(method_name)

    def finalize_registry(self) -> None:
        """Call at the end of __init__: validates the registry and builds every
        optimizer's state over its networks' parameters."""
        self.registry.validate()
        for cfg in self.registry.optimizer_configs:
            opt: OptimizerWrapper = getattr(self, cfg.name)
            if opt.opt_state is None:
                opt.init(self._optimizer_params(cfg))

    def _optimizer_params(self, cfg: OptimizerConfig) -> Any:
        nets = {n: getattr(self, n) for n in cfg.networks}
        if len(nets) == 1:
            return _params_of(next(iter(nets.values())))
        return {n: _params_of(net) for n, net in nets.items()}

    # -- reflection ------------------------------------------------------ #
    def evolvable_attributes(self) -> Dict[str, Any]:
        """name -> network object for every registered net."""
        return {n: getattr(self, n) for n in self.registry.all_network_names()}

    @property
    def hp_config(self) -> HyperparameterConfig:
        return self.registry.hp_config

    # -- built-callable cache ------------------------------------------- #
    def jit_fn(self, name: str, factory: Callable[[], Callable]) -> Callable:
        """Get-or-build a callable; dropped on mutation (``_clear_jit_cache``)."""
        fn = self._jit_cache.get(name)
        if fn is None:
            fn = self._jit_cache[name] = factory()
        return fn

    def _clear_jit_cache(self) -> None:
        self._jit_cache = {}

    # -- mutation plumbing ---------------------------------------------- #
    def reinit_optimizers(self) -> None:
        """Re-init all optimizer states for the current parameter shapes."""
        for cfg in self.registry.optimizer_configs:
            getattr(self, cfg.name).reinit(self._optimizer_params(cfg))

    def mutation_hook(self) -> None:
        """Called by the HPO engine after any mutation."""
        self._clear_jit_cache()
        for hook in self.registry.hooks:
            getattr(self, hook)()

    # -- cloning --------------------------------------------------------- #
    @property
    def init_dict(self) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def clone(self, index: Optional[int] = None, wrap: bool = True):
        """Rebuild from init_dict, then copy configs, params, optimizer states
        and training attributes."""
        clone = type(self)(**self.init_dict)
        for name, net in self.evolvable_attributes().items():
            cnet = getattr(clone, name)
            for sub, csub in _net_pairs(net, cnet):
                csub.config = sub.config
                csub.params = tree_copy(sub.params)
        for cfg in self.registry.optimizer_configs:
            mine: OptimizerWrapper = getattr(self, cfg.name)
            theirs: OptimizerWrapper = getattr(clone, cfg.name)
            theirs.lr = mine.lr
            theirs.tx = theirs._build()
            theirs.opt_state = tree_copy(mine.opt_state)
        for hp in self.hp_config.names():
            setattr(clone, hp, getattr(self, hp))
        clone.fitness = list(self.fitness)
        clone.scores = list(self.scores)
        clone.steps = list(self.steps)
        clone.mut = self.mut
        clone.index = self.index if index is None else index
        clone._on_clone(self)
        return clone

    def _on_clone(self, parent: "EvolvableAlgorithm") -> None:
        """Subclass hook for extra copied state."""

    # -- checkpoints ----------------------------------------------------- #
    def checkpoint_dict(self) -> Dict[str, Any]:
        """The agent as host numpy: networks (config + weights), optimizers
        (lr + state), training attributes and hyperparameters."""

        def blob(net):
            if isinstance(net, dict):
                return {k: blob(v) for k, v in net.items()}
            return {"config": net.config, "params": tree_to_numpy(net.params)}

        attrs = {"index": self.index, "fitness": self.fitness, "scores": self.scores,
                 "steps": self.steps, "mut": self.mut}
        for hp in self.hp_config.names():
            attrs[hp] = getattr(self, hp)
        return {
            "agilerl_tpu_torch_class": type(self).__name__,
            "init_dict": self.init_dict,
            "networks": {n: blob(net) for n, net in self.evolvable_attributes().items()},
            "optimizers": {cfg.name: {"lr": getattr(self, cfg.name).lr,
                                      "state": tree_to_numpy(getattr(self, cfg.name).opt_state)}
                           for cfg in self.registry.optimizer_configs},
            "attrs": attrs,
        }

    def save_checkpoint(self, path: Union[str, Path]) -> None:
        """Atomic save (temporary file, fsync, ``os.replace``): a kill in the
        middle leaves the previous checkpoint or the new one, never a torn
        pickle."""
        from agilerl_tpu_torch.resilience.atomic import atomic_write_bytes

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        atomic_write_bytes(path, pickle.dumps(self.checkpoint_dict(),
                                              protocol=pickle.HIGHEST_PROTOCOL))

    def load_checkpoint(self, path: Union[str, Path]) -> None:
        with open(path, "rb") as f:
            self._restore(pickle.load(f))

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        dev = getattr(self, "dev", None) or resolve_device(self.device)

        def load(net, blob):
            if isinstance(net, dict):
                for k in net:
                    load(net[k], blob[k])
                return
            net.config = blob["config"]
            net.params = tree_from_numpy(blob["params"], dev)

        for name, blob in ckpt["networks"].items():
            load(getattr(self, name), blob)
        for cname, blob in ckpt["optimizers"].items():
            opt: OptimizerWrapper = getattr(self, cname)
            opt.lr = blob["lr"]
            opt.tx = opt._build()
            opt.opt_state = tree_from_numpy(blob["state"], dev)
        for k, v in ckpt["attrs"].items():
            setattr(self, k, v)
        self._resize_rollout_buffers()
        self._clear_jit_cache()

    def _resize_rollout_buffers(self) -> None:
        """A restored ``learn_step`` sizes the rollout buffers (IPPO keeps one
        per group), as its mutation does: a buffer of another horizon is
        allocated afresh. The JAX package's ``_restore`` keeps the
        constructor's horizon (a whole-run resume of a PPO population after
        a ``learn_step`` mutation raised an ``IndexError`` in the port until
        this resize)."""
        bufs = list(getattr(self, "rollout_buffers", {}).values())
        if getattr(self, "rollout_buffer", None) is not None:
            bufs.append(self.rollout_buffer)
        for buf in bufs:
            if buf.capacity != int(self.learn_step):
                buf.capacity = int(self.learn_step)
                buf.state = None

    @classmethod
    def load(cls, path: Union[str, Path], device: DeviceLike = None):
        """An agent rebuilt from a checkpoint file on ``device``, whatever
        device it was saved from: ``None`` means the card, as in every
        constructor, and raises without one. Checkpoints written by the JAX
        package pickle ``agilerl_tpu`` classes and do not load here."""
        with open(path, "rb") as f:
            ckpt = pickle.load(f)
        init = dict(ckpt["init_dict"])
        init["device"] = device
        agent = cls(**cls._init_from_checkpoint(init, device))
        agent._restore(ckpt)
        return agent

    @classmethod
    def _init_from_checkpoint(cls, init: Dict[str, Any], device: DeviceLike) -> Dict[str, Any]:
        """Subclass hook: constructor kwargs from a checkpoint's
        ``init_dict`` (host values back onto ``device``)."""
        return init


def _params_of(net) -> Any:
    if isinstance(net, dict):
        return {k: _params_of(v) for k, v in net.items()}
    return net.params


def _net_pairs(a, b):
    """Yield matching (net, clone_net) leaf pairs across dict-of-nets."""
    if isinstance(a, dict):
        for k in a:
            yield from _net_pairs(a[k], b[k])
    else:
        yield a, b


class MultiAgentSetup(enum.Enum):
    """Observation-space structure of a multi-agent problem."""

    HOMOGENEOUS = "homogeneous"  # all agents share one observation space
    MIXED = "mixed"  # agents group into more than one space class
    HETEROGENEOUS = "heterogeneous"  # every agent's space differs


class MultiAgentRLAlgorithm(EvolvableAlgorithm):
    """Multi-agent base: the port of the JAX ``MultiAgentRLAlgorithm``.
    Agents group by id prefix (``speaker_0`` -> ``speaker``), each group
    homogeneous in its spaces. ``device=None`` means the card (raising
    without one); ``self.dev`` is the resolved device of every network."""

    def __init__(self, observation_spaces, action_spaces, agent_ids=None,
                 device: DeviceLike = None, **kwargs):
        super().__init__(device=device, **kwargs)
        self.dev = resolve_device(device)
        if agent_ids is None:
            agent_ids = list(observation_spaces.keys())
        self.agent_ids = list(agent_ids)
        self.n_agents = len(self.agent_ids)
        self.observation_spaces = dict(observation_spaces)
        self.action_spaces = dict(action_spaces)
        self.grouped_agents = self._group_agents()

    @staticmethod
    def get_group_id(agent_id: str) -> str:
        """``speaker_0`` -> ``speaker``; an id without a numeric suffix is its
        own group."""
        parts = str(agent_id).rsplit("_", 1)
        if len(parts) == 2 and parts[1].isdigit():
            return parts[0]
        return str(agent_id)

    def _group_agents(self) -> Dict[str, List[str]]:
        groups: Dict[str, List[str]] = {}
        for aid in self.agent_ids:
            groups.setdefault(self.get_group_id(aid), []).append(aid)
        for gid, members in groups.items():
            obs_ = {repr(self.observation_spaces[m]) for m in members}
            act_ = {repr(self.action_spaces[m]) for m in members}
            assert len(obs_) == 1 and len(act_) == 1, (
                f"Agents in group {gid!r} must share observation/action spaces")
        return groups

    @property
    def unique_observation_spaces(self) -> Dict[str, Any]:
        """One observation space per distinct space, keyed by the first group
        that carries it."""
        seen: Dict[str, Any] = {}
        sigs: set = set()
        for gid, members in self.grouped_agents.items():
            sig = repr(self.observation_spaces[members[0]])
            if sig not in sigs:
                sigs.add(sig)
                seen[gid] = self.observation_spaces[members[0]]
        return seen

    def get_setup(self) -> MultiAgentSetup:
        n_unique = len({repr(s) for s in self.observation_spaces.values()})
        if n_unique == 1:
            return MultiAgentSetup.HOMOGENEOUS
        if n_unique < self.n_agents:
            return MultiAgentSetup.MIXED
        return MultiAgentSetup.HETEROGENEOUS

    def build_net_config(self, net_config: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Dict[str, Any]]:
        """Per-agent net config from one user dict, keyed by agent id, group
        id or flat. A flat ``encoder_config`` is filtered per agent to the
        keys its space's encoder family takes; an explicit per-agent or
        per-group override is kept as it is."""
        out: Dict[str, Dict[str, Any]] = {}
        for aid in self.agent_ids:
            cfg, override = self._merged_net_config(net_config, aid)
            if cfg.get("encoder_config") and "encoder_config" not in override:
                cfg["encoder_config"] = self._filter_for_space(cfg, self.observation_spaces[aid])
            out[aid] = cfg
        return out

    def _merged_net_config(self, net_config, aid):
        """(flat defaults updated by the agent's or group's override, the
        override)."""
        net_config = dict(net_config or {})
        id_keys = {k for k in net_config if k in self.agent_ids or k in self.grouped_agents}
        flat = {k: v for k, v in net_config.items() if k not in id_keys}
        override = net_config.get(aid)
        if override is None:
            override = net_config.get(self.get_group_id(aid), {})
        return {**flat, **override}, override

    @staticmethod
    def _filter_for_space(cfg: Dict[str, Any], space) -> Dict[str, Any]:
        from agilerl_tpu_torch.networks.base import filter_encoder_config

        return filter_encoder_config(
            space, cfg.get("encoder_config"), latent_dim=int(cfg.get("latent_dim", 32)),
            simba=bool(cfg.get("simba", False)), recurrent=bool(cfg.get("recurrent", False)),
            resnet=bool(cfg.get("resnet", False)))

    def build_critic_config(self, critic_space, net_config: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Dict[str, Any]]:
        """Per-agent config of a centralised critic over ``critic_space``:
        the user's own encoder_config filtered against the critic's space."""
        out: Dict[str, Dict[str, Any]] = {}
        for aid in self.agent_ids:
            cfg, _ = self._merged_net_config(net_config, aid)
            if cfg.get("encoder_config"):
                cfg["encoder_config"] = self._filter_for_space(cfg, critic_space)
            out[aid] = cfg
        return out

    def preprocess_observation(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        return {aid: preprocess_observation(self.observation_spaces[aid], obs[aid], self.dev)
                for aid in self.agent_ids}

    def sum_shared_rewards(self, rewards: Dict[str, Any]) -> Dict[str, Any]:
        """Every agent gets the sum of all agents' rewards (f64; tensors stay
        on their device)."""
        vals = list(rewards.values())
        if any(isinstance(v, torch.Tensor) for v in vals):
            total = sum(as_tensor(v, self.dev).double() for v in vals)
        else:
            total = sum(np.asarray(v, np.float64) for v in vals)
        return {aid: total for aid in self.agent_ids}

    def batched_observation(self, obs: Dict[str, Any]):
        """(preprocessed ``[B, ...]`` observations per agent, whether ``obs``
        was one unbatched observation per agent)."""
        pre = self.preprocess_observation(obs)
        aid = self.agent_ids[0]
        single = is_single_observation(pre[aid], self.observation_spaces[aid])
        if single:
            pre = tree_map(lambda x: x[None], pre)
        return pre, single

    def test(self, env, swap_channels: bool = False, max_steps: Optional[int] = None,
             loop: int = 3, sum_scores: bool = True) -> float:
        """Mean over ``loop`` rounds of the summed (or, without
        ``sum_scores``, agent-averaged) greedy episode return of each
        vectorised env; appended to ``fitness``. Returns and done flags stay
        on the device; each step syncs once, to test whether every env is
        done. NaN placeholders are zeroed first."""
        from agilerl_tpu_torch.rollouts.on_policy import env_action
        from agilerl_tpu_torch.vector.pz_vec_env import sanitize_ma_transition

        rewards = []
        num_envs = getattr(env, "num_envs", 1)
        for _ in range(loop):
            obs, info = env.reset()
            done = torch.zeros(num_envs, dtype=torch.bool, device=self.dev)
            total = torch.zeros(num_envs, dtype=torch.float64, device=self.dev)
            steps = 0
            while not bool(done.all()):
                action = self.get_action(obs, training=False, infos=info)
                obs, reward, terminated, truncated, info = env.step(
                    {a: env_action(env, v) for a, v in action.items()})
                obs, reward = sanitize_ma_transition(obs, reward)
                agg = sum(as_tensor(reward[a], self.dev).double().reshape(-1)
                          for a in self.agent_ids)
                if not sum_scores:
                    agg = agg / self.n_agents
                total = total + agg * (~done)
                for a in self.agent_ids:
                    done = done | as_tensor(terminated[a], self.dev).bool().reshape(-1) \
                        | as_tensor(truncated[a], self.dev).bool().reshape(-1)
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
            rewards.append(total.mean())
        fitness = float(torch.stack(rewards).mean())
        self.fitness.append(fitness)
        return fitness


class RLAlgorithm(EvolvableAlgorithm):
    """Single-agent RL base: the port of ``RLAlgorithm``. ``device=None``
    means the card (raising without one); ``self.dev`` is the resolved
    device every network, buffer and generator of the agent lives on."""

    def __init__(self, observation_space, action_space, device: DeviceLike = None, **kwargs):
        super().__init__(device=device, **kwargs)
        self.dev = resolve_device(device)
        self.observation_space = observation_space
        self.action_space = action_space

    def preprocess_observation(self, obs: Any) -> Any:
        return preprocess_observation(self.observation_space, obs, self.dev)

    def test(self, env, swap_channels: bool = False, max_steps: Optional[int] = None,
             loop: int = 3, sum_scores: bool = True) -> float:
        """Mean return over ``loop`` rounds of greedy episodes, one per
        vectorised env; appended to ``fitness``. Returns and done flags stay
        on the device; each step syncs once, to test whether every env is
        done."""
        from agilerl_tpu_torch.rollouts.on_policy import env_action

        rewards = []
        num_envs = getattr(env, "num_envs", 1)
        for _ in range(loop):
            obs, _ = env.reset()
            done = torch.zeros(num_envs, dtype=torch.bool, device=self.dev)
            total = torch.zeros(num_envs, dtype=torch.float64, device=self.dev)
            steps = 0
            while not bool(done.all()):
                action = self.get_action(obs, training=False)
                if num_envs == 1 and action.dim() > 0 and not hasattr(env, "num_envs"):
                    action = action[0]
                obs, reward, terminated, truncated, _ = env.step(env_action(env, action))
                step_done = torch.logical_or(as_tensor(terminated, self.dev).to(torch.bool),
                                             as_tensor(truncated, self.dev).to(torch.bool))
                total = total + as_tensor(reward, self.dev).to(torch.float64) * (~done)
                done = torch.logical_or(done, step_done)
                steps += 1
                if max_steps is not None and steps >= max_steps:
                    break
            rewards.append(total.mean() if sum_scores else total)
        fitness = float(torch.stack(rewards).mean())
        self.fitness.append(fitness)
        return fitness


def load_params_from_numpy(agent: EvolvableAlgorithm, trees: Dict[str, Any]) -> None:
    """Load JAX-package network parameters (``{attr: numpy tree}`` for every
    registered network of ``agent``, eval and shared; a dict of networks,
    per agent or per group, takes a dict of trees under the same keys) into
    the agent's networks through ``networks.base.params_from_numpy``, each checked
    against its config and its class's own init (the noisy layers' mean and
    sigma weights, Rainbow's value stream), then re-init every optimizer for
    them."""
    from agilerl_tpu_torch.networks.base import params_from_numpy

    def load(net, tree, where):
        if isinstance(net, dict):
            if set(tree) != set(net):
                raise ValueError(f"{where}: expected trees for {sorted(net)}, got {sorted(tree)}")
            for k in net:
                load(net[k], tree[k], f"{where}[{k!r}]")
            return
        net.params = params_from_numpy(tree, net.config, agent.dev,
                                       extra=net.extra_template(), init=type(net).init_params)

    names = agent.registry.all_network_names()
    if set(trees) != set(names):
        raise ValueError(f"expected trees for {sorted(names)}, got {sorted(trees)}")
    for name in names:
        load(getattr(agent, name), trees[name], name)
    agent.reinit_optimizers()
