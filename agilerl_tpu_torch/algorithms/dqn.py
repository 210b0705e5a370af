"""DQN: the port of ``agilerl_tpu/algorithms/dqn.py`` (epsilon-greedy act,
plain and masked; the TD update with the double-DQN option; the soft target
update; ``learn`` and ``learn_from_buffer``).

One TD step is the loss, its gradient, Adam and the soft target update
(``torch._foreach_lerp_`` over the target's leaves, in place). Every step
reads the current configs, optimizer and hyperparameters, so no built
callable outlives a mutation. ``learn_from_buffer`` samples (uniform or PER
inverse-CDF, on draws made first from the agent's generator), learns and
writes PER priorities back in one call with no host sync, and returns the
loss as a device tensor. Exploration draws come from the agent's generator;
masked exploration draws uniformly among the allowed actions (Gumbel-max),
so it never picks a masked one.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.algorithms.core import fused as F
from agilerl_tpu_torch.algorithms.core.base import RLAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.networks.q_networks import QNetwork
from agilerl_tpu_torch.utils.spaces import as_tensor, is_single_observation
from agilerl_tpu_torch.utils.tree import tree_map


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=8, max=512, dtype=int),
        learn_step=RLParameter(min=1, max=16, dtype=int),
    )


def soft_update_(target: Dict, online: Dict, tau: float) -> None:
    """``target <- target + tau * (online - target)`` in place, one
    multi-tensor launch over every leaf (paired by path)."""
    pairs = []
    tree_map(lambda t, p: pairs.append((t, p)), target, online)
    torch._foreach_lerp_([t for t, _ in pairs], [p for _, p in pairs], tau)


def select(values: torch.Tensor, taken: torch.Tensor) -> torch.Tensor:
    """``values[..., taken]`` row by row (``take_along_axis``)."""
    return values.gather(-1, taken.long()[..., None])[..., 0]


def batched_obs(agent, obs: Any, action_mask=None):
    """(preprocessed ``[B, ...]`` obs, bool mask ``[B, A]`` or None, whether
    ``obs`` was one unbatched observation) on the agent's device."""
    obs = agent.preprocess_observation(obs)
    single = is_single_observation(obs, agent.observation_space)
    if single:
        obs = tree_map(lambda x: x[None], obs)
    mask = None if action_mask is None else as_tensor(action_mask, agent.dev).bool()
    if mask is not None and mask.dim() == 1:
        mask = mask[None]
    return obs, mask, single


def epsilon_greedy(q: torch.Tensor, epsilon: float, mask: Optional[torch.Tensor],
                   gen: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy actions of ``q`` (masked entries at -1e8), each replaced with
    probability ``epsilon`` by a uniform draw among the allowed actions."""
    if mask is not None:
        q = torch.where(mask, q, -1e8)
    greedy = torch.argmax(q, dim=-1)
    if epsilon <= 0.0:
        return greedy
    explore = torch.rand(greedy.shape, generator=gen, device=q.device) < epsilon
    u = torch.rand(q.shape, generator=gen, device=q.device).clamp_min(1e-20)
    gumbel = -torch.log(-torch.log(u))
    if mask is not None:
        gumbel = torch.where(mask, gumbel, -torch.inf)
    return torch.where(explore, torch.argmax(gumbel, dim=-1), greedy)


class DQN(RLAlgorithm):
    #: learn_from_buffer samples PER and writes its priorities back
    supports_fused_per = True

    def __init__(
        self,
        observation_space,
        action_space,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        net_config: Optional[Dict[str, Any]] = None,
        batch_size: int = 64,
        lr: float = 1e-4,
        learn_step: int = 5,
        gamma: float = 0.99,
        tau: float = 1e-3,
        double: bool = False,
        normalize_images: bool = True,
        device=None,
        **kwargs,
    ):
        super().__init__(observation_space, action_space, index=index,
                         hp_config=hp_config or default_hp_config(), device=device, **kwargs)
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.learn_step = int(learn_step)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.double = bool(double)
        self.net_config = dict(net_config or {})

        self.actor = QNetwork(observation_space, action_space, key=self.next_key(),
                              device=self.dev, **self.net_config)
        self.actor_target = self.actor.clone()
        self.optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr)
        self.register_network_group(NetworkGroup(eval="actor", shared="actor_target",
                                                 policy=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor"], lr="lr"))
        self.finalize_registry()

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "observation_space": self.observation_space,
            "action_space": self.action_space,
            "index": self.index,
            "net_config": self.net_config,
            "batch_size": self.batch_size,
            "lr": self.lr,
            "learn_step": self.learn_step,
            "gamma": self.gamma,
            "tau": self.tau,
            "double": self.double,
            "device": self.dev,
        }

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def get_action(self, obs: Any, epsilon: float = 0.0, action_mask=None,
                   training: bool = True) -> torch.Tensor:
        """Epsilon-greedy actions on the device (greedy when not
        ``training``); an unbatched observation gives one action."""
        obs, mask, single = batched_obs(self, obs, action_mask)
        q = QNetwork.apply(self.actor.config, self.actor.params, obs)
        eps = float(epsilon) if training else 0.0
        actions = epsilon_greedy(q, eps, mask, self.next_key(self.dev) if eps > 0 else None)
        return actions[0] if single else actions

    # ------------------------------------------------------------------ #
    def _td_target(self, batch: Dict, gamma: float) -> torch.Tensor:
        config = self.actor.config
        reward = as_tensor(batch["reward"], self.dev).float()
        done = as_tensor(batch["done"], self.dev).float()
        q_next_t = QNetwork.apply(config, self.actor_target.params, batch["next_obs"])
        if self.double:
            next_a = torch.argmax(QNetwork.apply(config, self.actor.params, batch["next_obs"]),
                                  dim=-1)
            q_next = select(q_next_t, next_a)
        else:
            q_next = q_next_t.max(dim=-1).values
        return reward + gamma * (1.0 - done) * q_next

    def _loss(self, q: torch.Tensor, q_sel: torch.Tensor, td: torch.Tensor,
              weights: torch.Tensor) -> torch.Tensor:
        """The weighted mean squared TD error (CQN adds its penalty)."""
        return torch.mean(weights * torch.square(td))

    def _train_step(self, batch: Dict, weights: torch.Tensor, gamma: float, tau: float):
        """One TD update of ``actor`` and its soft target on a preprocessed
        batch; returns (loss, |TD error|), both on the device."""
        config = self.actor.config
        with torch.no_grad():
            target = self._td_target(batch, gamma)
        action = as_tensor(batch["action"], self.dev)

        def loss_of(p):
            q = QNetwork.apply(config, p, batch["obs"])
            q_sel = select(q, action)
            td = q_sel - target
            return self._loss(q, q_sel, td, weights), torch.abs(td)

        with torch.enable_grad():
            params, opt_state, loss, td_abs = grad_step(
                loss_of, self.actor.params, self.optimizer.tx, self.optimizer.opt_state)
        self.actor.params = params
        self.optimizer.opt_state = opt_state
        soft_update_(self.actor_target.params, params, tau)
        return loss, td_abs

    def learn_from_buffer(self, memory, n_step_memory=None, key: Optional[torch.Generator] = None,
                          beta: float = 0.4, draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample (uniform, or PER with the priority write-back) and learn in
        one call with no host sync; returns the loss as a device tensor.
        ``draws`` (PER's uniforms or the uniform indices, ``[batch_size]``)
        stand in for the ones the agent's generator (or ``key``) makes."""
        state, _, per = F.resolve_states(memory, n_step_memory)
        if draws is None:
            gen = key if key is not None else self.next_key(self.dev)
            draws = F.draw_sample(state, per, gen, self.batch_size)
        if per:
            batch, idx, weights = F.per_sample(state, draws, float(beta))
        else:
            batch, idx, weights = F.uniform_sample(state, draws)
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        loss, td_abs = self._train_step(batch, weights, self.gamma, self.tau)
        if per:
            memory.per_state = F.per_write_back(state, idx, td_abs + 1e-6, memory.alpha)
        return loss

    def learn(self, experiences):
        """One TD update from a sampled batch (a dict, or a PER tuple
        ``(batch, idxs, weights)``: then the loss is importance-weighted and
        ``(loss, new priorities)`` is returned). Reads the loss on the host."""
        idxs = None
        if isinstance(experiences, tuple):
            batch, idxs, weights = experiences[0], experiences[1], experiences[2]
            weights = as_tensor(weights, self.dev).float()
        else:
            batch = experiences
            weights = torch.ones_like(as_tensor(batch["reward"], self.dev).float())
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        loss, td_abs = self._train_step(batch, weights, self.gamma, self.tau)
        if idxs is not None:
            return float(loss), (td_abs + 1e-6).cpu().numpy()
        return float(loss)

    def soft_update(self) -> None:
        """An explicit soft target update (``learn`` already makes one)."""
        soft_update_(self.actor_target.params, self.actor.params, self.tau)
