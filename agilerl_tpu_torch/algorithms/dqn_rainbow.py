"""Rainbow DQN: the port of ``agilerl_tpu/algorithms/dqn_rainbow.py`` (C51
categorical projection, double selection, noisy-net exploration, the
paired n-step term at ``gamma ** n_step``, PER priorities with
``prior_eps``).

One update: the per-sample cross-entropy of the online atoms against the
projected target atoms (the next action chosen by the online net,
evaluated by the target net), plus the same term on the paired n-step
batch, weighted and averaged; its gradient, Adam, and the soft target
update in place. The noise of every noisy layer comes from one generator
per call, drawn from the agent's stream. ``learn_from_buffer`` samples,
gathers the paired n-step rows at the same indices, learns and writes the
PER priorities back in one call with no host sync.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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
from agilerl_tpu_torch.algorithms.dqn import batched_obs, epsilon_greedy, soft_update_
from agilerl_tpu_torch.networks.q_networks import RainbowQNetwork, support
from agilerl_tpu_torch.utils.spaces import as_tensor


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=8, max=512, dtype=int),
        learn_step=RLParameter(min=1, max=16, dtype=int),
    )


def categorical_projection(next_dist: torch.Tensor, reward: torch.Tensor, done: torch.Tensor,
                           gamma: float, support: torch.Tensor, v_min: float,
                           v_max: float) -> torch.Tensor:
    """Project the Bellman-updated atom distribution ``next_dist`` ``[B,
    atoms]`` back onto ``support`` (C51): each atom's mass is split between
    its lower and upper neighbours by ``scatter_add_``, the full mass on
    ``lower`` where ``b`` is an integer."""
    num_atoms = support.shape[0]
    delta_z = (v_max - v_min) / (num_atoms - 1)
    tz = reward[:, None] + gamma * (1.0 - done[:, None]) * support[None, :]
    tz = torch.clamp(tz, v_min, v_max)
    b = (tz - v_min) / delta_z
    lower = torch.floor(b).long()
    upper = torch.ceil(b).long()
    eq = (upper == lower).float()
    w_lower = (upper.float() - b) + eq
    w_upper = b - lower.float()
    proj = torch.zeros_like(next_dist)
    proj.scatter_add_(1, lower, next_dist * w_lower)
    proj.scatter_add_(1, torch.clamp(upper, 0, num_atoms - 1), next_dist * w_upper)
    return proj


def _at_action(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``x[b, action[b]]`` of ``[B, actions, atoms]`` -> ``[B, atoms]``."""
    idx = action.long()[:, None, None].expand(-1, 1, x.shape[-1])
    return x.gather(1, idx)[:, 0]


class RainbowDQN(RLAlgorithm):
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
        beta: float = 0.4,
        prior_eps: float = 1e-6,
        num_atoms: int = 51,
        v_min: float = -100.0,
        v_max: float = 100.0,
        n_step: int = 3,
        noise_std: float = 0.5,
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
        self.beta = float(beta)
        self.prior_eps = float(prior_eps)
        self.num_atoms = int(num_atoms)
        self.v_min = float(v_min)
        self.v_max = float(v_max)
        self.n_step = int(n_step)
        self.noise_std = float(noise_std)
        self.net_config = dict(net_config or {})

        self.actor = RainbowQNetwork(observation_space, action_space, num_atoms=num_atoms,
                                     v_min=v_min, v_max=v_max, noise_std=noise_std,
                                     key=self.next_key(), device=self.dev, **self.net_config)
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
            "beta": self.beta,
            "prior_eps": self.prior_eps,
            "num_atoms": self.num_atoms,
            "v_min": self.v_min,
            "v_max": self.v_max,
            "n_step": self.n_step,
            "noise_std": self.noise_std,
            "device": self.dev,
        }

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def get_action(self, obs: Any, epsilon: float = 0.0, action_mask=None,
                   training: bool = True, **kwargs) -> torch.Tensor:
        """Greedy actions of the noisy net (fresh noise per call when
        ``training``, the mean weights otherwise). ``epsilon`` is taken for
        the training loop's sake and ignored: the noise explores."""
        obs, mask, single = batched_obs(self, obs, action_mask)
        key = self.next_key(self.dev) if training else None
        q = RainbowQNetwork.apply(self.actor.config, self.actor.params, obs, key=key)
        actions = epsilon_greedy(q, 0.0, mask, None)
        return actions[0] if single else actions

    # ------------------------------------------------------------------ #
    def _loss_terms(self, config, params: Dict, tparams: Dict, batch: Dict, gamma: float,
                    gen: Optional[torch.Generator]) -> torch.Tensor:
        """Per-sample categorical cross-entropy ``[B]`` (C51 with double
        selection: online, target and online noise draws in that order)."""
        action = as_tensor(batch["action"], self.dev)
        reward = as_tensor(batch["reward"], self.dev).float()
        done = as_tensor(batch["done"], self.dev).float()
        with torch.no_grad():
            next_action = torch.argmax(
                RainbowQNetwork.apply(config, params, batch["next_obs"], key=gen), dim=-1)
            logp_target = RainbowQNetwork.apply_dist(config, tparams, batch["next_obs"],
                                                     key=gen)
            next_dist = _at_action(torch.exp(logp_target), next_action)
            proj = categorical_projection(next_dist, reward, done, gamma,
                                          support(config, next_dist.device), config.v_min,
                                          config.v_max)
        logp = RainbowQNetwork.apply_dist(config, params, batch["obs"], key=gen)
        return -torch.sum(proj * _at_action(logp, action), dim=-1)

    def _train_step(self, batch: Dict, weights: torch.Tensor, n_batch: Optional[Dict],
                    gamma: float, tau: float,
                    gen: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """One C51 update of ``actor`` and its soft target; returns (loss,
        per-sample loss), both on the device."""
        config = self.actor.config
        tparams = self.actor_target.params
        use_n_step = self.n_step > 1 and n_batch is not None

        def loss_of(p):
            elementwise = self._loss_terms(config, p, tparams, batch, gamma, gen)
            if use_n_step:
                elementwise = elementwise + self._loss_terms(
                    config, p, tparams, n_batch, gamma ** self.n_step, gen)
            return torch.mean(elementwise * weights), elementwise

        with torch.enable_grad():
            params, opt_state, loss, elementwise = grad_step(
                loss_of, self.actor.params, self.optimizer.tx, self.optimizer.opt_state)
        self.actor.params = params
        self.optimizer.opt_state = opt_state
        soft_update_(self.actor_target.params, params, tau)
        return loss, elementwise

    def learn_from_buffer(self, memory, n_step_memory=None, key: Optional[torch.Generator] = None,
                          beta: Optional[float] = None,
                          draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sample, gather the paired n-step rows at the same indices, learn
        and write PER priorities back, in one call with no host sync;
        returns the loss as a device tensor. ``draws`` stand in for the
        sample's own (PER's uniforms or the uniform indices)."""
        state, nstate, per = F.resolve_states(memory, n_step_memory)
        gen = key if key is not None else self.next_key(self.dev)
        if draws is None:
            draws = F.draw_sample(state, per, gen, self.batch_size)
        beta = self.beta if beta is None else float(beta)
        if per:
            batch, idx, weights = F.per_sample(state, draws, beta)
        else:
            batch, idx, weights = F.uniform_sample(state, draws)
        n_batch = None
        if nstate is not None:
            n_batch = F.preprocess_batch(F.gather_paired(nstate, idx), self.observation_space,
                                         self.dev)
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        loss, elementwise = self._train_step(batch, weights, n_batch, self.gamma, self.tau, gen)
        if per:
            memory.per_state = F.per_write_back(state, idx, elementwise + self.prior_eps,
                                                memory.alpha)
        return loss

    def learn(self, experiences) -> Tuple[float, Optional[Any]]:
        """``experiences``: a batch dict (uniform), ``(batch, idxs, weights)``
        (PER) or ``(batch, idxs, weights, n_batch)`` with the paired n-step
        batch. Returns ``(loss, new priorities or None)``, read on the host."""
        n_batch = idxs = None
        if isinstance(experiences, tuple):
            if len(experiences) == 4:
                batch, idxs, weights, n_batch = experiences
            else:
                batch, idxs, weights = experiences
            weights = as_tensor(weights, self.dev).float()
        else:
            batch = experiences
            weights = torch.ones_like(as_tensor(batch["reward"], self.dev).float())
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        if n_batch is not None:
            n_batch = F.preprocess_batch(n_batch, self.observation_space, self.dev)
        loss, elementwise = self._train_step(batch, weights, n_batch, self.gamma, self.tau,
                                             self.next_key(self.dev))
        new_priorities = None
        if idxs is not None:
            new_priorities = (elementwise + self.prior_eps).detach().cpu().numpy()
        return float(loss), new_priorities
