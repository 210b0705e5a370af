"""DDPG: the port of ``agilerl_tpu/algorithms/ddpg.py`` (a deterministic
tanh actor and a Q(s, a) critic, each with a soft-updated target; OU or
Gaussian exploration noise; the actor step delayed by ``policy_freq``).

A learn is the critic's TD step (its target from the target actor and the
target critic, then the loss, its gradient, Adam and the soft target update
as one ``torch._foreach_lerp_``), then, every ``policy_freq``-th learn, the
actor's step: the gradient of ``-mean Q(s, pi(s))`` with respect to the
actor's parameters only, through the critic just updated, whose parameters
are constants there (no gradient reaches or accumulates in its leaves).
The cadence is a host counter, so no learn syncs the device.
``learn_from_buffer`` samples uniformly (its indices drawn first, from the
agent's generator, or given as ``draws``), learns and returns the critic
loss as a device tensor; under PER it raises, as the JAX one does.

The OU state is a device tensor and every noise draw comes from the agent's
generator: ``get_action`` keeps its action on the device and makes no host
read. The pure cores (``critic_step``, ``actor_step``, ``ou_noise_step``)
take their draws as arguments, so the tests feed in the JAX package's.

One deviation from the JAX package: ``learn`` takes a PER tuple
``(batch, idxs, weights[, n_batch])``, as the training loop's sampled path
passes it, and learns on its batch with the critic's squared errors
weighted; it returns no priorities (DDPG's learn has no priority output).
The JAX ``learn`` fails on the tuple (``dict()`` of a 3-tuple).
"""

from __future__ import annotations

import math
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
from agilerl_tpu_torch.algorithms.dqn import batched_obs, soft_update_
from agilerl_tpu_torch.networks.actors import DeterministicActor
from agilerl_tpu_torch.networks.q_networks import ContinuousQNetwork
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_map


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr_actor=RLParameter(min=1e-5, max=1e-2, dtype=float),
        lr_critic=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=8, max=512, dtype=int),
        learn_step=RLParameter(min=1, max=16, dtype=int),
    )


def ou_noise_step(state: torch.Tensor, normal: torch.Tensor, theta: float, mean_noise: float,
                  expl_noise: float, dt: float) -> torch.Tensor:
    """One Ornstein-Uhlenbeck step on standard-normal draws ``normal``."""
    return state + theta * (mean_noise - state) * dt + expl_noise * math.sqrt(dt) * normal


def policy(config, params: Dict, obs: Any, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """The deterministic actor's action on the Box range."""
    return DeterministicActor.rescale(DeterministicActor.apply(config, params, obs), low, high)


def td_fields(batch: Dict, device) -> tuple:
    """(obs, action f32, reward f32, done f32, next_obs) of a preprocessed batch."""
    return (batch["obs"], as_tensor(batch["action"], device).float(),
            as_tensor(batch["reward"], device).float(),
            as_tensor(batch["done"], device).float(), batch["next_obs"])


def weighted_mse(err: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.mean(torch.square(err) if weights is None else weights * torch.square(err))


def critic_step(a_cfg, c_cfg, low, high, cparams: Dict, ct_params: Dict, at_params: Dict, tx,
                opt_state, batch: Dict, gamma: float, tau: float,
                weights: Optional[torch.Tensor] = None):
    """The critic's TD step and its soft target update (``ct_params`` in
    place); returns (critic params, optimizer state, loss)."""
    obs, action, reward, done, next_obs = td_fields(batch, low.device)
    with torch.no_grad():
        q_next = ContinuousQNetwork.apply(c_cfg, ct_params, next_obs,
                                          action=policy(a_cfg, at_params, next_obs, low, high))
        target = reward + gamma * (1.0 - done) * q_next

    def loss_of(p):
        q = ContinuousQNetwork.apply(c_cfg, p, obs, action=action)
        return weighted_mse(q - target, weights), None

    with torch.enable_grad():
        cparams, opt_state, loss, _ = grad_step(loss_of, cparams, tx, opt_state)
    soft_update_(ct_params, cparams, tau)
    return cparams, opt_state, loss


def actor_step(a_cfg, c_cfg, low, high, aparams: Dict, at_params: Dict, cparams: Dict, tx,
               opt_state, obs: Any, tau: float):
    """The actor's step on ``-mean Q(s, pi(s))``, differentiated into the
    actor's leaves only (the critic's are detached constants), and its soft
    target update (``at_params`` in place); returns (actor params, optimizer
    state, loss)."""
    critic = tree_map(torch.Tensor.detach, cparams)

    def loss_of(p):
        q = ContinuousQNetwork.apply(c_cfg, critic, obs,
                                     action=policy(a_cfg, p, obs, low, high))
        return -torch.mean(q), None

    with torch.enable_grad():
        aparams, opt_state, loss, _ = grad_step(loss_of, aparams, tx, opt_state)
    soft_update_(at_params, aparams, tau)
    return aparams, opt_state, loss


class DDPG(RLAlgorithm):
    supports_activation_mutation = False
    #: learn_from_buffer is uniform replay only (learn has no priority
    #: output): under PER the training loop takes the sampled path
    supports_fused_per = False

    def __init__(
        self,
        observation_space,
        action_space,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        net_config: Optional[Dict[str, Any]] = None,
        batch_size: int = 64,
        lr_actor: float = 1e-4,
        lr_critic: float = 1e-3,
        learn_step: int = 5,
        gamma: float = 0.99,
        tau: float = 1e-3,
        policy_freq: int = 2,
        O_U_noise: bool = True,
        expl_noise: float = 0.1,
        mean_noise: float = 0.0,
        theta: float = 0.15,
        dt: float = 1e-2,
        device=None,
        **kwargs,
    ):
        super().__init__(observation_space, action_space, index=index,
                         hp_config=hp_config or default_hp_config(), device=device, **kwargs)
        self.batch_size = int(batch_size)
        self.lr_actor = float(lr_actor)
        self.lr_critic = float(lr_critic)
        self.learn_step = int(learn_step)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.policy_freq = int(policy_freq)
        self.O_U_noise = bool(O_U_noise)
        self.expl_noise = float(expl_noise)
        self.mean_noise = float(mean_noise)
        self.theta = float(theta)
        self.dt = float(dt)
        self.net_config = dict(net_config or {})
        self._learn_counter = 0
        self._ou_state: Optional[torch.Tensor] = None

        self.actor = DeterministicActor(observation_space, action_space, key=self.next_key(),
                                        device=self.dev, **self.net_config)
        self.actor_target = self.actor.clone()
        self.critic = ContinuousQNetwork(observation_space, action_space, key=self.next_key(),
                                         device=self.dev, **self.net_config)
        self.critic_target = self.critic.clone()
        self.actor_optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr_actor)
        self.critic_optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr_critic)
        self.register_network_group(NetworkGroup(eval="actor", shared="actor_target",
                                                 policy=True))
        self.register_network_group(NetworkGroup(eval="critic", shared="critic_target"))
        self.register_optimizer(OptimizerConfig(name="actor_optimizer", networks=["actor"],
                                                lr="lr_actor"))
        self.register_optimizer(OptimizerConfig(name="critic_optimizer", networks=["critic"],
                                                lr="lr_critic"))
        self.finalize_registry()

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "observation_space": self.observation_space,
            "action_space": self.action_space,
            "index": self.index,
            "net_config": self.net_config,
            "batch_size": self.batch_size,
            "lr_actor": self.lr_actor,
            "lr_critic": self.lr_critic,
            "learn_step": self.learn_step,
            "gamma": self.gamma,
            "tau": self.tau,
            "policy_freq": self.policy_freq,
            "O_U_noise": self.O_U_noise,
            "expl_noise": self.expl_noise,
            "mean_noise": self.mean_noise,
            "theta": self.theta,
            "dt": self.dt,
            "device": self.dev,
        }

    # ------------------------------------------------------------------ #
    def action_noise(self, shape, gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """OU or Gaussian exploration noise of ``shape`` on the agent's
        device, its normal draws from ``gen`` (the agent's stream when None)."""
        gen = gen if gen is not None else self.next_key(self.dev)
        normal = torch.randn(tuple(shape), generator=gen, device=self.dev)
        if self.O_U_noise:
            if self._ou_state is None or tuple(self._ou_state.shape) != tuple(shape):
                self._ou_state = torch.zeros(tuple(shape), device=self.dev)
            self._ou_state = ou_noise_step(self._ou_state, normal, self.theta, self.mean_noise,
                                           self.expl_noise, self.dt)
            return self._ou_state
        return self.mean_noise + self.expl_noise * normal

    @torch.no_grad()
    def get_action(self, obs: Any, training: bool = True, **kwargs) -> torch.Tensor:
        """The actor's action plus exploration noise when ``training``,
        clipped to the action space, on the device (no host read); an
        unbatched observation gives one action. ``epsilon`` / ``action_mask``
        from the training loop are taken and ignored."""
        obs, _, single = batched_obs(self, obs)
        low, high = self.actor.action_low, self.actor.action_high
        action = policy(self.actor.config, self.actor.params, obs, low, high)
        if training:
            action = action + self.action_noise(action.shape)
        action = torch.clamp(action, low, high)
        return action[0] if single else action

    # ------------------------------------------------------------------ #
    def _critic_update(self, batch: Dict, weights: Optional[torch.Tensor],
                       gen: Optional[torch.Generator], update_targets: bool) -> torch.Tensor:
        cparams, opt_state, loss = critic_step(
            self.actor.config, self.critic.config, self.actor.action_low, self.actor.action_high,
            self.critic.params, self.critic_target.params, self.actor_target.params,
            self.critic_optimizer.tx, self.critic_optimizer.opt_state, batch, self.gamma,
            self.tau, weights)
        self.critic.params = cparams
        self.critic_optimizer.opt_state = opt_state
        return loss

    def _actor_update(self, batch: Dict) -> None:
        aparams, opt_state, _ = actor_step(
            self.actor.config, self.critic.config, self.actor.action_low, self.actor.action_high,
            self.actor.params, self.actor_target.params, self.critic.params,
            self.actor_optimizer.tx, self.actor_optimizer.opt_state, batch["obs"], self.tau)
        self.actor.params = aparams
        self.actor_optimizer.opt_state = opt_state

    def _update(self, batch: Dict, weights: Optional[torch.Tensor],
                gen: Optional[torch.Generator]) -> torch.Tensor:
        """One learn on a preprocessed batch: the critic step, then the
        actor step on the ``policy_freq`` cadence (a host counter)."""
        self._learn_counter += 1
        do_actor = self._learn_counter % self.policy_freq == 0
        loss = self._critic_update(batch, weights, gen, do_actor)
        if do_actor:
            self._actor_update(batch)
        return loss

    def learn_from_buffer(self, memory, n_step_memory=None, key: Optional[torch.Generator] = None,
                          beta: Optional[float] = None,
                          draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Uniform sample and learn in one call with no host sync; returns
        the critic loss as a device tensor. ``draws`` (the ring indices,
        ``[batch_size]``) stand in for the ones the agent's generator (or
        ``key``) makes. Raises under PER (no priority output to write back)."""
        state, _, per = F.resolve_states(memory, n_step_memory)
        if per:
            raise NotImplementedError(
                f"{type(self).__name__}.learn_from_buffer supports uniform replay only (no "
                "priority output to write back)")
        gen = key if key is not None else self.next_key(self.dev)
        if draws is None:
            draws = F.draw_sample(state, False, gen, self.batch_size)
        batch, _, _ = F.uniform_sample(state, draws)
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        return self._update(batch, None, gen)

    def learn(self, experiences) -> float:
        """One learn on a sampled batch (a dict, or a PER tuple: its batch,
        the critic's errors weighted). Reads the critic loss on the host."""
        batch, weights = experiences, None
        if isinstance(experiences, tuple):  # (batch, idxs, weights[, n_batch])
            batch, weights = experiences[0], as_tensor(experiences[2], self.dev).float()
        batch = F.preprocess_batch(batch, self.observation_space, self.dev)
        return float(self._update(batch, weights, self.next_key(self.dev)))
