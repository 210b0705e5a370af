"""The off-policy population programs: the port of
``agilerl_tpu/parallel/off_policy.py`` (``EvoDQN``, ``EvoRainbow``,
``EvoDDPG``, ``EvoTD3``) on ``parallel/generation.ScanOffPolicy``.

Each class defines its learner (networks, targets and optimizer states,
stacked ``[P, ...]``), its acting and its learn; the engine steps, writes
the rings, gates the learns and evolves. The math is the per-agent
algorithms' (``algorithms/{dqn,dqn_rainbow,ddpg,td3}.py``): the TD targets
and projections are computed without gradient under ``torch.func.vmap``,
the losses differentiated per member with ``torch.func.grad_and_value``
under ``vmap``, and each optimizer steps once on the stacked leaves
(elementwise Adam gives each member its own step). The target cadence
(hard every ``target_every`` learns, else polyak) and the actor delay
(``policy_freq``) are host decisions on the learn count.

Every draw is made first, by the engine (``draw_iteration``): epsilon-greedy
uniforms and random actions, the exploration noise of DDPG / TD3, TD3's
smoothing normals, and Rainbow's noisy-net normals (one ``NoiseStream`` per
network apply: one for acting, three per C51 term: the online net on the
next obs, the target net on the next obs, the online net on the obs).
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch.func import grad, grad_and_value, vmap

from agilerl_tpu_torch.algorithms.core.optimizer import adam, apply_updates
from agilerl_tpu_torch.algorithms.ddpg import policy
from agilerl_tpu_torch.algorithms.dqn import select, soft_update_
from agilerl_tpu_torch.algorithms.dqn_rainbow import _at_action, categorical_projection
from agilerl_tpu_torch.algorithms.td3 import smoothed_action
from agilerl_tpu_torch.modules.base import split_key
from agilerl_tpu_torch.modules.layers import NoiseStream
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.networks.q_networks import (
    ContinuousQNetwork,
    RainbowQNetwork,
    noise_count,
    support,
)
from agilerl_tpu_torch.parallel.generation import ScanOffPolicy
from agilerl_tpu_torch.utils.spaces import preprocess_observation
from agilerl_tpu_torch.utils.tree import tree_copy


def _opt_step(tx, params, grads, opt_state):
    """One optimizer step on stacked leaves; returns (params, opt_state)."""
    with torch.no_grad():
        updates, opt_state = tx.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state


# --------------------------------------------------------------------------- #
# DQN
# --------------------------------------------------------------------------- #


class DQNLearner(NamedTuple):
    params: Any
    target: Any
    opt_state: Any


class EvoDQN(ScanOffPolicy):
    """Evolutionary DQN as one program: epsilon-greedy acting, uniform or PER
    replay, 1-step or n-step TD, the double-DQN option, polyak or hard
    target cadence."""

    _mutate_fields = ("params",)

    def __init__(self, env, net_config, tx=None, *, double: bool = False, **kwargs):
        self.net_config = net_config
        self.double = bool(double)
        super().__init__(env, tx or adam(1e-3), **kwargs)
        self.num_actions = int(env.action_space.n)

    def _action_example(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32)

    def _init_learner(self, gen: torch.Generator) -> DQNLearner:
        params = EvolvableNetwork.init_params(split_key(gen, self.device), self.net_config)
        return DQNLearner(params, tree_copy(params), self.tx.init(params))

    def _draw_act(self, T, P, gen):
        shape = (T, P, self.num_envs)
        return {"explore": torch.rand(shape, generator=gen, device=gen.device),
                "random": torch.randint(0, self.num_actions, shape, generator=gen,
                                        device=gen.device)}

    def _act_params(self, learner: DQNLearner):
        return learner.params

    def _act(self, params, obs, draws, epsilon: float):
        greedy = torch.argmax(EvolvableNetwork.apply(self.net_config, params, obs), dim=-1)
        return torch.where(draws["explore"] < epsilon, draws["random"], greedy).int()

    def _q_next(self, params, target, next_obs):
        q_next_t = EvolvableNetwork.apply(self.net_config, target, next_obs)
        if self.double:
            next_a = torch.argmax(EvolvableNetwork.apply(self.net_config, params, next_obs), -1)
            return select(q_next_t, next_a)
        return q_next_t.max(dim=-1).values

    def _loss(self, params, obs, action, target, weights):
        td = select(EvolvableNetwork.apply(self.net_config, params, obs), action) - target
        return torch.mean(weights * torch.square(td)), torch.abs(td)

    def _learn(self, learner: DQNLearner, batch, n_batch, weights, draws, learn_count: int):
        obs, reward, done, next_obs, gamma_n = self._td_fields(batch, n_batch)
        with torch.no_grad():
            q_next = vmap(self._q_next)(learner.params, learner.target, next_obs)
            target = reward + gamma_n * (1.0 - done) * q_next
        grads, (loss, td_abs) = vmap(grad_and_value(self._loss, has_aux=True))(
            learner.params, obs, batch["action"].long(), target, weights)
        params, opt_state = _opt_step(self.tx, learner.params, grads, learner.opt_state)
        self._update_target(learner.target, params, learn_count)
        return DQNLearner(params, learner.target, opt_state), loss.detach(), td_abs.detach()


# --------------------------------------------------------------------------- #
# Rainbow (C51 + double + noisy + PER + n-step)
# --------------------------------------------------------------------------- #


class EvoRainbow(ScanOffPolicy):
    """Rainbow as one program: noisy-net exploration (fresh noise per act and
    per network apply of a loss), the double-selected C51 projection, the
    1-step plus n-step per-sample loss (the n-step term bootstraps at
    ``gamma ** steps``), PER priorities from the per-sample loss."""

    _mutate_fields = ("params",)

    def __init__(self, env, net_config, tx=None, **kwargs):
        self.net_config = net_config  # a RainbowConfig
        kwargs.setdefault("per", True)
        kwargs.setdefault("n_step", 3)
        super().__init__(env, tx or adam(1e-4), **kwargs)
        self.num_actions = int(env.action_space.n)
        self.noise_count = noise_count(net_config)

    def _action_example(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int32)

    def _init_learner(self, gen: torch.Generator) -> DQNLearner:
        params = RainbowQNetwork.init_params(split_key(gen, self.device), self.net_config)
        return DQNLearner(params, tree_copy(params), self.tx.init(params))

    def _draw_act(self, T, P, gen):
        return torch.randn((T, P, self.noise_count), generator=gen, device=gen.device)

    def _draw_learn(self, T, P, gen):
        terms = 6 if self.n_step > 1 else 3
        return torch.randn((T, P, terms, self.noise_count), generator=gen, device=gen.device)

    def _act_params(self, learner: DQNLearner):
        return learner.params

    def _act(self, params, obs, draws, epsilon: float):
        q = RainbowQNetwork.apply(self.net_config, params, obs, key=NoiseStream(draws))
        return torch.argmax(q, dim=-1).int()

    def _projection(self, params, tparams, next_obs, reward, done, gamma, noise):
        """The projected target atoms of one C51 term (``noise[0]``: the
        online net on the next obs, ``noise[1]``: the target net)."""
        cfg = self.net_config
        next_action = torch.argmax(
            RainbowQNetwork.apply(cfg, params, next_obs, key=NoiseStream(noise[0])), dim=-1)
        logp_target = RainbowQNetwork.apply_dist(cfg, tparams, next_obs,
                                                 key=NoiseStream(noise[1]))
        next_dist = _at_action(torch.exp(logp_target), next_action)
        return categorical_projection(next_dist, reward, done, gamma[:, None],
                                      support(cfg, next_dist.device), cfg.v_min, cfg.v_max)

    def _loss(self, params, obs, action, projs, noises, weights):
        elementwise = 0.0
        for proj, noise in zip(projs, noises):
            logp = RainbowQNetwork.apply_dist(self.net_config, params, obs,
                                              key=NoiseStream(noise))
            elementwise = elementwise - torch.sum(proj * _at_action(logp, action), dim=-1)
        return torch.mean(elementwise * weights), elementwise

    def _learn(self, learner: DQNLearner, batch, n_batch, weights, draws, learn_count: int):
        pre = functools.partial(preprocess_observation, self.obs_space)
        obs = pre(batch["obs"])
        action = batch["action"].long()
        reward, done = batch["reward"].float(), batch["done"].float()
        terms = [(pre(batch["next_obs"]), reward, done, torch.full_like(reward, self.gamma))]
        if n_batch is not None:
            terms.append((pre(n_batch["next_obs"]), n_batch["reward"], n_batch["done"],
                          torch.pow(torch.full_like(reward, self.gamma), n_batch["steps"])))
        projs = []
        with torch.no_grad():
            for i, (next_obs, r, d, g) in enumerate(terms):
                projs.append(vmap(self._projection)(
                    learner.params, learner.target, next_obs, r, d, g,
                    draws[:, 3 * i:3 * i + 2]))
        noises = tuple(draws[:, 3 * i + 2] for i in range(len(terms)))
        grads, (loss, elementwise) = vmap(grad_and_value(self._loss, has_aux=True))(
            learner.params, obs, action, tuple(projs), noises, weights)
        params, opt_state = _opt_step(self.tx, learner.params, grads, learner.opt_state)
        self._update_target(learner.target, params, learn_count)
        return DQNLearner(params, learner.target, opt_state), loss.detach(), elementwise.detach()


# --------------------------------------------------------------------------- #
# DDPG / TD3 (continuous control)
# --------------------------------------------------------------------------- #


class DDPGLearner(NamedTuple):
    actor: Any
    actor_target: Any
    critic: Any
    critic_target: Any
    actor_opt: Any
    critic_opt: Any


class EvoDDPG(ScanOffPolicy):
    """DDPG as one program over the device continuous envs (Pendulum,
    MountainCarContinuous): a deterministic tanh actor and a Q(s, a) critic,
    Gaussian exploration noise, the actor step every ``policy_freq`` learns;
    uniform replay only (no priority output, as the per-agent learn)."""

    _mutate_fields = ("actor",)

    def __init__(self, env, actor_config, critic_config, tx_actor=None, tx_critic=None, *,
                 expl_noise: float = 0.1, policy_freq: int = 2, **kwargs):
        self.actor_config = actor_config
        self.critic_config = critic_config
        self.tx_actor = tx_actor or adam(1e-4)
        self.tx_critic = tx_critic or adam(1e-3)
        self.expl_noise = float(expl_noise)
        self.policy_freq = int(policy_freq)
        kwargs.setdefault("per", False)
        assert not kwargs["per"], (
            "EvoDDPG / EvoTD3 are uniform replay only (no priority output), as the per-agent "
            "learn")
        super().__init__(env, None, **kwargs)
        self.action_low = torch.as_tensor(env.action_space.low, dtype=torch.float32,
                                          device=self.device)
        self.action_high = torch.as_tensor(env.action_space.high, dtype=torch.float32,
                                           device=self.device)
        self.action_dim = int(self.action_low.numel())

    def _action_example(self) -> torch.Tensor:
        return torch.zeros((self.action_dim,), dtype=torch.float32)

    def _init_learner(self, gen: torch.Generator) -> DDPGLearner:
        actor = EvolvableNetwork.init_params(split_key(gen, self.device), self.actor_config)
        critic = EvolvableNetwork.init_params(split_key(gen, self.device), self.critic_config)
        return DDPGLearner(actor, tree_copy(actor), critic, tree_copy(critic),
                           self.tx_actor.init(actor), self.tx_critic.init(critic))

    def _policy(self, params, obs):
        return policy(self.actor_config, params, obs, self.action_low, self.action_high)

    def _draw_act(self, T, P, gen):
        return torch.randn((T, P, self.num_envs, self.action_dim), generator=gen,
                           device=gen.device)

    def _act_params(self, learner):
        return learner.actor

    def _act(self, params, obs, draws, epsilon: float):
        action = self._policy(params, obs)
        return torch.clamp(action + self.expl_noise * draws, self.action_low, self.action_high)

    def _q(self, critic, obs, action):
        return ContinuousQNetwork.apply(self.critic_config, critic, obs, action=action)

    def _critic_loss(self, critic, obs, action, target):
        return torch.mean(torch.square(self._q(critic, obs, action) - target))

    def _actor_loss(self, actor, critic, obs):
        return -torch.mean(self._q(critic, obs, self._policy(actor, obs)))

    def _batch_fields(self, batch, n_batch):
        obs, reward, done, next_obs, gamma_n = self._td_fields(batch, n_batch)
        return obs, batch["action"].float(), reward, done, next_obs, gamma_n

    def _actor_update(self, learner, critic, obs):
        """The actor step against ``critic`` (its leaves constants) and the
        actor target's polyak update; returns the learner."""
        grads = vmap(grad(self._actor_loss))(learner.actor, critic, obs)
        actor, a_opt = _opt_step(self.tx_actor, learner.actor, grads, learner.actor_opt)
        soft_update_(learner.actor_target, actor, self.tau)
        return learner._replace(actor=actor, actor_opt=a_opt)

    def _learn(self, learner: DDPGLearner, batch, n_batch, weights, draws, learn_count: int):
        obs, action, reward, done, next_obs, gamma_n = self._batch_fields(batch, n_batch)
        with torch.no_grad():
            q_next = vmap(lambda a, c, o: self._q(c, o, self._policy(a, o)))(
                learner.actor_target, learner.critic_target, next_obs)
            target = reward + gamma_n * (1.0 - done) * q_next
        grads, closs = vmap(grad_and_value(self._critic_loss))(learner.critic, obs, action,
                                                               target)
        critic, c_opt = _opt_step(self.tx_critic, learner.critic, grads, learner.critic_opt)
        soft_update_(learner.critic_target, critic, self.tau)
        learner = learner._replace(critic=critic, critic_opt=c_opt)
        if learn_count % self.policy_freq == 0:
            learner = self._actor_update(learner, critic, obs)
        closs = closs.detach()
        return learner, closs, torch.abs(closs)[:, None] * torch.ones_like(reward)


class TD3Learner(NamedTuple):
    actor: Any
    actor_target: Any
    critic_1: Any
    critic_1_target: Any
    critic_2: Any
    critic_2_target: Any
    actor_opt: Any
    critic_1_opt: Any
    critic_2_opt: Any


class EvoTD3(EvoDDPG):
    """TD3 as one program: twin critics, target policy smoothing (its
    normals drawn first), the actor step and every target update on the
    ``policy_freq`` cadence."""

    _mutate_fields = ("actor",)

    def __init__(self, env, actor_config, critic_config, *args, policy_noise: float = 0.2,
                 noise_clip: float = 0.5, **kwargs):
        self.policy_noise = float(policy_noise)
        self.noise_clip = float(noise_clip)
        super().__init__(env, actor_config, critic_config, *args, **kwargs)

    def _init_learner(self, gen: torch.Generator) -> TD3Learner:
        dev = self.device
        actor = EvolvableNetwork.init_params(split_key(gen, dev), self.actor_config)
        c1 = EvolvableNetwork.init_params(split_key(gen, dev), self.critic_config)
        c2 = EvolvableNetwork.init_params(split_key(gen, dev), self.critic_config)
        return TD3Learner(actor, tree_copy(actor), c1, tree_copy(c1), c2, tree_copy(c2),
                          self.tx_actor.init(actor), self.tx_critic.init(c1),
                          self.tx_critic.init(c2))

    def _draw_learn(self, T, P, gen):
        return torch.randn((T, P, self.batch_size, self.action_dim), generator=gen,
                           device=gen.device)

    def _target(self, actor_t, c1t, c2t, next_obs, normal):
        next_action = smoothed_action(self._policy(actor_t, next_obs), normal, self.policy_noise,
                                      self.noise_clip, self.action_low, self.action_high)
        return torch.minimum(self._q(c1t, next_obs, next_action),
                             self._q(c2t, next_obs, next_action))

    def _learn(self, learner: TD3Learner, batch, n_batch, weights, draws, learn_count: int):
        obs, action, reward, done, next_obs, gamma_n = self._batch_fields(batch, n_batch)
        do_actor = learn_count % self.policy_freq == 0
        with torch.no_grad():
            q_next = vmap(self._target)(learner.actor_target, learner.critic_1_target,
                                        learner.critic_2_target, next_obs, draws)
            target = reward + gamma_n * (1.0 - done) * q_next
        loss_grad = vmap(grad_and_value(self._critic_loss))
        g1, l1 = loss_grad(learner.critic_1, obs, action, target)
        g2, l2 = loss_grad(learner.critic_2, obs, action, target)
        c1, o1 = _opt_step(self.tx_critic, learner.critic_1, g1, learner.critic_1_opt)
        c2, o2 = _opt_step(self.tx_critic, learner.critic_2, g2, learner.critic_2_opt)
        if do_actor:
            # TD3 delays every target update to the policy cadence
            soft_update_(learner.critic_1_target, c1, self.tau)
            soft_update_(learner.critic_2_target, c2, self.tau)
        learner = learner._replace(critic_1=c1, critic_1_opt=o1, critic_2=c2, critic_2_opt=o2)
        if do_actor:
            learner = self._actor_update(learner, c1, obs)
        closs = (l1 + l2).detach()
        return learner, closs, torch.abs(closs)[:, None] * torch.ones_like(reward)
