"""TD3: the port of ``agilerl_tpu/algorithms/td3.py`` (DDPG with twin
critics and clipped double-Q targets, target policy smoothing, and the actor
step and every target update delayed to the ``policy_freq`` cadence).

The smoothing noise ``clip(policy_noise * N(0, 1), -noise_clip,
noise_clip)`` is drawn first, from the agent's generator (after the sample's
indices in ``learn_from_buffer``), and ``twin_critic_step`` takes the
standard-normal draws as an argument, so the tests feed in the JAX
package's. The cadence is a host counter; off the cadence the targets are
left as they are (the JAX step's soft update at ``tau = 0``). ``learn``
takes a PER tuple as ``DDPG.learn`` does (a deviation: the JAX one fails
on it).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import NetworkGroup, OptimizerConfig
from agilerl_tpu_torch.algorithms.ddpg import DDPG, policy, td_fields, weighted_mse
from agilerl_tpu_torch.algorithms.dqn import soft_update_
from agilerl_tpu_torch.networks.q_networks import ContinuousQNetwork


def smoothed_action(next_action: torch.Tensor, normal: torch.Tensor, policy_noise: float,
                    noise_clip: float, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Target policy smoothing on standard-normal draws ``normal``."""
    noise = torch.clamp(policy_noise * normal, -noise_clip, noise_clip)
    return torch.clamp(next_action + noise, low, high)


def twin_critic_step(a_cfg, c1_cfg, c2_cfg, low, high, c1: Dict, c1t: Dict, c2: Dict,
                     c2t: Dict, at_params: Dict, tx1, opt1, tx2, opt2, batch: Dict,
                     gamma: float, tau: float, normal: torch.Tensor, update_targets: bool,
                     policy_noise: float, noise_clip: float,
                     weights: Optional[torch.Tensor] = None):
    """Both critics' TD steps on the clipped double-Q target of the smoothed
    target action; the targets move (in place) only when ``update_targets``.
    Returns (c1, opt1, c2, opt2, summed loss)."""
    obs, action, reward, done, next_obs = td_fields(batch, low.device)
    with torch.no_grad():
        next_action = smoothed_action(policy(a_cfg, at_params, next_obs, low, high), normal,
                                      policy_noise, noise_clip, low, high)
        q_next = torch.minimum(
            ContinuousQNetwork.apply(c1_cfg, c1t, next_obs, action=next_action),
            ContinuousQNetwork.apply(c2_cfg, c2t, next_obs, action=next_action))
        target = reward + gamma * (1.0 - done) * q_next

    def loss_fn(cfg):
        def loss_of(p):
            q = ContinuousQNetwork.apply(cfg, p, obs, action=action)
            return weighted_mse(q - target, weights), None
        return loss_of

    with torch.enable_grad():
        c1, opt1, l1, _ = grad_step(loss_fn(c1_cfg), c1, tx1, opt1)
        c2, opt2, l2, _ = grad_step(loss_fn(c2_cfg), c2, tx2, opt2)
    if update_targets:
        soft_update_(c1t, c1, tau)
        soft_update_(c2t, c2, tau)
    return c1, opt1, c2, opt2, l1 + l2


class TD3(DDPG):
    def __init__(self, observation_space, action_space, policy_noise: float = 0.2,
                 noise_clip: float = 0.5, **kwargs):
        self.policy_noise = float(policy_noise)
        self.noise_clip = float(noise_clip)
        super().__init__(observation_space, action_space, **kwargs)
        # the twin critic, on top of DDPG's single critic
        self.critic_2 = ContinuousQNetwork(observation_space, action_space, key=self.next_key(),
                                           device=self.dev, **self.net_config)
        self.critic_2_target = self.critic_2.clone()
        self.critic_2_optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr_critic)
        self.register_network_group(NetworkGroup(eval="critic_2", shared="critic_2_target"))
        self.register_optimizer(OptimizerConfig(name="critic_2_optimizer", networks=["critic_2"],
                                                lr="lr_critic"))
        self.critic_2_optimizer.init(self.critic_2.params)

    @property
    def init_dict(self) -> Dict[str, Any]:
        return dict(super().init_dict, policy_noise=self.policy_noise,
                    noise_clip=self.noise_clip)

    def _critic_update(self, batch: Dict, weights: Optional[torch.Tensor],
                       gen: Optional[torch.Generator], update_targets: bool) -> torch.Tensor:
        normal = torch.randn((batch["reward"].shape[0],) + tuple(self.actor.action_low.shape),
                             generator=gen, device=self.dev)
        return self._twin_update(batch, weights, normal, update_targets)

    def _twin_update(self, batch: Dict, weights: Optional[torch.Tensor], normal: torch.Tensor,
                     update_targets: bool) -> torch.Tensor:
        c1, opt1, c2, opt2, loss = twin_critic_step(
            self.actor.config, self.critic.config, self.critic_2.config, self.actor.action_low,
            self.actor.action_high, self.critic.params, self.critic_target.params,
            self.critic_2.params, self.critic_2_target.params, self.actor_target.params,
            self.critic_optimizer.tx, self.critic_optimizer.opt_state,
            self.critic_2_optimizer.tx, self.critic_2_optimizer.opt_state, batch, self.gamma,
            self.tau, normal, update_targets, self.policy_noise, self.noise_clip, weights)
        self.critic.params, self.critic_optimizer.opt_state = c1, opt1
        self.critic_2.params, self.critic_2_optimizer.opt_state = c2, opt2
        return loss
