"""MATD3: the port of ``agilerl_tpu/algorithms/matd3.py`` (MADDPG with twin
centralised critics and the clipped double-Q target, target policy
smoothing, and the actor step and every target update delayed to the
``policy_freq`` cadence).

The smoothing normals are drawn first, one ``[B, dim]`` tensor per
continuous agent, from the agent's generator (``draw_smoothing``); the
twin step (``twin_train_step``) takes them as an argument, so the tests
feed in the JAX package's. The JAX step's ``lax.cond`` on the policy gate
becomes a host decision on ``_learn_counter``: off the cadence neither the
actors nor any target moves (the JAX soft update at ``tau = 0``). The
returned loss is the sum of both critics' losses over the agents, as in the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import NetworkGroup, OptimizerConfig
from agilerl_tpu_torch.algorithms.dqn import soft_update_
from agilerl_tpu_torch.algorithms.maddpg import MADDPG
from agilerl_tpu_torch.networks.base import EvolvableNetwork


class MATD3(MADDPG):
    def __init__(self, observation_spaces, action_spaces, policy_noise: float = 0.2,
                 noise_clip: float = 0.5, policy_freq: int = 2, **kwargs):
        self.policy_noise = float(policy_noise)
        self.noise_clip = float(noise_clip)
        self.policy_freq = int(policy_freq)
        self._learn_counter = 0
        super().__init__(observation_spaces, action_spaces, **kwargs)
        critic_space = self.critic_space()
        per_critic_cfg = self.build_critic_config(critic_space, self.net_config)
        self.critic_2s = {aid: EvolvableNetwork(critic_space, num_outputs=1, key=self.next_key(),
                                                device=self.dev, **per_critic_cfg[aid])
                          for aid in self.agent_ids}
        self.critic_2_targets = {a: self.critic_2s[a].clone() for a in self.agent_ids}
        self.critic_2_optimizers = OptimizerWrapper(optimizer="adam", lr=self.lr_critic)
        self.register_network_group(NetworkGroup(eval="critic_2s", shared="critic_2_targets",
                                                 multiagent=True))
        self.register_optimizer(OptimizerConfig(name="critic_2_optimizers",
                                                networks=["critic_2s"], lr="lr_critic"))
        self.critic_2_optimizers.init(self._params(self.critic_2s))

    @property
    def init_dict(self) -> Dict[str, Any]:
        return dict(super().init_dict, policy_noise=self.policy_noise,
                    noise_clip=self.noise_clip, policy_freq=self.policy_freq)

    def evolvable_attributes(self) -> Dict[str, Any]:
        return dict(super().evolvable_attributes(), critic_2s=self.critic_2s,
                    critic_2_targets=self.critic_2_targets)

    def draw_smoothing(self, batch: int, gen: Optional[torch.Generator] = None
                       ) -> Dict[str, torch.Tensor]:
        """The standard normals of one learn's target smoothing: ``[B, dim]``
        per continuous agent (a discrete target action is not smoothed)."""
        gen = gen if gen is not None else self.next_key(self.dev)
        return {a: torch.randn((batch, self.action_dims[a]), generator=gen, device=gen.device)
                for a in self.agent_ids if not self.discrete[a]}

    def twin_train_step(self, batch: Dict, normals: Dict[str, torch.Tensor],
                        update_actor: bool) -> torch.Tensor:
        """One learn on a prepared batch and the smoothing ``normals``: both
        critics' steps on the clipped double-Q target, then, when
        ``update_actor``, the actor step against the updated first critics
        and every soft target update. Returns the summed critic loss as a
        device tensor."""
        ids = self.agent_ids
        actors, actor_ts = self._params(self.actors), self._params(self.actor_targets)
        c1s, c1ts = self._params(self.critics), self._params(self.critic_targets)
        c2s, c2ts = self._params(self.critic_2s), self._params(self.critic_2_targets)
        c1_cfgs = {a: self.critics[a].config for a in ids}
        c2_cfgs = {a: self.critic_2s[a].config for a in ids}
        all_obs, enc = self._flat(batch["obs"]), self._encode_all(batch["action"])
        with torch.no_grad():
            acts = []
            for a in ids:
                act = self.actor_out(a, actor_ts[a], batch["next_obs"][a])
                if not self.discrete[a]:
                    noise = torch.clamp(self.policy_noise * normals[a], -self.noise_clip,
                                        self.noise_clip)
                    act = torch.clamp(act + noise, self._low[a], self._high[a])
                acts.append(act)
            next_in = torch.cat([self._flat(batch["next_obs"])] + acts, dim=-1)
            q_next = {a: torch.minimum(
                EvolvableNetwork.apply(c1_cfgs[a], c1ts[a], next_in)[..., 0],
                EvolvableNetwork.apply(c2_cfgs[a], c2ts[a], next_in)[..., 0]) for a in ids}
            targets = {a: batch["reward"][a] + self.gamma * (1.0 - batch["done"][a]) * q_next[a]
                       for a in ids}
        q_in = torch.cat([all_obs] + [enc[a] for a in ids], dim=-1)
        with torch.enable_grad():
            c1s, c1_opt, l1, _ = grad_step(self._critic_loss_fn(c1_cfgs, q_in, targets), c1s,
                                           self.critic_optimizers.tx,
                                           self.critic_optimizers.opt_state)
            c2s, c2_opt, l2, _ = grad_step(self._critic_loss_fn(c2_cfgs, q_in, targets), c2s,
                                           self.critic_2_optimizers.tx,
                                           self.critic_2_optimizers.opt_state)
        if update_actor:
            actors, a_opt = self._actor_step(actors, c1s, c1_cfgs, batch, all_obs, enc)
            self.actor_optimizers.opt_state = a_opt
            soft_update_({"a": actor_ts, "c1": c1ts, "c2": c2ts},
                         {"a": actors, "c1": c1s, "c2": c2s}, self.tau)
        for a in ids:
            self.actors[a].params, self.critics[a].params = actors[a], c1s[a]
            self.critic_2s[a].params = c2s[a]
        self.critic_optimizers.opt_state, self.critic_2_optimizers.opt_state = c1_opt, c2_opt
        return l1 + l2

    def train_step(self, batch: Dict) -> torch.Tensor:
        self._learn_counter += 1
        batch_size = batch["reward"][self.agent_ids[0]].shape[0]
        return self.twin_train_step(batch, self.draw_smoothing(batch_size),
                                    self._learn_counter % self.policy_freq == 0)
