"""MADDPG: the port of ``agilerl_tpu/algorithms/maddpg.py`` (a deterministic
actor per agent, a centralised critic per agent over every agent's
observation and action, each with a soft-updated target; Gumbel-softmax
exploration for discrete agents, scaled Gaussian noise for continuous ones).

The centralised critic's input is every agent's flattened observation,
then every agent's action (one-hot for a discrete agent), in agent order
(``flatten_ma_obs``, ``encode_ma_action``). A learn is the JAX package's
train step (``train_step``):

- the critic step for every agent, its TD target from the target actors
  and the target critic, as one backward over the summed losses and one
  Adam update over all critics (one optimizer state spans them);
- then the actor step for every agent, against the critics just updated,
  whose parameters are constants there (no gradient reaches or accumulates
  in their leaves); the other agents' actions come from the batch. A
  continuous actor's loss is ``-mean Q`` at its rescaled action; a discrete
  actor's is the expected Q over its one-hot vertices under its softmax,
  the Q values detached (the critic is only trained at the vertices), the
  vertices' Q values batched into one critic call;
- both take ``action_reg * mean(raw ** 2)`` and one Adam update over all
  actors; the targets move by one ``torch._foreach_lerp_``.

``learn`` reads the mean critic loss on the host (the JAX ``learn`` returns
a float): one sync per learn. ``get_action`` draws its exploration noise
first (Gumbel uniforms or normals, from the agent's generator) and keeps
its actions on the device with no host read; action masks from a
PettingZoo info dict are honoured and env-defined actions override the
policy's (``utils/utils.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from agilerl_tpu_torch.algorithms.core.base import MultiAgentRLAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.algorithms.dqn import soft_update_
from agilerl_tpu_torch.modules.custom_components import gumbel_softmax, gumbel_uniforms
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.utils.spaces import (
    Box,
    action_dim,
    as_tensor,
    obs_dim,
    preprocess_observation,
    space_kind,
)
from agilerl_tpu_torch.utils.tree import tree_map

__all__ = ["MADDPG", "default_hp_config", "encode_ma_action", "flatten_ma_obs",
           "gumbel_softmax"]


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr_actor=RLParameter(min=1e-5, max=1e-2, dtype=float),
        lr_critic=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=8, max=512, dtype=int),
        learn_step=RLParameter(min=1, max=16, dtype=int),
    )


def flatten_ma_obs(obs_spaces, agent_ids, obs, device=None) -> torch.Tensor:
    """The centralised critic's observation input: each agent's
    preprocessed observation flattened, concatenated in agent order."""
    outs = []
    for aid in agent_ids:
        o = preprocess_observation(obs_spaces[aid], obs[aid], device)
        outs.append(o.reshape(o.shape[0], -1))
    return torch.cat(outs, dim=-1)


def encode_ma_action(discrete, action_dims, aid, a: torch.Tensor) -> torch.Tensor:
    """The centralised critic's action input of one agent: one-hot for a
    discrete agent, a flat float vector otherwise."""
    if discrete[aid]:
        return F.one_hot(a.long(), action_dims[aid]).float()
    return a.float().reshape(a.shape[0], -1)


def _rescale(raw: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    return low + (raw + 1.0) * 0.5 * (high - low)


class MADDPG(MultiAgentRLAlgorithm):
    supports_activation_mutation = False

    def __init__(
        self,
        observation_spaces,
        action_spaces,
        agent_ids: Optional[List[str]] = None,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        net_config: Optional[Dict[str, Any]] = None,
        batch_size: int = 64,
        lr_actor: float = 1e-4,
        lr_critic: float = 1e-3,
        learn_step: int = 5,
        gamma: float = 0.95,
        tau: float = 1e-2,
        expl_noise: float = 0.1,
        action_reg: float = 1e-3,
        device=None,
        **kwargs,
    ):
        super().__init__(observation_spaces, action_spaces, agent_ids=agent_ids, index=index,
                         hp_config=hp_config or default_hp_config(), device=device, **kwargs)
        self.batch_size = int(batch_size)
        self.lr_actor = float(lr_actor)
        self.lr_critic = float(lr_critic)
        self.learn_step = int(learn_step)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.expl_noise = float(expl_noise)
        self.action_reg = float(action_reg)
        self.net_config = dict(net_config or {})

        self.discrete = {aid: space_kind(self.action_spaces[aid]) == "discrete"
                         for aid in self.agent_ids}
        self.action_dims = {aid: action_dim(self.action_spaces[aid]) for aid in self.agent_ids}
        self._low, self._high = {}, {}
        for aid in self.agent_ids:
            if not self.discrete[aid]:
                sp = self.action_spaces[aid]
                self._low[aid] = torch.as_tensor(sp.low, dtype=torch.float32, device=self.dev)
                self._high[aid] = torch.as_tensor(sp.high, dtype=torch.float32, device=self.dev)
        critic_space = self.critic_space()

        per_agent_cfg = self.build_net_config(self.net_config)
        per_critic_cfg = self.build_critic_config(critic_space, self.net_config)
        self.actors: Dict[str, EvolvableNetwork] = {}
        self.critics: Dict[str, EvolvableNetwork] = {}
        for aid in self.agent_ids:
            a_cfg = per_agent_cfg[aid]
            head_cfg = dict(a_cfg.get("head_config", {}))
            if not self.discrete[aid]:
                head_cfg["output_activation"] = "Tanh"
            self.actors[aid] = EvolvableNetwork(
                self.observation_spaces[aid], num_outputs=self.action_dims[aid],
                key=self.next_key(), device=self.dev, **{**a_cfg, "head_config": head_cfg})
            self.critics[aid] = EvolvableNetwork(critic_space, num_outputs=1, key=self.next_key(),
                                                 device=self.dev, **per_critic_cfg[aid])
        self.actor_targets = {aid: self.actors[aid].clone() for aid in self.agent_ids}
        self.critic_targets = {aid: self.critics[aid].clone() for aid in self.agent_ids}

        self.actor_optimizers = OptimizerWrapper(optimizer="adam", lr=self.lr_actor)
        self.critic_optimizers = OptimizerWrapper(optimizer="adam", lr=self.lr_critic)
        self.register_network_group(NetworkGroup(eval="actors", shared="actor_targets",
                                                 policy=True, multiagent=True))
        self.register_network_group(NetworkGroup(eval="critics", shared="critic_targets",
                                                 multiagent=True))
        self.register_optimizer(OptimizerConfig(name="actor_optimizers", networks=["actors"],
                                                lr="lr_actor"))
        self.register_optimizer(OptimizerConfig(name="critic_optimizers", networks=["critics"],
                                                lr="lr_critic"))
        self.finalize_registry()

    def critic_space(self) -> Box:
        """The centralised critics' input space: every observation, then every
        action, flattened."""
        total = sum(obs_dim(self.observation_spaces[a]) for a in self.agent_ids)
        return Box(-np.inf, np.inf, (total + sum(self.action_dims.values()),), np.float32)

    # ------------------------------------------------------------------ #
    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "observation_spaces": self.observation_spaces,
            "action_spaces": self.action_spaces,
            "agent_ids": self.agent_ids,
            "index": self.index,
            "net_config": self.net_config,
            "batch_size": self.batch_size,
            "lr_actor": self.lr_actor,
            "lr_critic": self.lr_critic,
            "learn_step": self.learn_step,
            "gamma": self.gamma,
            "tau": self.tau,
            "expl_noise": self.expl_noise,
            "action_reg": self.action_reg,
            "device": self.dev,
        }

    def evolvable_attributes(self) -> Dict[str, Any]:
        return {"actors": self.actors, "actor_targets": self.actor_targets,
                "critics": self.critics, "critic_targets": self.critic_targets}

    def _params(self, nets: Dict[str, EvolvableNetwork]) -> Dict[str, Dict]:
        return {a: nets[a].params for a in self.agent_ids}

    # -- acting ---------------------------------------------------------- #
    def draw_action_noise(self, batch: int, gen: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
        """Every exploration draw of one ``get_action`` on ``batch`` rows, per
        agent in order: Gumbel uniforms ``[B, n]`` of a discrete agent,
        standard normals ``[B, dim]`` of a continuous one."""
        gen = gen if gen is not None else self.next_key(self.dev)
        out = {}
        for aid in self.agent_ids:
            shape = (batch, self.action_dims[aid])
            out[aid] = (gumbel_uniforms(shape, gen) if self.discrete[aid]
                        else torch.randn(shape, generator=gen, device=gen.device))
        return out

    def act(self, actor_params: Dict, obs: Dict, draws: Optional[Dict], noise_scale: float,
            masks: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """The actions of preprocessed ``[B, ...]`` observations: a Gumbel
        pick (greedy when ``noise_scale`` is 0) for a discrete agent, masked
        actions at -1e9; the rescaled action plus ``noise_scale * normal *
        (high - low) / 2``, clipped, for a continuous one."""
        out = {}
        for aid in self.agent_ids:
            raw = EvolvableNetwork.apply(self.actors[aid].config, actor_params[aid], obs[aid])
            if self.discrete[aid]:
                mask = masks.get(aid) if masks is not None else None
                if mask is not None:
                    raw = torch.where(mask.bool(), raw, torch.full_like(raw, -1e9))
                out[aid] = torch.argmax(gumbel_softmax(raw, draws[aid]) if noise_scale > 0
                                        else raw, dim=-1)
            else:
                low, high = self._low[aid], self._high[aid]
                a = _rescale(raw, low, high)
                if noise_scale > 0:
                    a = a + noise_scale * draws[aid] * (high - low) * 0.5
                out[aid] = torch.clamp(a, low, high)
        return out

    @torch.no_grad()
    def get_action(self, obs: Dict[str, Any], training: bool = True,
                   infos: Optional[Dict[str, Any]] = None, **kw) -> Dict[str, torch.Tensor]:
        """Per-agent actions on the device, with exploration when
        ``training``; an unbatched observation gives unbatched actions.
        ``infos`` (a PettingZoo info dict) may carry per-agent
        "action_mask" and "env_defined_action"."""
        from agilerl_tpu_torch.utils.utils import apply_env_defined_actions, process_ma_infos

        pre, single = self.batched_observation(obs)
        batch = pre[self.agent_ids[0]].shape[0]
        masks, eda = process_ma_infos(infos, self.agent_ids, self.dev)
        noise = self.expl_noise if training else 0.0
        draws = self.draw_action_noise(batch) if noise > 0 else None
        out = self.act(self._params(self.actors), pre, draws, noise, masks)
        # off-policy: the buffer holds the executed action
        out = apply_env_defined_actions(eda, out)
        if single:
            out = {a: v[0] for a, v in out.items()}
        return out

    @torch.no_grad()
    def critic_values(self, obs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """Each agent's centralised critic at batched ``obs`` and the
        current greedy actions, as host arrays (the probes' surface)."""
        acts = self.get_action(obs, training=False)
        q_in = torch.cat([flatten_ma_obs(self.observation_spaces, self.agent_ids, obs, self.dev)]
                         + [encode_ma_action(self.discrete, self.action_dims, aid, acts[aid])
                            for aid in self.agent_ids], dim=-1)
        return {aid: EvolvableNetwork.apply(self.critics[aid].config, self.critics[aid].params,
                                            q_in)[..., 0].cpu().numpy()
                for aid in self.agent_ids}

    # -- learning -------------------------------------------------------- #
    def _prepare(self, experiences: Dict) -> Dict:
        """The batch on the agent's device: observations preprocessed,
        rewards and dones f32."""
        ids = self.agent_ids
        return {
            "obs": self.preprocess_observation(experiences["obs"]),
            "next_obs": self.preprocess_observation(experiences["next_obs"]),
            "action": {a: as_tensor(experiences["action"][a], self.dev) for a in ids},
            "reward": {a: as_tensor(experiences["reward"][a], self.dev).float() for a in ids},
            "done": {a: as_tensor(experiences["done"][a], self.dev).float() for a in ids},
        }

    def _flat(self, obs: Dict) -> torch.Tensor:
        return torch.cat([obs[a].reshape(obs[a].shape[0], -1) for a in self.agent_ids], dim=-1)

    def _encode_all(self, actions: Dict) -> Dict[str, torch.Tensor]:
        return {a: encode_ma_action(self.discrete, self.action_dims, a, actions[a])
                for a in self.agent_ids}

    def actor_out(self, aid: str, params: Dict, obs: torch.Tensor) -> torch.Tensor:
        """A target actor's action as the critic takes it: the one-hot of the
        argmax (discrete) or the rescaled action."""
        raw = EvolvableNetwork.apply(self.actors[aid].config, params, obs)
        if self.discrete[aid]:
            return F.one_hot(torch.argmax(raw, dim=-1), self.action_dims[aid]).float()
        return _rescale(raw, self._low[aid], self._high[aid])

    def _critic_loss_fn(self, cfgs: Dict, q_in: torch.Tensor, targets: Dict[str, torch.Tensor]):
        """Summed squared TD errors over the agents (the gradient of each
        critic is that of its own loss); aux is the per-agent losses."""

        def loss_of(p):
            losses = {a: torch.mean(torch.square(
                EvolvableNetwork.apply(cfgs[a], p[a], q_in)[..., 0] - targets[a]))
                for a in self.agent_ids}
            return sum(losses.values()), losses

        return loss_of

    def _actor_step(self, actors: Dict, critics: Dict, critic_cfgs: Dict, batch: Dict,
                    all_obs: torch.Tensor, enc: Dict[str, torch.Tensor]):
        """Every agent's actor step against ``critics`` (constants); returns
        (actors, optimizer state)."""
        ids = self.agent_ids
        critics = tree_map(torch.Tensor.detach, critics)

        def joint_in(aid, mine):
            return torch.cat([all_obs] + [mine if o == aid else enc[o] for o in ids], dim=-1)

        # a discrete actor's expected-Q loss reads the critic at its one-hot
        # vertices only: one critic call over the n vertices, no gradient
        vertex_q = {}
        with torch.no_grad():
            for aid in ids:
                if self.discrete[aid]:
                    n, b = self.action_dims[aid], all_obs.shape[0]
                    eye = torch.eye(n, device=all_obs.device)
                    q_in = torch.cat([joint_in(aid, eye[j].expand(b, n)) for j in range(n)])
                    vertex_q[aid] = EvolvableNetwork.apply(
                        critic_cfgs[aid], critics[aid], q_in)[..., 0].view(n, b).T

        def loss_of(p):
            total = 0.0
            for aid in ids:
                raw = EvolvableNetwork.apply(self.actors[aid].config, p[aid], batch["obs"][aid])
                reg = self.action_reg * torch.mean(torch.square(raw))
                if self.discrete[aid]:
                    probs = torch.softmax(raw, dim=-1)
                    total = total - torch.mean(torch.sum(probs * vertex_q[aid], dim=-1)) + reg
                else:
                    mine = _rescale(raw, self._low[aid], self._high[aid])
                    q = EvolvableNetwork.apply(critic_cfgs[aid], critics[aid],
                                               joint_in(aid, mine))[..., 0]
                    total = total - torch.mean(q) + reg
            return total, None

        with torch.enable_grad():
            actors, a_opt, _, _ = grad_step(loss_of, actors, self.actor_optimizers.tx,
                                            self.actor_optimizers.opt_state)
        return actors, a_opt

    def train_step(self, batch: Dict) -> torch.Tensor:
        """One learn on a prepared batch (``_prepare``): the critic step,
        then the actor step against the updated critics, then the soft
        target updates. Returns the mean critic loss as a device tensor."""
        ids = self.agent_ids
        actors, actor_ts = self._params(self.actors), self._params(self.actor_targets)
        critics, critic_ts = self._params(self.critics), self._params(self.critic_targets)
        critic_cfgs = {a: self.critics[a].config for a in ids}
        all_obs, enc = self._flat(batch["obs"]), self._encode_all(batch["action"])
        with torch.no_grad():
            next_in = torch.cat([self._flat(batch["next_obs"])]
                                + [self.actor_out(a, actor_ts[a], batch["next_obs"][a])
                                   for a in ids], dim=-1)
            targets = {a: batch["reward"][a] + self.gamma * (1.0 - batch["done"][a])
                       * EvolvableNetwork.apply(critic_cfgs[a], critic_ts[a], next_in)[..., 0]
                       for a in ids}
        q_in = torch.cat([all_obs] + [enc[a] for a in ids], dim=-1)
        with torch.enable_grad():
            critics, c_opt, total, _ = grad_step(self._critic_loss_fn(critic_cfgs, q_in, targets),
                                                 critics, self.critic_optimizers.tx,
                                                 self.critic_optimizers.opt_state)
        actors, a_opt = self._actor_step(actors, critics, critic_cfgs, batch, all_obs, enc)
        soft_update_({"a": actor_ts, "c": critic_ts}, {"a": actors, "c": critics}, self.tau)
        for a in ids:
            self.actors[a].params, self.critics[a].params = actors[a], critics[a]
        self.actor_optimizers.opt_state, self.critic_optimizers.opt_state = a_opt, c_opt
        return total / len(ids)

    def learn(self, experiences: Dict[str, Dict[str, Any]]) -> float:
        """One learn on a sampled batch (``obs`` / ``action`` / ``reward`` /
        ``next_obs`` / ``done``, each keyed by agent id with ``[B, ...]``
        leaves); reads the mean critic loss on the host."""
        return float(self.train_step(self._prepare(experiences)))
