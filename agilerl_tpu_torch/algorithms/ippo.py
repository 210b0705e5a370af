"""IPPO: the port of ``agilerl_tpu/algorithms/ippo.py`` (independent PPO with
one ``StochasticActor`` and one ``ValueNetwork`` per group of homogeneous
agents).

Each group keeps one ``RolloutBuffer`` in which its members are stacked as
extra env rows (``num_envs * len(members)`` columns), and one Adam state,
clipped by the group's own global norm (one shared state would keep
applying one group's momentum while another trains). ``learn`` runs, per
group, GAE and ``update_epochs`` epochs of clipped-ratio minibatch steps,
every epoch's permutation drawn before the first update; the loss is read
on the host once per call.

On the device:

- ``get_action`` draws its sampling noise first and keeps actions,
  log-probs and values on the device (the JAX one reads them to numpy on
  every step); action masks from a PettingZoo info latch the agent into
  masked mode (``_ma_masked``: from then on every buffered step carries a
  mask, all ones where the info has none, and earlier rows are backfilled
  with ones), and env-defined actions (``forced_action_arrays``) are
  resolved before the log-prob, so the buffer holds the executed action's
  likelihood. A deterministic call (evaluation) computes neither log-probs
  nor values;
- ``collect_rollouts`` folds ``gamma * V(final_obs)`` into the reward
  where an agent's episode was truncated and not terminated, with no host
  read; it syncs once, for the mean reward it returns. The JAX package
  bootstraps on ``truncated`` alone (this is the single-agent loop's rule
  in ``rollouts/on_policy.py``); no multi-agent env of the repository
  terminates and truncates on one step, so the numbers agree there.

``init_dict`` carries ``max_grad_norm`` and the device, which the JAX
``init_dict`` leaves out (a clone there goes back to the default 0.5).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from agilerl_tpu_torch.algorithms.core.base import MultiAgentRLAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, grad_step
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.algorithms.ppo import _clipped_objective
from agilerl_tpu_torch.components.rollout_buffer import RolloutBuffer
from agilerl_tpu_torch.networks import distributions as D
from agilerl_tpu_torch.networks.actors import StochasticActor
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.networks.value_networks import ValueNetwork
from agilerl_tpu_torch.rollouts.on_policy import env_action
from agilerl_tpu_torch.utils.spaces import as_tensor, preprocess_observation
from agilerl_tpu_torch.vector.pz_vec_env import sanitize_ma_transition


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=32, max=1024, dtype=int),
        learn_step=RLParameter(min=64, max=4096, dtype=int),
    )


class IPPO(MultiAgentRLAlgorithm):
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
        lr: float = 3e-4,
        learn_step: int = 128,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        clip_coef: float = 0.2,
        ent_coef: float = 0.01,
        vf_coef: float = 0.5,
        max_grad_norm: float = 0.5,
        update_epochs: int = 4,
        num_envs: int = 1,
        device=None,
        **kwargs,
    ):
        super().__init__(observation_spaces, action_spaces, agent_ids=agent_ids, index=index,
                         hp_config=hp_config or default_hp_config(), device=device, **kwargs)
        self.batch_size = int(batch_size)
        self.lr = float(lr)
        self.learn_step = int(learn_step)
        self.gamma = float(gamma)
        self.gae_lambda = float(gae_lambda)
        self.clip_coef = float(clip_coef)
        self.ent_coef = float(ent_coef)
        self.vf_coef = float(vf_coef)
        self.max_grad_norm = float(max_grad_norm)
        self.update_epochs = int(update_epochs)
        self.num_envs = int(num_envs)
        self.net_config = dict(net_config or {})

        per_agent_cfg = self.build_net_config(self.net_config)
        self.actors: Dict[str, StochasticActor] = {}
        self.critics: Dict[str, ValueNetwork] = {}
        self.rollout_buffers: Dict[str, RolloutBuffer] = {}
        for gid, members in self.grouped_agents.items():
            rep = members[0]
            g_cfg = per_agent_cfg[rep]
            self.actors[gid] = StochasticActor(self.observation_spaces[rep],
                                               self.action_spaces[rep], key=self.next_key(),
                                               device=self.dev, **g_cfg)
            self.critics[gid] = ValueNetwork(self.observation_spaces[rep], key=self.next_key(),
                                             device=self.dev, **g_cfg)
            self.rollout_buffers[gid] = RolloutBuffer(
                capacity=self.learn_step, num_envs=self.num_envs * len(members),
                gamma=self.gamma, gae_lambda=self.gae_lambda, device=self.dev)

        self.optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr,
                                          max_grad_norm=self.max_grad_norm)
        self.register_network_group(NetworkGroup(eval="actors", policy=True, multiagent=True))
        self.register_network_group(NetworkGroup(eval="critics", multiagent=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actors", "critics"],
                                                lr="lr"))
        self.finalize_registry()
        self._init_group_opt_states()
        self._last_obs = None
        self._last_done = None
        self._last_info = None
        self._ma_masked = False
        self._cached_masks: Dict[str, torch.Tensor] = {}

    def _group_params(self, gid: str) -> Dict:
        return {"actors": {gid: self.actors[gid].params},
                "critics": {gid: self.critics[gid].params}}

    def _init_group_opt_states(self) -> None:
        self.optimizer.opt_state = {gid: self.optimizer.tx.init(self._group_params(gid))
                                    for gid in self.grouped_agents}

    def reinit_optimizers(self) -> None:
        self._init_group_opt_states()

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "observation_spaces": self.observation_spaces,
            "action_spaces": self.action_spaces,
            "agent_ids": self.agent_ids,
            "index": self.index,
            "net_config": self.net_config,
            "batch_size": self.batch_size,
            "lr": self.lr,
            "learn_step": self.learn_step,
            "gamma": self.gamma,
            "gae_lambda": self.gae_lambda,
            "clip_coef": self.clip_coef,
            "ent_coef": self.ent_coef,
            "vf_coef": self.vf_coef,
            "max_grad_norm": self.max_grad_norm,
            "update_epochs": self.update_epochs,
            "num_envs": self.num_envs,
            "device": self.dev,
        }

    def evolvable_attributes(self) -> Dict[str, Any]:
        return {"actors": self.actors, "critics": self.critics}

    # ------------------------------------------------------------------ #
    def _members(self):
        """(group id, agent id) pairs in the groups' order."""
        return [(gid, aid) for gid, members in self.grouped_agents.items() for aid in members]

    def draw_action_noise(self, batch: int, gen: Optional[torch.Generator] = None
                          ) -> Dict[str, torch.Tensor]:
        """Every sampling draw of one ``get_action`` on ``batch`` rows, per
        agent in the groups' order (``distributions.draw_noise``)."""
        gen = gen if gen is not None else self.next_key(self.dev)
        out = {}
        for gid, aid in self._members():
            cfg = self.actors[gid].dist_config
            out[aid] = D.draw_noise(cfg, (batch, D.head_output_dim(cfg)), gen)
        return out

    def act(self, actor_params: Dict, critic_params: Dict, obs: Dict, noise: Optional[Dict],
            masks: Optional[Dict] = None, forced: Optional[Dict] = None,
            deterministic: bool = False):
        """(actions, log-probs, values) per agent of preprocessed ``[B, ...]``
        observations; sampled on ``noise`` (the mode when ``deterministic``,
        then without log-probs and values). ``forced`` (agent -> (values,
        valid) tensors) overrides actions component by component before the
        log-prob."""
        actions, logps, values = {}, {}, {}
        for gid, aid in self._members():
            cfg = self.actors[gid].dist_config
            logits = EvolvableNetwork.apply(self.actors[gid].config, actor_params[gid], obs[aid])
            extra = actor_params[gid].get("dist")
            mask = masks.get(aid) if masks is not None else None
            a = (D.mode(cfg, logits, mask) if deterministic
                 else D.sample_from_noise(cfg, logits, noise[aid], extra, mask))
            if forced is not None and aid in forced:
                fv, ok = forced[aid]
                # a [B, 1] force against a [B] action drops its unit dims
                while fv.dim() > a.dim() and fv.shape[-1] == 1:
                    fv, ok = fv[..., 0], ok[..., 0]
                if fv.dim() > a.dim():
                    raise ValueError(f"env_defined_action for {aid!r} has shape "
                                     f"{tuple(forced[aid][0].shape)} but the action is "
                                     f"{tuple(a.shape)}")
                ok = ok.reshape(tuple(ok.shape) + (1,) * (a.dim() - ok.dim()))
                fv = fv.reshape(tuple(fv.shape) + (1,) * (a.dim() - fv.dim()))
                a = torch.where(ok, fv.to(a.dtype), a)
            actions[aid] = a
            if not deterministic:
                logps[aid] = D.log_prob(cfg, logits, a, extra, mask=mask)
                values[aid] = EvolvableNetwork.apply(self.critics[gid].config,
                                                     critic_params[gid], obs[aid])[..., 0]
        return actions, logps, values

    @torch.no_grad()
    def get_action(self, obs: Dict[str, Any], training: bool = True,
                   infos: Optional[Dict[str, Any]] = None, **kw) -> Dict[str, torch.Tensor]:
        """Per-agent actions on the device (sampled when ``training``, else
        the mode); an unbatched observation gives unbatched actions. The
        log-probs, values and masks of the step are kept for the buffer."""
        from agilerl_tpu_torch.utils.utils import forced_action_arrays, process_ma_infos

        pre, single = self.batched_observation(obs)
        batch = pre[self.agent_ids[0]].shape[0]
        masks, eda = process_ma_infos(infos, self.agent_ids, self.dev)
        forced = forced_action_arrays(eda, self.agent_ids, batch, self.action_spaces)
        if forced is not None:
            forced = {a: (as_tensor(v, self.dev), as_tensor(ok, self.dev))
                      for a, (v, ok) in forced.items()}
        noise = self.draw_action_noise(batch) if training else None
        actions, self._cached_logps, self._cached_values = self.act(
            {g: n.params for g, n in self.actors.items()},
            {g: n.params for g, n in self.critics.items()}, pre, noise, masks, forced,
            deterministic=not training)
        # maskedness latches the first time an info carries a mask
        self._ma_masked = self._ma_masked or masks is not None
        self._cached_masks = {}
        if self._ma_masked:
            for gid, aid in self._members():
                cfg = self.actors[gid].dist_config
                if cfg.kind == "normal":
                    continue  # a mask is a no-op for a continuous head
                width = D.head_output_dim(cfg)
                m = masks.get(aid) if masks is not None else None
                self._cached_masks[aid] = (
                    m.float().expand(batch, width) if m is not None
                    else torch.ones((batch, width), device=self.dev))
        if single:
            actions = {a: v[0] for a, v in actions.items()}
        return actions

    def _group_cat(self, values: Dict[str, Any], members: List[str]) -> torch.Tensor:
        return torch.cat([as_tensor(values[a], self.dev) for a in members], dim=0)

    def _values_of(self, gid: str, obs: Dict[str, Any], members: List[str]) -> torch.Tensor:
        """The group critic's values of its members' observations, stacked."""
        o = preprocess_observation(self.observation_spaces[members[0]],
                                   self._group_cat(obs, members), self.dev)
        return EvolvableNetwork.apply(self.critics[gid].config, self.critics[gid].params,
                                      o)[..., 0]

    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def collect_rollouts(self, env, n_steps: Optional[int] = None) -> float:
        """Step the dict-API ``env`` ``n_steps`` times (default
        ``learn_step``), stacking each group's agents as extra env rows of
        its buffer; returns the mean reward per agent and step (one host
        read)."""
        n_steps = n_steps or self.learn_step
        dev = self.dev
        if self._last_obs is None:
            self._last_obs, self._last_info = env.reset()
        obs, info = self._last_obs, self._last_info
        total = torch.zeros((), device=dev)
        for _ in range(n_steps):
            actions = self.get_action(obs, infos=info)
            next_obs, rew, term, trunc, info = env.step(
                {a: env_action(env, v) for a, v in actions.items()})
            self._last_info = info
            next_obs, rew = sanitize_ma_transition(next_obs, rew)
            rew = {a: as_tensor(rew[a], dev).float().reshape(-1) for a in self.agent_ids}
            term = {a: as_tensor(term[a], dev).bool().reshape(-1) for a in self.agent_ids}
            trunc = {a: as_tensor(trunc[a], dev).bool().reshape(-1) for a in self.agent_ids}
            final = info.get("final_obs") if isinstance(info, dict) else None
            if final is not None:
                # an episode cut by its time limit (and not terminated) folds
                # gamma * V(final_obs) into its last reward
                final, _ = sanitize_ma_transition(final, {})
                for gid, members in self.grouped_agents.items():
                    v = self._values_of(gid, final, members).split(
                        [rew[a].shape[0] for a in members])
                    for a, va in zip(members, v):
                        cut = trunc[a] & ~term[a]
                        rew[a] = rew[a] + torch.where(cut, self.gamma * va,
                                                      torch.zeros_like(va))
            for gid, members in self.grouped_agents.items():
                step = dict(
                    obs=self._group_cat(obs, members),
                    action=self._group_cat(actions, members),
                    reward=self._group_cat(rew, members),
                    done=torch.cat([(term[a] | trunc[a]).float() for a in members]),
                    value=self._group_cat(self._cached_values, members),
                    log_prob=self._group_cat(self._cached_logps, members))
                if all(a in self._cached_masks for a in members):
                    step["action_mask"] = self._group_cat(self._cached_masks, members)
                self.rollout_buffers[gid].add(**step)
            total = total + sum(rew[a].mean() for a in self.agent_ids) / self.n_agents
            obs = next_obs
        self._last_obs = obs
        self._last_done = {a: (term[a] | trunc[a]).float() for a in self.agent_ids}
        return float(total) / n_steps

    def _loss_of(self, gid: str, batch: Dict):
        space = self.observation_spaces[self.grouped_agents[gid][0]]
        actor_cfg, critic_cfg = self.actors[gid].config, self.critics[gid].config
        dist_cfg = self.actors[gid].dist_config

        def loss_of(p):
            obs = preprocess_observation(space, batch["obs"], self.dev)
            logits = EvolvableNetwork.apply(actor_cfg, p["actors"][gid], obs)
            value = EvolvableNetwork.apply(critic_cfg, p["critics"][gid], obs)[..., 0]
            loss, _ = _clipped_objective(dist_cfg, logits, value, p["actors"][gid].get("dist"),
                                         batch, self.clip_coef, self.ent_coef, self.vf_coef, True)
            return loss, None

        return loss_of

    def draw_minibatches(self) -> Dict[str, List[torch.Tensor]]:
        """Per group with a filled buffer, ``update_epochs`` index tensors of
        ``[n_batches, batch_size]`` rows (one permutation each)."""
        return {gid: [buf.minibatch_indices(self.batch_size, key=self.next_key(self.dev))
                      for _ in range(self.update_epochs)]
                for gid, buf in self.rollout_buffers.items() if buf.state is not None}

    def learn(self, experiences=None, minibatches: Optional[Dict] = None) -> float:
        """GAE and the PPO epochs of every group from its buffer; returns the
        mean minibatch loss (one host read). ``minibatches`` (``gid ->
        [epoch index tensors]``) stand in for the draws of
        ``draw_minibatches``."""
        minibatches = minibatches if minibatches is not None else self.draw_minibatches()
        total = torch.zeros((), device=self.dev)
        n = 0
        for gid, members in self.grouped_agents.items():
            buf = self.rollout_buffers[gid]
            if buf.state is None:
                continue
            with torch.no_grad():
                last_value = self._values_of(gid, self._last_obs, members)
            buf.compute_returns_and_advantages(last_value, self._group_cat(self._last_done,
                                                                           members))
            params, opt_state = self._group_params(gid), self.optimizer.opt_state[gid]
            for idx in minibatches[gid]:
                for rows in idx:
                    with torch.enable_grad():
                        params, opt_state, loss, _ = grad_step(
                            self._loss_of(gid, buf.get_batch(rows)), params,
                            self.optimizer.tx, opt_state)
                    total = total + loss
                    n += 1
            buf.reset()
            self.actors[gid].params = params["actors"][gid]
            self.critics[gid].params = params["critics"][gid]
            self.optimizer.opt_state[gid] = opt_state
        return float(total) / max(n, 1)
