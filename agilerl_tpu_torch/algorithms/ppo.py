"""PPO: the port of ``agilerl_tpu/algorithms/ppo.py``, flat (non-recurrent).

The actor and critic are ``(config, params)`` networks on the agent's
device, one Adam (clip by global norm first) over both. ``learn`` computes
GAE in the buffer, then runs the JAX package's update as a Python loop:
``update_epochs`` epochs, each a fresh permutation of the ``T * N`` rows cut
into ``batch_size`` minibatches (the rest dropped), each minibatch one
clipped-ratio + value + entropy step. ``batch_size``, ``update_epochs`` and
the buffer's size are read at every call, so a mutation of any of them
needs no rebuild. Without ``target_kl`` the losses stay on the device and
the call syncs once; with it, each epoch's last approximate KL is read
(one sync per epoch) and the epochs stop above ``1.5 * target_kl``.

Recurrent PPO (``recurrent=True``: LSTM encoders, BPTT sequences) raises
until Queue 1's slice 5b.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from agilerl_tpu_torch.algorithms.core.base import RLAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper, apply_updates
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.components.rollout_buffer import RolloutBuffer
from agilerl_tpu_torch.networks import distributions as D
from agilerl_tpu_torch.networks.actors import StochasticActor
from agilerl_tpu_torch.networks.base import EvolvableNetwork
from agilerl_tpu_torch.networks.value_networks import ValueNetwork
from agilerl_tpu_torch.utils.spaces import as_tensor, is_single_observation
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-5, max=1e-2, dtype=float),
        batch_size=RLParameter(min=32, max=1024, dtype=int),
        learn_step=RLParameter(min=64, max=4096, dtype=int),
        ent_coef=RLParameter(min=1e-4, max=0.1, dtype=float),
    )


def ppo_loss(actor_cfg, critic_cfg, dist_cfg, params: Dict, obs: Any, batch: Dict,
             clip: float, ent_coef: float, vf_coef: float, normalize_advantage: bool):
    """The clipped-ratio PPO loss of one minibatch on preprocessed ``obs``.
    Returns (loss, (pg_loss, v_loss, entropy, approx_kl))."""
    logits = EvolvableNetwork.apply(actor_cfg, params["actor"], obs)
    dist_extra = params["actor"].get("dist")
    mask = batch.get("action_mask")
    new_logp = D.log_prob(dist_cfg, logits, batch["action"], dist_extra, mask=mask)
    entropy = D.entropy(dist_cfg, logits, dist_extra, mask=mask).mean()
    value = EvolvableNetwork.apply(critic_cfg, params["critic"], obs)[..., 0]
    adv = batch["advantages"]
    if normalize_advantage:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    logratio = new_logp - batch["log_prob"]
    ratio = torch.exp(logratio)
    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, 1 - clip, 1 + clip)
    pg_loss = torch.maximum(pg1, pg2).mean()
    v_loss = 0.5 * torch.square(value - batch["returns"]).mean()
    loss = pg_loss - ent_coef * entropy + vf_coef * v_loss
    approx_kl = ((ratio - 1) - logratio).mean()
    return loss, (pg_loss, v_loss, entropy, approx_kl)


class PPO(RLAlgorithm):
    # activation mutation is a no-op for policy-gradient algorithms
    supports_activation_mutation = False

    def __init__(
        self,
        observation_space,
        action_space,
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
        target_kl: Optional[float] = None,
        normalize_advantage: bool = True,
        num_envs: int = 1,
        recurrent: bool = False,
        seq_len: int = 16,
        use_rollout_buffer: bool = True,
        device=None,
        **kwargs,
    ):
        if recurrent:
            raise NotImplementedError("recurrent PPO (LSTM encoders, BPTT) is not ported yet "
                                      "(Queue 1's slice 5b)")
        super().__init__(observation_space, action_space, index=index,
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
        self.target_kl = target_kl
        self.normalize_advantage = bool(normalize_advantage)
        self.num_envs = int(num_envs)
        self.recurrent = False
        self.seq_len = int(seq_len)
        self.use_rollout_buffer = bool(use_rollout_buffer)
        self.net_config = dict(net_config or {})

        self.actor = StochasticActor(observation_space, action_space, key=self.next_key(),
                                     device=self.dev, **self.net_config)
        self.critic = ValueNetwork(observation_space, key=self.next_key(), device=self.dev,
                                   **self.net_config)
        self.optimizer = OptimizerWrapper(optimizer="adam", lr=self.lr,
                                          max_grad_norm=self.max_grad_norm)
        self.register_network_group(NetworkGroup(eval="actor", policy=True))
        self.register_network_group(NetworkGroup(eval="critic"))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor", "critic"],
                                                lr="lr"))
        self.finalize_registry()

        self.rollout_buffer = RolloutBuffer(capacity=self.learn_step, num_envs=self.num_envs,
                                            gamma=self.gamma, gae_lambda=self.gae_lambda,
                                            device=self.dev)
        self._last_obs = None
        self._last_done = None

    # ------------------------------------------------------------------ #
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
            "gae_lambda": self.gae_lambda,
            "clip_coef": self.clip_coef,
            "ent_coef": self.ent_coef,
            "vf_coef": self.vf_coef,
            "max_grad_norm": self.max_grad_norm,
            "update_epochs": self.update_epochs,
            "target_kl": self.target_kl,
            "num_envs": self.num_envs,
            "recurrent": self.recurrent,
            "seq_len": self.seq_len,
            "device": self.dev,
        }

    def value_of(self, obs: Any) -> torch.Tensor:
        """Critic value of a batched observation (the truncation bootstrap)."""
        obs_p = self.preprocess_observation(obs)
        with torch.no_grad():
            return EvolvableNetwork.apply(self.critic.config, self.critic.params, obs_p)[..., 0]

    # ------------------------------------------------------------------ #
    def get_action(self, obs: Any, action_mask=None, training: bool = True,
                   hidden: Optional[Dict] = None) -> torch.Tensor:
        """A sampled action (the mode when not ``training``), on the device."""
        a, _, _, _ = self.get_action_and_value(obs, hidden=hidden, deterministic=not training,
                                               action_mask=action_mask)
        return a

    @torch.no_grad()
    def get_action_and_value(self, obs: Any, hidden: Optional[Dict] = None,
                             deterministic: bool = False, action_mask=None):
        """(action, log_prob, value, hidden) as tensors on the device; log_prob
        and value are None when ``deterministic``. An unbatched observation
        gives unbatched results."""
        obs_p = self.preprocess_observation(obs)
        single = is_single_observation(obs_p, self.observation_space)
        if single:
            obs_p = tree_map(lambda x: x[None], obs_p)
        mask = None if action_mask is None else as_tensor(action_mask, self.dev)
        if mask is not None and single:
            mask = mask[None]
        logits = EvolvableNetwork.apply(self.actor.config, self.actor.params, obs_p)
        if deterministic:
            out = (D.mode(self.actor.dist_config, logits, mask), None, None, hidden)
        else:
            dist_extra = self.actor.params.get("dist")
            action = D.sample(self.actor.dist_config, logits, self.next_key(self.dev),
                              dist_extra, mask)
            logp = D.log_prob(self.actor.dist_config, logits, action, dist_extra, mask=mask)
            value = EvolvableNetwork.apply(self.critic.config, self.critic.params, obs_p)[..., 0]
            out = (action, logp, value, hidden)
        if single:
            out = (out[0][0],) + out[1:]
        return out

    # ------------------------------------------------------------------ #
    def _minibatch_step(self, params: Dict, batch: Dict):
        """One loss + gradient + Adam step; returns (params, loss, aux)."""
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = ppo_loss(self.actor.config, self.critic.config, self.actor.dist_config,
                                 p, self.preprocess_observation(batch["obs"]), batch,
                                 self.clip_coef, self.ent_coef, self.vf_coef,
                                 self.normalize_advantage)
            leaves = tree_leaves(p)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter([torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])
        grads = tree_map(lambda _: next(it), p)
        with torch.no_grad():
            p = tree_map(torch.Tensor.detach, p)
            updates, self.optimizer.opt_state = self.optimizer.tx.update(
                grads, self.optimizer.opt_state, p)
            params = apply_updates(p, updates)
        return params, loss.detach(), tuple(a.detach() for a in aux)

    def learn(self, experiences: Optional[Tuple] = None) -> float:
        """Update from the rollout buffer; returns the mean minibatch loss."""
        buf = self.rollout_buffer
        assert buf.state is not None, "collect rollouts before learn()"
        last_value = self.value_of(self._last_obs)
        buf.compute_returns_and_advantages(last_value, self._last_done)

        params = {"actor": self.actor.params, "critic": self.critic.params}
        loss_sum = torch.zeros((), device=self.dev)
        n_updates = 0
        for _ in range(self.update_epochs):
            aux = None
            for idx in buf.minibatch_indices(self.batch_size, key=self.next_key(self.dev)):
                params, loss, aux = self._minibatch_step(params, buf.get_batch(idx))
                loss_sum = loss_sum + loss
                n_updates += 1
            if self.target_kl is not None and float(aux[3]) > 1.5 * self.target_kl:
                break

        self.actor.params = params["actor"]
        self.critic.params = params["critic"]
        buf.reset()
        return float(loss_sum) / max(n_updates, 1)
