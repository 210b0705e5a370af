"""PPO: the port of ``agilerl_tpu/algorithms/ppo.py``, flat and recurrent.

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

Recurrent PPO (``recurrent=True``) puts LSTM encoders on both networks and
threads their hidden state ``{"actor", "critic"}`` (each ``{"h", "c"}`` of
``[L, N, H]``) through acting; ``learn`` then replays the buffer as
``seq_len`` chunks (``RolloutBuffer.get_sequences``), each from its stored
starting hidden state, in minibatches of ``batch_size // seq_len``
sequences (truncated BPTT).
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
from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.lstm import EvolvableLSTM
from agilerl_tpu_torch.modules.mlp import EvolvableMLP
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


def _clipped_objective(dist_cfg, logits, value, dist_extra, batch, clip: float,
                       ent_coef: float, vf_coef: float, normalize_advantage: bool):
    mask = batch.get("action_mask")
    new_logp = D.log_prob(dist_cfg, logits, batch["action"], dist_extra, mask=mask)
    entropy = D.entropy(dist_cfg, logits, dist_extra, mask=mask).mean()
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


def ppo_loss(actor_cfg, critic_cfg, dist_cfg, params: Dict, obs: Any, batch: Dict,
             clip: float, ent_coef: float, vf_coef: float, normalize_advantage: bool):
    """The clipped-ratio PPO loss of one minibatch on preprocessed ``obs``.
    Returns (loss, (pg_loss, v_loss, entropy, approx_kl))."""
    logits = EvolvableNetwork.apply(actor_cfg, params["actor"], obs)
    value = EvolvableNetwork.apply(critic_cfg, params["critic"], obs)[..., 0]
    return _clipped_objective(dist_cfg, logits, value, params["actor"].get("dist"), batch, clip,
                              ent_coef, vf_coef, normalize_advantage)


def ppo_bptt_loss(actor_cfg, critic_cfg, dist_cfg, params: Dict, obs: Any, batch: Dict,
                  clip: float, ent_coef: float, vf_coef: float, normalize_advantage: bool):
    """The same loss over ``[B, S]`` sequences, each replayed through the
    LSTM encoders from its stored starting hidden state."""
    hidden = batch["hidden_state"]
    latent = _lstm_encode_seq(actor_cfg, params["actor"], obs, hidden["actor"])
    logits = EvolvableMLP.apply(actor_cfg.head, params["actor"]["head"], latent)
    latent = _lstm_encode_seq(critic_cfg, params["critic"], obs, hidden["critic"])
    value = EvolvableMLP.apply(critic_cfg.head, params["critic"]["head"], latent)[..., 0]
    return _clipped_objective(dist_cfg, logits, value, params["actor"].get("dist"), batch, clip,
                              ent_coef, vf_coef, normalize_advantage)


def _lstm_encode(net_cfg, params: Dict, obs: torch.Tensor, hidden: Dict):
    """One LSTM step: obs [B, D] -> (latent [B, latent], new hidden)."""
    return EvolvableLSTM.apply(net_cfg.encoder, params["encoder"], obs, hidden=hidden,
                               return_hidden=True)


def _lstm_encode_seq(net_cfg, params: Dict, obs_seq: torch.Tensor, hidden0: Dict) -> torch.Tensor:
    """obs [B, S, D] from hidden0 leaves [B, L, H] -> latent [B, S, latent]
    (no output activation, as the JAX package's sequence encoder; the state
    is not reset inside a sequence)."""
    cfg = net_cfg.encoder
    x = obs_seq.float().transpose(0, 1)  # time-major [S, B, D]
    for i in range(cfg.num_layers):
        x, _ = L.lstm_scan(params["encoder"][f"lstm_{i}"], x, hidden0["h"][:, i],
                           hidden0["c"][:, i])
    return L.dense_apply(params["encoder"]["output"], x).transpose(0, 1)


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
        self.recurrent = bool(recurrent)
        self.seq_len = int(seq_len)
        self.use_rollout_buffer = bool(use_rollout_buffer)
        self.net_config = dict(net_config or {})

        net_kwargs = dict(self.net_config)
        if self.recurrent:
            net_kwargs["recurrent"] = True
        self.actor = StochasticActor(observation_space, action_space, key=self.next_key(),
                                     device=self.dev, **net_kwargs)
        self.critic = ValueNetwork(observation_space, key=self.next_key(), device=self.dev,
                                   **net_kwargs)
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
        self._hidden = None

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
        """Critic value of a batched observation (the truncation bootstrap);
        a recurrent critic reads it from the current hidden state."""
        obs_p = self.preprocess_observation(obs)
        with torch.no_grad():
            if self.recurrent:
                hidden = self._hidden_for(obs_p.shape[0])["critic"]
                latent, _ = _lstm_encode(self.critic.config, self.critic.params, obs_p, hidden)
                return EvolvableMLP.apply(self.critic.config.head, self.critic.params["head"],
                                          latent)[..., 0]
            return EvolvableNetwork.apply(self.critic.config, self.critic.params, obs_p)[..., 0]

    def get_initial_hidden_state(self, num_envs: Optional[int] = None) -> Dict:
        """Zero hidden states of the actor's and the critic's LSTM encoders."""
        n = num_envs or self.num_envs
        return {"actor": EvolvableLSTM.initial_hidden(self.actor.config.encoder, n, self.dev),
                "critic": EvolvableLSTM.initial_hidden(self.critic.config.encoder, n, self.dev)}

    def _hidden_for(self, batch: int) -> Dict:
        """The current hidden state, made anew (zeros) when there is none or
        its shape no longer fits ``batch`` or the encoders (after an
        architecture mutation)."""
        want = {net: (net_obj.config.encoder.num_layers, batch, net_obj.config.encoder.hidden_size)
                for net, net_obj in (("actor", self.actor), ("critic", self.critic))}
        if self._hidden is None or any(tuple(self._hidden[k]["h"].shape) != v
                                       for k, v in want.items()):
            self._hidden = self.get_initial_hidden_state(batch)
        return self._hidden

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
        if self.recurrent and hidden is None:
            hidden = self._hidden_for(tree_leaves(obs_p)[0].shape[0])
        if self.recurrent:
            latent, new_ha = _lstm_encode(self.actor.config, self.actor.params, obs_p,
                                          hidden["actor"])
            logits = EvolvableMLP.apply(self.actor.config.head, self.actor.params["head"], latent)
        else:
            logits = EvolvableNetwork.apply(self.actor.config, self.actor.params, obs_p)
        if deterministic:
            if self.recurrent:
                # greedy evaluation advances the memory too
                hidden = self._hidden = {**hidden, "actor": new_ha}
            out = (D.mode(self.actor.dist_config, logits, mask), None, None, hidden)
        else:
            dist_extra = self.actor.params.get("dist")
            action = D.sample(self.actor.dist_config, logits, self.next_key(self.dev),
                              dist_extra, mask)
            logp = D.log_prob(self.actor.dist_config, logits, action, dist_extra, mask=mask)
            if self.recurrent:
                latent, new_hc = _lstm_encode(self.critic.config, self.critic.params, obs_p,
                                              hidden["critic"])
                value = EvolvableMLP.apply(self.critic.config.head, self.critic.params["head"],
                                           latent)[..., 0]
                hidden = self._hidden = {"actor": new_ha, "critic": new_hc}
            else:
                value = EvolvableNetwork.apply(self.critic.config, self.critic.params,
                                               obs_p)[..., 0]
            out = (action, logp, value, hidden)
        if single:
            out = (out[0][0],) + out[1:]
        return out

    # ------------------------------------------------------------------ #
    def _minibatch_step(self, params: Dict, batch: Dict, loss_fn=ppo_loss):
        """One loss + gradient + Adam step; returns (params, loss, aux)."""
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = loss_fn(self.actor.config, self.critic.config, self.actor.dist_config,
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

    def _update_bptt_fn(self):
        """One recurrent minibatch step over ``[B, S]`` sequences."""
        return lambda params, batch: self._minibatch_step(params, batch, ppo_bptt_loss)

    def learn(self, experiences: Optional[Tuple] = None) -> float:
        """Update from the rollout buffer; returns the mean minibatch loss."""
        buf = self.rollout_buffer
        assert buf.state is not None, "collect rollouts before learn()"
        last_value = self.value_of(self._last_obs)
        buf.compute_returns_and_advantages(last_value, self._last_done)

        params = {"actor": self.actor.params, "critic": self.critic.params}
        loss_sum = torch.zeros((), device=self.dev)
        n_updates = 0
        if self.recurrent:
            update = self._update_bptt_fn()
            seqs = buf.get_sequences(self.seq_len)
            n_seqs = seqs["action"].shape[0]
            mb = max(self.batch_size // self.seq_len, 1)
            batches = lambda: (  # noqa: E731
                tree_map(lambda x, _i=idx: x[_i], seqs)
                for perm in [torch.randperm(n_seqs, generator=self.next_key(self.dev),
                                            device=self.dev)]
                for idx in perm.split(mb))
        else:
            update = self._minibatch_step
            batches = lambda: (buf.get_batch(idx) for idx in  # noqa: E731
                               buf.minibatch_indices(self.batch_size,
                                                     key=self.next_key(self.dev)))
        for _ in range(self.update_epochs):
            aux = None
            for batch in batches():
                params, loss, aux = update(params, batch)
                loss_sum = loss_sum + loss
                n_updates += 1
            if self.target_kl is not None and float(aux[3]) > 1.5 * self.target_kl:
                break

        self.actor.params = params["actor"]
        self.critic.params = params["critic"]
        buf.reset()
        return float(loss_sum) / max(n_updates, 1)

    def test(self, env, swap_channels=False, max_steps=None, loop=3, sum_scores=True):
        if self.recurrent:
            self._hidden = None
        return super().test(env, swap_channels, max_steps, loop, sum_scores)
