"""The evolutionary population as one program: the port of
``agilerl_tpu/parallel/population.py`` (``MemberState``, ``EvoPPO``).

Every member's leaves are stacked ``[P, ...]`` and one generation runs
rollout -> GAE -> PPO epochs -> tournament -> mutation over the whole
population. The networks, the sampling and the PPO loss are the
single-member functions of the classic stack under ``torch.func.vmap``
(the loss through ``torch.func.grad_and_value``); the env steps on the
flattened ``[P * N]`` batch; the optimizer runs outside vmap on the stacked
leaves (Adam is elementwise, so one call updates every member; a clip must
take one norm per member: ``optimizer.clip_by_member_global_norm``).

All randomness is drawn outside the vmapped functions, as ``[P, ...]``
tensors from an explicit ``torch.Generator`` (``draw_iteration``): the
action noise, the env resets of every step and the per-member, per-epoch
minibatch permutations; ``evolve`` draws the tournament and the mutation
noise. ``member_iteration`` is a function of the population and those draws,
so a member's slice of a batched generation equals the same member's
iteration run alone on the same draws. Nothing here reads a tensor on the
host: the caller's read of the fitness is a generation's one sync.

``make_pod_generation`` shards the members over a mesh's population axis
(``parallel/generation.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import grad_and_value, vmap

from agilerl_tpu_torch.algorithms.core.optimizer import Transform, apply_updates
from agilerl_tpu_torch.components.rollout_buffer import _compute_gae
from agilerl_tpu_torch.envs.core import TorchEnv, VecState, make_autoreset_step
from agilerl_tpu_torch.modules.base import split_key
from agilerl_tpu_torch.networks import distributions as D
from agilerl_tpu_torch.networks.base import EvolvableNetwork, NetworkConfig
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.parallel.generation import (
    _flat,
    _stack,
    evolve_actor_critic,
    make_pod_generation,
    make_vmap_generation,
)
from agilerl_tpu_torch.utils.tree import tree_map


class MemberState(NamedTuple):
    """A population's state, every tensor leaf stacked ``[P, ...]`` (the JAX
    package's ``VecState`` splits into ``env_state`` and ``step_count``; the
    per-member keys become the generation's generator)."""

    actor: Any
    critic: Any
    opt_state: Any
    env_state: Any  # the env's state, leaves [P, N, ...]
    step_count: torch.Tensor  # [P, N] int32
    obs: torch.Tensor  # [P, N, ...]
    ep_ret: torch.Tensor  # [P, N] running episode return (spans generations)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [P, R, ...], idx [P, M] -> [P, M, ...] (each member's own rows)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx]


class EvoPPO:
    """Fully on-device evolutionary PPO over a device env (``envs/core.py``),
    its population on ``device`` (the card when None, raising without one)."""

    def __init__(
        self,
        env: TorchEnv,
        actor_config: NetworkConfig,
        critic_config: NetworkConfig,
        dist_config: D.DistConfig,
        tx: Transform,
        num_envs: int = 64,
        rollout_len: int = 32,
        update_epochs: int = 2,
        num_minibatches: int = 4,
        gamma: float = 0.99,
        gae_lambda: float = 0.95,
        clip_coef: float = 0.2,
        ent_coef: float = 0.01,
        vf_coef: float = 0.5,
        elitism: bool = True,
        tournament_size: int = 2,
        mutation_sd: float = 0.02,
        mutation_prob: float = 0.5,
        device: DeviceLike = None,
    ):
        self.env = env
        self.actor_config = actor_config
        self.critic_config = critic_config
        self.dist_config = dist_config
        self.tx = tx
        self.num_envs = int(num_envs)
        self.rollout_len = int(rollout_len)
        self.update_epochs = int(update_epochs)
        self.num_minibatches = int(num_minibatches)
        self.gamma = float(gamma)
        self.gae_lambda = float(gae_lambda)
        self.clip_coef = float(clip_coef)
        self.ent_coef = float(ent_coef)
        self.vf_coef = float(vf_coef)
        self.elitism = bool(elitism)
        self.tournament_size = int(tournament_size)
        self.mutation_sd = float(mutation_sd)
        self.mutation_prob = float(mutation_prob)
        self.device = resolve_device(device)
        self._vec_step = make_autoreset_step(env)
        # the single-member functions, vmapped over the population once
        self._act_v = vmap(self._act)
        self._value_v = vmap(self._value)
        self._grad_v = vmap(grad_and_value(self._loss))

    @property
    def env_steps_per_generation(self) -> int:
        """Env steps one member takes in one generation."""
        return self.num_envs * self.rollout_len

    # ------------------------------------------------------------------ #
    def init_member(self, gen: torch.Generator) -> MemberState:
        """One member (unstacked): fresh networks, optimizer state and env
        reset, drawn from ``gen``."""
        dev = self.device
        actor = EvolvableNetwork.init_params(split_key(gen, dev), self.actor_config)
        extra = D.extra_params(self.dist_config, dev)
        if extra:
            actor["dist"] = extra
        critic = EvolvableNetwork.init_params(split_key(gen, dev), self.critic_config)
        opt_state = self.tx.init({"actor": actor, "critic": critic})
        env_state, obs = self.env.reset_fn(self.num_envs, split_key(gen, dev))
        return MemberState(actor, critic, opt_state, env_state,
                           torch.zeros(self.num_envs, dtype=torch.int32, device=dev), obs,
                           torch.zeros(self.num_envs, device=dev))

    def init_population(self, gen: Union[torch.Generator, int], pop_size: int) -> MemberState:
        """``pop_size`` members drawn one after another from ``gen`` (a CPU
        generator or a seed), stacked."""
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        members = [self.init_member(gen) for _ in range(int(pop_size))]
        return tree_map(_stack, *members)

    # -- the draws --------------------------------------------------------- #
    def draw_iteration(self, pop_size: int, gen: torch.Generator) -> Dict[str, Any]:
        """Every draw of one ``member_iteration`` of ``pop_size`` members, from
        ``gen`` (on the population's device): ``action`` [T, P, N, A] (the
        sampler's uniforms or normals), ``reset`` (the env state and obs each
        env would restart from at each step, leaves [T, P, N, ...]) and
        ``perm`` [E, P, mb * num_minibatches] (each member's minibatch rows,
        one permutation of its T * N rows per epoch, cut to whole
        minibatches)."""
        T, P, N = self.rollout_len, int(pop_size), self.num_envs
        A = D.head_output_dim(self.dist_config)
        total = T * N
        mb = total // self.num_minibatches
        noise = D.draw_noise(self.dist_config, (T, P, N, A), gen)
        reset = self.env.reset_fn(T * P * N, gen)
        reset = tree_map(lambda x: x.reshape((T, P, N) + tuple(x.shape[1:])), reset)
        keys = torch.rand((self.update_epochs, P, total), generator=gen, device=gen.device)
        perm = torch.argsort(keys, dim=-1)[..., : mb * self.num_minibatches]
        return {"action": noise, "reset": reset, "perm": perm}

    # -- one member's functions (vmapped) --------------------------------- #
    def _act(self, actor: Dict, obs: torch.Tensor, noise: torch.Tensor):
        logits = EvolvableNetwork.apply(self.actor_config, actor, obs)
        extra = actor.get("dist")
        action = D.sample_from_noise(self.dist_config, logits, noise, extra)
        return action, D.log_prob(self.dist_config, logits, action, extra)

    def _value(self, critic: Dict, obs: torch.Tensor) -> torch.Tensor:
        return EvolvableNetwork.apply(self.critic_config, critic, obs)[..., 0]

    def _loss(self, p: Dict, b: Dict) -> torch.Tensor:
        logits = EvolvableNetwork.apply(self.actor_config, p["actor"], b["obs"])
        extra = p["actor"].get("dist")
        new_logp = D.log_prob(self.dist_config, logits, b["action"], extra)
        ent = D.entropy(self.dist_config, logits, extra).mean()
        value = EvolvableNetwork.apply(self.critic_config, p["critic"], b["obs"])[..., 0]
        # jnp.std: ddof 0
        a = (b["adv"] - b["adv"].mean()) / (b["adv"].std(correction=0) + 1e-8)
        ratio = torch.exp(new_logp - b["logp"])
        pg = torch.maximum(-a * ratio,
                           -a * torch.clamp(ratio, 1 - self.clip_coef, 1 + self.clip_coef)).mean()
        v_loss = 0.5 * torch.square(value - b["ret"]).mean()
        return pg - self.ent_coef * ent + self.vf_coef * v_loss

    # ------------------------------------------------------------------ #
    def _rollout(self, state: MemberState, draws: Dict[str, Any],
                 gen: Optional[torch.Generator] = None):
        """``rollout_len`` steps of every member; returns (trajectory of
        [T, P, N] tensors, env state, step counts, obs, ep_ret, fitness [P]).
        The reward in the trajectory carries the truncation bootstrap
        ``+ gamma * V(final_obs) * (truncated & ~terminated)``: unlike the
        JAX package, a step that terminates on its last allowed step is not
        bootstrapped (``rollouts/on_policy.py``)."""
        P, N = state.ep_ret.shape
        env_state = tree_map(_flat, state.env_state)
        count = _flat(state.step_count)
        obs, ep_ret = state.obs, state.ep_ret
        fsum = torch.zeros(P, device=ep_ret.device)
        fn = torch.zeros(P, device=ep_ret.device)
        traj = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
        for t in range(self.rollout_len):
            action, logp = self._act_v(state.actor, obs, draws["action"][t])
            value = self._value_v(state.critic, obs)
            reset = tree_map(lambda x: _flat(x[t]), draws["reset"])
            vstate, next_obs, reward, term, trunc, final_obs = self._vec_step(
                VecState(env_state, count, gen), _flat(action), reset=reset)
            env_state, count = vstate.env_state, vstate.step_count
            unflat = (P, N)
            reward, term, trunc = reward.view(unflat), term.view(unflat), trunc.view(unflat)
            done = torch.logical_or(term, trunc).float()
            # time-limit bootstrapping where the time limit cut an episode that
            # did not terminate (fold gamma * V(s_final))
            v_final = self._value_v(state.critic, final_obs.view(unflat + final_obs.shape[1:]))
            reward_adj = reward + self.gamma * v_final * torch.logical_and(trunc, ~term).float()
            ep_ret = ep_ret + reward
            fsum = fsum + torch.sum(ep_ret * done, dim=1)
            fn = fn + torch.sum(done, dim=1)
            ep_ret = ep_ret * (1.0 - done)
            for k, v in (("obs", obs), ("action", action), ("logp", logp), ("value", value),
                         ("reward", reward_adj), ("done", done)):
                traj[k].append(v)
            obs = next_obs.view(unflat + next_obs.shape[1:])
        traj = {k: torch.stack(v) for k, v in traj.items()}
        fitness = self._fitness(fsum, fn, traj["reward"])
        env_state = tree_map(lambda x: x.view((P, N) + tuple(x.shape[1:])), env_state)
        return traj, env_state, count.view(P, N), obs, ep_ret, fitness

    def _fitness(self, fsum: torch.Tensor, fn: torch.Tensor,
                 reward: torch.Tensor) -> torch.Tensor:
        """The mean finished-episode return of each member; where none
        finished, ``mean(reward) * max_episode_steps`` (reward [T, P, N])."""
        fallback = reward.mean(dim=(0, 2))
        if self.env.max_episode_steps:
            fallback = fallback * self.env.max_episode_steps
        return torch.where(fn > 0, fsum / torch.clamp(fn, min=1.0), fallback)

    def _gae(self, traj: Dict[str, torch.Tensor], last_value: torch.Tensor):
        """GAE over [T, P, N]: step t's own done masks both its bootstrap and
        the carried advantage (``components/rollout_buffer.py``)."""
        return _compute_gae(traj["reward"], traj["value"], traj["done"], last_value, None,
                            self.gamma, self.gae_lambda)

    def _ppo_update(self, actor, critic, opt_state, traj, adv, ret, perm):
        """``update_epochs`` epochs of ``num_minibatches`` minibatches over each
        member's T * N rows, in the order ``perm`` [E, P, mb * num_minibatches]
        gives; returns (actor, critic, opt_state, mean loss [P])."""
        T, P, N = traj["reward"].shape
        total = T * N
        mb = total // self.num_minibatches

        def rows(x):  # [T, P, N, ...] -> [P, T * N, ...], row t * N + n
            return x.transpose(0, 1).reshape((P, total) + tuple(x.shape[3:]))

        data = {"obs": rows(traj["obs"]), "action": rows(traj["action"]),
                "logp": rows(traj["logp"]), "adv": rows(adv), "ret": rows(ret)}
        params = {"actor": actor, "critic": critic}
        losses = []
        for e in range(self.update_epochs):
            for i in range(self.num_minibatches):
                idx = perm[e][:, i * mb:(i + 1) * mb]
                batch = {k: _gather_rows(v, idx) for k, v in data.items()}
                grads, loss = self._grad_v(params, batch)
                with torch.no_grad():
                    updates, opt_state = self.tx.update(grads, opt_state, params)
                    params = apply_updates(params, updates)
                losses.append(loss)
        return params["actor"], params["critic"], opt_state, torch.stack(losses).mean(dim=0)

    # ------------------------------------------------------------------ #
    def member_iteration(self, state: MemberState, draws: Dict[str, Any],
                         gen: Optional[torch.Generator] = None) -> Tuple[MemberState, torch.Tensor]:
        """One generation of every member: rollout -> GAE -> PPO epochs, on
        ``draws`` (``draw_iteration``). ``gen`` reaches only an env whose
        step itself draws (the classic envs' do not)."""
        traj, env_state, count, obs, ep_ret, fitness = self._rollout(state, draws, gen)
        last_value = self._value_v(state.critic, obs)
        adv, ret = self._gae(traj, last_value)
        actor, critic, opt_state, _ = self._ppo_update(
            state.actor, state.critic, state.opt_state, traj, adv, ret, draws["perm"])
        return MemberState(actor, critic, opt_state, env_state, count, obs, ep_ret), fitness

    def _evolve_extracted(self, extracted, fitness: torch.Tensor, gen: torch.Generator):
        return evolve_actor_critic(
            extracted, fitness, gen, tournament_size=self.tournament_size,
            elitism=self.elitism, mutation_prob=self.mutation_prob,
            mutation_sd=self.mutation_sd)

    def evolve(self, pop: MemberState, fitness: torch.Tensor,
               gen: torch.Generator) -> MemberState:
        """Tournament + actor mutation on the device. Only actor, critic and
        optimizer state move: ``ep_ret`` carries across the boundary (one
        rollout is far shorter than an episode, so segmenting would cap
        measurable returns at ``rollout_len``)."""
        actor, critic, opt_state = self._evolve_extracted(
            (pop.actor, pop.critic, pop.opt_state), fitness, gen)
        return pop._replace(actor=actor, critic=critic, opt_state=opt_state)

    # ------------------------------------------------------------------ #
    def make_vmap_generation(self) -> Callable:
        """One card: ``pop, fitness = generation(pop, gen)``."""

        def iteration(pop: MemberState, gen: torch.Generator):
            return self.member_iteration(pop, self.draw_iteration(pop.ep_ret.shape[0], gen), gen)

        return make_vmap_generation(iteration, self.evolve)

    def make_pod_generation(self, mesh=None, plan=None) -> Callable:
        """Members over the population axis (``generation.make_pod_generation``):
        only actor, critic and optimizer state are gathered for evolution."""
        return make_pod_generation(
            mesh, self.member_iteration, lambda pop: (pop.actor, pop.critic, pop.opt_state),
            self._evolve_extracted,
            lambda pop, mine: pop._replace(actor=mine[0], critic=mine[1], opt_state=mine[2]),
            lambda pop, P, gen: self.draw_iteration(P, gen), plan=plan, device=self.device)
