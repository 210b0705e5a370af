"""The multi-agent population as one program: the port of
``agilerl_tpu/parallel/multi_agent.py`` (``IPPOMemberState``, ``EvoIPPO``).

``EvoIPPO`` runs independent PPO, one actor and one critic per agent, over
a device multi-agent env with homogeneous agents and a shared reward
(``SimpleSpreadTorch``) through ``make_ma_autoreset_step``'s agent-major
layout. Every member's leaves are stacked ``[P, A, ...]``. The per-agent
functions (actor and critic apply, sampling, the PPO loss and its gradient)
are independent per agent, so they run under one ``torch.func.vmap`` over
the flattened ``P * A`` axis rather than two nested vmaps; GAE runs on
``[T, P, A, N]`` at once; the env steps on the flattened ``[P * N]`` batch
with ``[A, P * N]`` actions; the optimizer runs outside vmap on the stacked
leaves (Adam is elementwise; a clip must take one norm per agent of each
member: ``optimizer.clip_by_member_global_norm``).

Every draw of a generation is made first (``draw_iteration``): the action
noise ``[T, P, A, N, out]``, the env resets of every step (leaves ``[T, P,
N, ...]``) and the minibatch permutations ``[E, P, A, mb *
num_minibatches]`` (each agent of each member its own, one per epoch);
``evolve`` draws the tournament and the mutation noise. A member's slice of
a batched generation therefore equals the member's iteration run alone on
its slice of the draws.

Fitness is the censored mean of the shared return: finished episodes'
returns plus the running ones, over finished episodes plus envs. ``evolve``
moves actor, critic and optimizer state by the tournament, mutates the
actor and zeroes the running returns (a generation boundary segments them).
The reward carries the truncation bootstrap ``+ gamma * V(final_obs) *
(truncated & ~terminated)``, where the JAX program uses ``truncated``
(``SimpleSpreadTorch`` never terminates, so the numbers agree there).
``make_pod_generation`` shards the members over a mesh's population axis
(``parallel/generation.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import grad_and_value, vmap

from agilerl_tpu_torch.algorithms.core.optimizer import Transform, apply_updates
from agilerl_tpu_torch.components.rollout_buffer import _compute_gae
from agilerl_tpu_torch.envs.core import VecState
from agilerl_tpu_torch.envs.multi_agent import make_ma_autoreset_step
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
    population_load_state_dict,
    population_state_dict,
)
from agilerl_tpu_torch.parallel.population import _gather_rows
from agilerl_tpu_torch.utils.tree import tree_map


class IPPOMemberState(NamedTuple):
    """A population's state: network and optimizer leaves ``[P, A, ...]``,
    env leaves ``[P, N, ...]`` (the JAX ``VecState`` splits into
    ``env_state`` and ``step_count``; the keys become the generation's
    generator)."""

    actor: Any
    critic: Any
    opt_state: Any
    env_state: Any
    step_count: torch.Tensor  # [P, N] int32
    obs: torch.Tensor  # [P, A, N, obs_dim]
    ep_ret: torch.Tensor  # [P, N] running shared-reward episode return


def _pa(x):
    """[P, A, ...] -> [P * A, ...] (a host leaf, Adam's step count, is kept)."""
    return x.reshape((-1,) + tuple(x.shape[2:])) if isinstance(x, torch.Tensor) else x


class EvoIPPO:
    """Fully on-device evolutionary independent PPO (multi-agent), its
    population on ``device`` (the card when None, raising without one)."""

    def __init__(
        self,
        env,
        actor_config: NetworkConfig,
        critic_config: NetworkConfig,
        dist_config: D.DistConfig,
        tx: Transform,
        num_envs: int = 32,
        rollout_len: int = 32,
        update_epochs: int = 2,
        num_minibatches: int = 2,
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
        self.n_agents = len(env.agent_ids)
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
        self._vec_step = make_ma_autoreset_step(env)
        # the single-agent functions, vmapped over the flattened P * A axis
        self._act_v = vmap(self._act)
        self._value_v = vmap(self._value)
        self._grad_v = vmap(grad_and_value(self._loss))

    @property
    def env_steps_per_generation(self) -> int:
        """Env steps one member takes in one generation."""
        return self.num_envs * self.rollout_len

    # ------------------------------------------------------------------ #
    def _stack_obs(self, obs: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.stack([obs[a] for a in self.env.agent_ids])

    def init_member(self, gen: torch.Generator) -> IPPOMemberState:
        """One member (unstacked): A fresh actors, then A critics, their
        optimizer states and an env reset, drawn from ``gen``."""
        dev, A = self.device, self.n_agents

        def actor():
            p = EvolvableNetwork.init_params(split_key(gen, dev), self.actor_config)
            extra = D.extra_params(self.dist_config, dev)
            if extra:
                p["dist"] = extra
            return p

        actors = [actor() for _ in range(A)]
        critics = [EvolvableNetwork.init_params(split_key(gen, dev), self.critic_config)
                   for _ in range(A)]
        opt = [self.tx.init({"actor": a, "critic": c}) for a, c in zip(actors, critics)]
        env_state, obs = self.env.reset_fn(self.num_envs, split_key(gen, dev))
        return IPPOMemberState(tree_map(_stack, *actors), tree_map(_stack, *critics),
                               tree_map(_stack, *opt), env_state,
                               torch.zeros(self.num_envs, dtype=torch.int32, device=dev),
                               self._stack_obs(obs), torch.zeros(self.num_envs, device=dev))

    def init_population(self, gen: Union[torch.Generator, int], pop_size: int
                        ) -> IPPOMemberState:
        """``pop_size`` members drawn one after another from ``gen`` (a CPU
        generator or a seed), stacked."""
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        return tree_map(_stack, *[self.init_member(gen) for _ in range(int(pop_size))])

    # -- the draws --------------------------------------------------------- #
    def draw_iteration(self, pop_size: int, gen: torch.Generator) -> Dict[str, Any]:
        """Every draw of one ``member_iteration`` of ``pop_size`` members, from
        ``gen``: ``action`` [T, P, A, N, out] (the sampler's uniforms or
        normals), ``reset`` (the state and per-agent obs each env would
        restart from at each step, leaves [T, P, N, ...]) and ``perm`` [E,
        P, A, mb * num_minibatches] (one permutation of each agent's T * N
        rows per epoch, cut to whole minibatches)."""
        T, P, A, N = self.rollout_len, int(pop_size), self.n_agents, self.num_envs
        total = T * N
        mb = total // self.num_minibatches
        noise = D.draw_noise(self.dist_config, (T, P, A, N, D.head_output_dim(self.dist_config)),
                             gen)
        reset = self.env.reset_fn(T * P * N, gen)
        reset = tree_map(lambda x: x.reshape((T, P, N) + tuple(x.shape[1:])), reset)
        keys = torch.rand((self.update_epochs, P, A, total), generator=gen, device=gen.device)
        perm = torch.argsort(keys, dim=-1)[..., : mb * self.num_minibatches]
        return {"action": noise, "reset": reset, "perm": perm}

    # -- one agent's functions (vmapped over P * A) ------------------------- #
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
    def _agents_to_env(self, x: torch.Tensor, P: int) -> torch.Tensor:
        """[P * A, N, ...] -> [A, P * N, ...]"""
        A = self.n_agents
        x = x.view((P, A) + tuple(x.shape[1:])).transpose(0, 1)
        return x.reshape((A, -1) + tuple(x.shape[3:]))

    def _env_to_agents(self, x: torch.Tensor, P: int) -> torch.Tensor:
        """[A, P * N, ...] -> [P, A, N, ...]"""
        A, N = self.n_agents, self.num_envs
        return x.view((A, P, N) + tuple(x.shape[2:])).transpose(0, 1)

    def _rollout(self, state: IPPOMemberState, draws: Dict[str, Any],
                 gen: Optional[torch.Generator] = None):
        """``rollout_len`` steps of every member; returns (trajectory: obs,
        action, logp, value, reward [T, P, A, N, ...] and done [T, P, N],
        env state, step counts, obs, ep_ret, fitness [P])."""
        P, N = state.ep_ret.shape
        actor, critic = tree_map(_pa, state.actor), tree_map(_pa, state.critic)
        env_state = tree_map(_flat, state.env_state)
        count = _flat(state.step_count)
        obs, ep_ret = state.obs, state.ep_ret
        fsum = torch.zeros(P, device=ep_ret.device)
        fn = torch.zeros(P, device=ep_ret.device)
        traj = {k: [] for k in ("obs", "action", "logp", "value", "reward", "done")}
        for t in range(self.rollout_len):
            obs_pa = _pa(obs)
            action, logp = self._act_v(actor, obs_pa, _pa(draws["action"][t]))
            value = self._value_v(critic, obs_pa)
            reset_state = tree_map(lambda x: _flat(x[t]), draws["reset"][0])
            reset_obs = {a: _flat(v[t]) for a, v in draws["reset"][1].items()}
            vstate, next_obs, reward, term, trunc, final_obs = self._vec_step(
                VecState(env_state, count, gen), self._agents_to_env(action, P),
                reset=(reset_state, reset_obs))
            env_state, count = vstate.env_state, vstate.step_count
            reward, term, trunc = reward.view(P, N), term.view(P, N), trunc.view(P, N)
            done = torch.logical_or(term, trunc).float()
            # time-limit bootstrapping per agent's own critic, where the time
            # limit cut an episode that did not terminate
            v_final = self._value_v(critic, _pa(self._env_to_agents(final_obs, P)))
            cut = torch.logical_and(trunc, ~term).float()[:, None, :]
            reward_adj = reward[:, None, :] + self.gamma * v_final.view(P, -1, N) * cut
            ep_ret = ep_ret + reward
            fsum = fsum + torch.sum(ep_ret * done, dim=1)
            fn = fn + torch.sum(done, dim=1)
            ep_ret = ep_ret * (1.0 - done)
            shape = (P, self.n_agents, N)
            for k, v in (("obs", obs), ("action", action.view(shape + tuple(action.shape[2:]))),
                         ("logp", logp.view(shape)), ("value", value.view(shape)),
                         ("reward", reward_adj), ("done", done)):
                traj[k].append(v)
            obs = self._env_to_agents(next_obs, P)
        traj = {k: torch.stack(v) for k, v in traj.items()}
        # censored-return fitness
        fitness = (fsum + torch.sum(ep_ret, dim=1)) / (fn + N)
        env_state = tree_map(lambda x: x.view((P, N) + tuple(x.shape[1:])), env_state)
        return traj, env_state, count.view(P, N), obs, ep_ret, fitness

    def _gae(self, reward: torch.Tensor, value: torch.Tensor, done: torch.Tensor,
             last_value: torch.Tensor):
        """GAE over [T, ...] rewards, values and dones (every agent of every
        member at once); returns (advantages, returns)."""
        return _compute_gae(reward, value, done, last_value, None, self.gamma, self.gae_lambda)

    def _agent_update(self, params: Dict, opt_state: Any, flat: Dict[str, torch.Tensor],
                      perm: torch.Tensor):
        """``update_epochs`` epochs of ``num_minibatches`` minibatches over the
        rows of R stacked agents (``flat`` leaves ``[R, T * N, ...]``, params
        and optimizer leaves ``[R, ...]``) in the order ``perm`` [E, R, mb *
        num_minibatches] gives; returns (params, opt_state, mean loss [R])."""
        total = flat["logp"].shape[1]
        mb = total // self.num_minibatches
        losses = []
        for e in range(self.update_epochs):
            for i in range(self.num_minibatches):
                idx = perm[e][:, i * mb:(i + 1) * mb]
                batch = {k: _gather_rows(v, idx) for k, v in flat.items()}
                grads, loss = self._grad_v(params, batch)
                with torch.no_grad():
                    updates, opt_state = self.tx.update(grads, opt_state, params)
                    params = apply_updates(params, updates)
                losses.append(loss)
        return params, opt_state, torch.stack(losses).mean(dim=0)

    # ------------------------------------------------------------------ #
    def _learn(self, state: IPPOMemberState, traj: Dict[str, torch.Tensor], obs: torch.Tensor,
               perm: torch.Tensor) -> Tuple[Any, Any, Any]:
        """Per-agent GAE and PPO epochs of every member on its trajectory
        (``_rollout``) and ``perm`` [E, P, A, rows]; returns (actor, critic,
        opt_state), leaves [P, A, ...]."""
        T, (P, A, N) = self.rollout_len, obs.shape[:3]
        last_value = self._value_v(tree_map(_pa, state.critic), _pa(obs)).view(P, A, N)
        done = traj["done"][:, :, None, :].expand(-1, -1, A, -1)
        adv, ret = self._gae(traj["reward"], traj["value"], done, last_value)

        def rows(x):  # [T, P, A, N, ...] -> [P * A, T * N, ...], row t * N + n
            x = x.permute((1, 2, 0) + tuple(range(3, x.dim())))
            return x.reshape((P * A, T * N) + tuple(x.shape[4:]))

        flat = {"obs": rows(traj["obs"]), "action": rows(traj["action"]),
                "logp": rows(traj["logp"]), "adv": rows(adv), "ret": rows(ret)}
        params = {"actor": tree_map(_pa, state.actor), "critic": tree_map(_pa, state.critic)}
        params, opt_state, _ = self._agent_update(
            params, tree_map(_pa, state.opt_state), flat,
            perm.reshape((self.update_epochs, P * A) + tuple(perm.shape[3:])))

        def unflat(x):
            return x.view((P, A) + tuple(x.shape[1:])) if isinstance(x, torch.Tensor) else x

        return (tree_map(unflat, params["actor"]), tree_map(unflat, params["critic"]),
                tree_map(unflat, opt_state))

    def member_iteration(self, state: IPPOMemberState, draws: Dict[str, Any],
                         gen: Optional[torch.Generator] = None
                         ) -> Tuple[IPPOMemberState, torch.Tensor]:
        """One generation of every member: rollout -> per-agent GAE ->
        per-agent PPO epochs, on ``draws`` (``draw_iteration``)."""
        traj, env_state, count, obs, ep_ret, fitness = self._rollout(state, draws, gen)
        actor, critic, opt_state = self._learn(state, traj, obs, draws["perm"])
        return IPPOMemberState(actor, critic, opt_state, env_state, count, obs, ep_ret), fitness

    def _evolve_extracted(self, extracted, fitness: torch.Tensor, gen: torch.Generator):
        return evolve_actor_critic(
            extracted, fitness, gen, tournament_size=self.tournament_size,
            elitism=self.elitism, mutation_prob=self.mutation_prob,
            mutation_sd=self.mutation_sd)

    def evolve(self, pop: IPPOMemberState, fitness: torch.Tensor,
               gen: torch.Generator) -> IPPOMemberState:
        """Tournament + actor mutation on the device; the running returns
        restart at zero."""
        actor, critic, opt_state = self._evolve_extracted(
            (pop.actor, pop.critic, pop.opt_state), fitness, gen)
        return pop._replace(actor=actor, critic=critic, opt_state=opt_state,
                            ep_ret=torch.zeros_like(pop.ep_ret))

    # ------------------------------------------------------------------ #
    def make_vmap_generation(self) -> Callable:
        """One card: ``pop, fitness = generation(pop, gen)``."""

        def iteration(pop: IPPOMemberState, gen: torch.Generator):
            return self.member_iteration(pop, self.draw_iteration(pop.ep_ret.shape[0], gen), gen)

        return make_vmap_generation(iteration, self.evolve)

    def make_pod_generation(self, mesh=None, plan=None) -> Callable:
        """Members over the population axis (``generation.make_pod_generation``):
        only actor, critic and optimizer state are gathered for evolution;
        the running returns restart at zero."""
        return make_pod_generation(
            mesh, self.member_iteration, lambda pop: (pop.actor, pop.critic, pop.opt_state),
            self._evolve_extracted,
            lambda pop, mine: pop._replace(actor=mine[0], critic=mine[1], opt_state=mine[2],
                                           ep_ret=torch.zeros_like(pop.ep_ret)),
            lambda pop, P, gen: self.draw_iteration(P, gen), plan=plan, device=self.device)

    # -- snapshots ---------------------------------------------------------- #
    def state_dict(self, pop: IPPOMemberState) -> Dict[str, Any]:
        return population_state_dict(pop)

    def load_state_dict(self, pop: IPPOMemberState, blob: Dict[str, Any]) -> IPPOMemberState:
        return population_load_state_dict(pop, blob)
