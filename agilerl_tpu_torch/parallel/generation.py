"""The generation engine: the port of ``agilerl_tpu/parallel/generation.py``
(evolution as array ops, the one-card generation contract, the stacked
replay rings and their helpers, ``ScanOffPolicy``, population snapshots and
``ScanRun``).

A population is a tree whose tensor leaves are stacked ``[P, ...]`` over
its members. Evolution splits into draws and a pure part: the draws come
from an explicit ``torch.Generator`` (``tournament_select``,
``mutation_noise``), and ``apply_evolution`` is a function of the
population and those draws alone, so the same draws give the same
population on any device. A leaf that is not a tensor (Adam's step count,
one host integer: every member takes the same number of steps) is the same
for every member, and the gather keeps it as it is.

The replay rings of a population (``DeviceReplayRing``) are stacked
``[P, capacity, ...]`` with host cursors, and their helpers
(``ring_write``, ``ring_sample_uniform``, ``ring_sample_per``,
``ring_update_priorities``, ``ring_nstep_gather``) take their draws as
arguments and compute what ``components/replay_buffer.py`` computes, per
member. Deviations from the JAX package: the ring cursors, the tick, the
learn count and epsilon are host values (the same for every member), and
the learn gate and the target / actor cadences are host decisions.

``make_pod_generation`` and ``ScanRun(mesh=, plan=)`` (a population sharded
over several cards) come with Queue 1's slice 6.
"""

from __future__ import annotations

import functools
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap

from agilerl_tpu_torch.algorithms.dqn import soft_update_
from agilerl_tpu_torch.envs.core import VecState, make_autoreset_step
from agilerl_tpu_torch.modules.base import split_key
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.rng import generator_from_host, generator_to_host
from agilerl_tpu_torch.utils.spaces import preprocess_observation
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

_POD = "{} (a population sharded over several cards) comes with Queue 1's slice 6"


# --------------------------------------------------------------------------- #
# Evolution as array ops
# --------------------------------------------------------------------------- #


def tournament_select(
    fitness: torch.Tensor,
    gen: torch.Generator,
    tournament_size: int,
    elitism: bool,
    mutation_prob: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tournament on the device: ``[P, tournament_size]`` entrants drawn with
    replacement, each winner the argmax fitness among its entrants; with
    elitism slot 0 takes the overall argmax and is never mutated. Returns
    ``(winners [P] int64, do_mut [P] f32)``; no host sync."""
    P = fitness.shape[0]
    dev = fitness.device
    entrants = torch.randint(0, P, (P, tournament_size), generator=gen, device=dev)
    winners = torch.gather(entrants, 1, torch.argmax(fitness[entrants], dim=1, keepdim=True))[:, 0]
    do_mut = (torch.rand(P, generator=gen, device=dev) < mutation_prob).float()
    if elitism:
        # torch.where, not winners[0] = argmax: a 0-d tensor assigned into
        # an element is read on the host
        first = torch.arange(P, device=dev) == 0
        winners = torch.where(first, torch.argmax(fitness), winners)
        do_mut = torch.where(first, 0.0, do_mut)
    return winners, do_mut


def mutation_noise(tree: PyTree, gen: torch.Generator) -> PyTree:
    """One standard-normal draw per entry of every tensor leaf of ``tree``."""
    return tree_map(lambda x: torch.randn(x.shape, generator=gen, device=x.device,
                                          dtype=x.dtype), tree)


def gaussian_mutate(trees: PyTree, noise: PyTree, do_mut: torch.Tensor, sd: float) -> PyTree:
    """Per member, per leaf, ``l + do * sd * noise`` (``do_mut`` gates each
    member)."""

    def mutate(leaf, n):
        do = do_mut.to(leaf.dtype).view((-1,) + (1,) * (leaf.dim() - 1))
        return leaf + do * sd * n

    return tree_map(mutate, trees, noise)


def gather_members(tree: PyTree, winners: torch.Tensor) -> PyTree:
    """``x[winners]`` on every tensor leaf; other leaves are kept."""
    return tree_map(lambda x: x[winners] if isinstance(x, torch.Tensor) else x, tree)


def apply_evolution(extracted: Tuple[PyTree, PyTree, PyTree], winners: torch.Tensor,
                    do_mut: torch.Tensor, noise: PyTree,
                    mutation_sd: float) -> Tuple[PyTree, PyTree, PyTree]:
    """The pure part of ``evolve_actor_critic``: gather actor, critic and
    optimizer state by ``winners``, then mutate the actor only."""
    actor, critic, opt_state = (gather_members(t, winners) for t in extracted)
    return gaussian_mutate(actor, noise, do_mut, mutation_sd), critic, opt_state


def evolve_actor_critic(
    extracted: Tuple[PyTree, PyTree, PyTree],
    fitness: torch.Tensor,
    gen: torch.Generator,
    *,
    tournament_size: int,
    elitism: bool,
    mutation_prob: float,
    mutation_sd: float,
) -> Tuple[PyTree, PyTree, PyTree]:
    """Tournament + actor-only Gaussian mutation over an ``(actor, critic,
    opt_state)`` triple: the draws, then ``apply_evolution``."""
    winners, do_mut = tournament_select(fitness, gen, tournament_size, elitism, mutation_prob)
    noise = mutation_noise(extracted[0], gen)
    return apply_evolution(extracted, winners, do_mut, noise, mutation_sd)


# --------------------------------------------------------------------------- #
# The one-card generation contract
# --------------------------------------------------------------------------- #


def make_vmap_generation(member_iteration: Callable, evolve: Callable) -> Callable:
    """One card: ``pop, fitness = generation(pop, gen)`` runs every member's
    iteration over the stacked population (``member_iteration(pop, gen)``),
    then evolution (``evolve(pop, fitness, gen)``), with every draw taken
    from ``gen``."""

    def generation(pop, gen: torch.Generator):
        pop, fitness = member_iteration(pop, gen)
        return evolve(pop, fitness, gen), fitness

    return generation


def make_pod_generation(*args, **kwargs) -> Callable:
    raise NotImplementedError(_POD.format("make_pod_generation"))


# --------------------------------------------------------------------------- #
# The replay ring of a population
# --------------------------------------------------------------------------- #

# the dtypes jnp.asarray stores (64-bit types off), as components/replay_buffer.py
_CANONICAL = {torch.float64: torch.float32, torch.int64: torch.int32}


class DeviceReplayRing(NamedTuple):
    """A population's replay rings, stacked: ``storage`` leaves are
    ``[P, capacity, ...]``, ``priorities`` ``[P, capacity]`` (alpha-powered;
    uniform programs never read them) and ``max_priority`` ``[P]``. Every
    member writes ``num_envs`` rows per tick, so the write cursor ``pos`` and
    the fill ``size`` are the same for every member and live on the host, as
    the replay buffers' cursors do."""

    storage: PyTree
    pos: int
    size: int
    priorities: torch.Tensor
    max_priority: torch.Tensor


def ring_init(example: PyTree, capacity: int, pop_size: int,
              device: DeviceLike = None) -> DeviceReplayRing:
    """Empty rings of ``pop_size`` members shaped like one (unbatched)
    ``example`` transition."""
    dev = resolve_device(device)

    def alloc(x):
        x = torch.as_tensor(x)
        return torch.zeros((pop_size, capacity) + tuple(x.shape),
                           dtype=_CANONICAL.get(x.dtype, x.dtype), device=dev)

    return DeviceReplayRing(tree_map(alloc, example), 0, 0,
                            torch.zeros((pop_size, capacity), device=dev),
                            torch.ones(pop_size, device=dev))


def ring_write(ring: DeviceReplayRing, batch: PyTree) -> DeviceReplayRing:
    """Write every member's ``[P, n, ...]`` rows at the cursor: one
    ``index_copy_`` along dim 1 per leaf at ``(pos + arange(n)) % capacity``
    (``n <= capacity``); the new rows get each member's running max
    priority, as per-row PER adds would."""
    n = tree_leaves(batch)[0].shape[1]
    P, capacity = ring.priorities.shape
    idx = (torch.arange(n, device=ring.priorities.device) + ring.pos) % capacity
    tree_map(lambda buf, x: buf.index_copy_(1, idx, x.to(buf.dtype)), ring.storage, batch)
    ring.priorities.index_copy_(1, idx, ring.max_priority[:, None].expand(P, n))
    return ring._replace(pos=(ring.pos + n) % capacity, size=min(ring.size + n, capacity))


def _rows(tree: PyTree, idx: torch.Tensor) -> PyTree:
    """Each member's rows ``idx`` [P, B] of ``[P, capacity, ...]`` leaves."""
    members = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return tree_map(lambda buf: buf[members, idx], tree)


def ring_sample_uniform(ring: DeviceReplayRing,
                        idx: torch.Tensor) -> Tuple[PyTree, torch.Tensor, torch.Tensor]:
    """``(batch, idx, weights of ones)`` at ring indices ``idx`` [P, B],
    drawn first from ``[0, size)``."""
    return _rows(ring.storage, idx), idx, torch.ones(idx.shape, device=idx.device)


def ring_sample_per(ring: DeviceReplayRing, u: torch.Tensor,
                    beta: float) -> Tuple[PyTree, torch.Tensor, torch.Tensor]:
    """Proportional PER by inverse CDF at uniforms ``u`` [P, B], per member:
    a batched cumulative sum of the valid priorities, a batched
    ``searchsorted(right=True)`` clipped to ``size - 1``, and importance
    weights normalised by each member's ring-global minimum priority. The
    sum and weights in f64 (``components/replay_buffer._per_sample``)."""
    size = ring.size
    capacity = ring.priorities.shape[1]
    valid = torch.arange(capacity, device=u.device) < size
    p = torch.where(valid, ring.priorities, 0.0).double()
    cdf = torch.cumsum(p, dim=1)
    total = cdf[:, -1:]
    idx = torch.searchsorted(cdf, u.double() * total, right=True)
    idx = torch.clamp(idx, 0, max(size - 1, 0))
    denom = torch.clamp(total, min=1e-12)
    weights = (float(size) * (torch.gather(p, 1, idx) / denom)) ** (-beta)
    p_min = torch.min(torch.where(valid, p, torch.inf), dim=1, keepdim=True).values / denom
    max_weight = (float(size) * torch.clamp(p_min, min=1e-12)) ** (-beta)
    return (_rows(ring.storage, idx), idx,
            (weights / torch.clamp(max_weight, min=1e-12)).float())


def ring_update_priorities(ring: DeviceReplayRing, idx: torch.Tensor, priorities: torch.Tensor,
                           alpha: float) -> DeviceReplayRing:
    """Write ``max(|priority|, 1e-5) ** alpha`` at each member's ``idx``
    (one ``scatter_``) and raise each member's max priority on the device.
    The rows of one batch that share an index carry one value (the same
    transition gives the same error), so the write order does not matter."""
    powered = torch.clamp(torch.abs(priorities), min=1e-5) ** alpha
    ring.priorities.scatter_(1, idx, powered)
    return ring._replace(max_priority=torch.maximum(ring.max_priority,
                                                    powered.max(dim=1).values))


def ring_nstep_gather(ring: DeviceReplayRing, idx: torch.Tensor, n_step: int, gamma: float,
                      stride: int = 1) -> Dict[str, torch.Tensor]:
    """The sample-time n-step fold at start indices ``idx`` [P, B]: rewards
    folded with ``gamma`` through the same env's rows (``stride`` apart:
    ``num_envs`` for a population program's tick-major rows), frozen at an
    episode ``boundary`` and at the stream head (a row newer than the last
    one written is not folded: ``age``). Returns the folded ``reward``, the
    last folded row's ``next_obs`` and ``done``, and ``steps`` (rows folded
    per sample), so the learner bootstraps with ``gamma ** steps``."""
    capacity = ring.priorities.shape[1]
    assert capacity % stride == 0, (
        f"ring capacity {capacity} must be a multiple of the n-step fold stride {stride}")
    store = ring.storage
    age = (ring.pos - 1 - idx) % capacity
    reward = torch.zeros(idx.shape, device=idx.device)
    alive = torch.ones_like(reward)
    next_obs = _rows(store["next_obs"], idx)
    done = _rows(store["done"], idx).float()
    steps = torch.ones_like(reward)
    discount = 1.0
    for j in range(n_step):
        rows = (idx + j * stride) % capacity
        in_stream = (j * stride <= age).float()
        eff = alive * in_stream
        reward = reward + discount * _rows(store["reward"], rows).float() * eff
        if j > 0:
            upd = eff.bool()
            next_obs = tree_map(lambda cur, buf: torch.where(
                upd.view(upd.shape + (1,) * (cur.dim() - upd.dim())), buf, cur),
                next_obs, _rows(store["next_obs"], rows))
            done = torch.where(upd, _rows(store["done"], rows).float(), done)
            steps = torch.where(upd, float(j + 1), steps)
        alive = alive * (1.0 - _rows(store["boundary"], rows).float()) * in_stream
        discount *= gamma
    return {"obs": _rows(store["obs"], idx), "action": _rows(store["action"], idx),
            "reward": reward, "next_obs": next_obs, "done": done, "steps": steps}


# --------------------------------------------------------------------------- #
# The off-policy generation engine
# --------------------------------------------------------------------------- #


class ScanMemberState(NamedTuple):
    """A population's state: tensor leaves stacked ``[P, ...]``. The tick,
    the learn count and epsilon are the same for every member (every member
    steps and learns on the same ticks) and live on the host."""

    learner: Any  # algorithm-specific networks, targets and optimizer states
    ring: DeviceReplayRing
    env_state: Any  # leaves [P, N, ...]
    step_count: torch.Tensor  # [P, N] int32
    obs: Any  # [P, N, ...]
    ep_ret: torch.Tensor  # [P, N], segmented at generation boundaries
    tick: int  # lifetime env-step ticks (the learn cadence)
    learn_count: int  # lifetime learns (the target and actor cadences)
    epsilon: float  # exploration scalar of the epsilon-greedy programs


def _flat(x: torch.Tensor) -> torch.Tensor:
    """[P, N, ...] -> [P * N, ...]"""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _stack(*members):
    return torch.stack(members) if isinstance(members[0], torch.Tensor) else members[0]


class ScanOffPolicy:
    """The off-policy population as one program on one card (the port of
    the JAX ``ScanOffPolicy``): per tick, act -> env step -> ring write ->
    gated sample + learn -> target update, for every member at once.

    The JAX tick is a ``lax.scan`` step; here a generation is a Python loop
    over ``steps_per_iter`` ticks. The learn gate (``lax.cond`` in the JAX
    package) depends only on the ring's fill, the tick and ``learn_every``,
    the same for every member, so it is a host decision, as are the learn
    count, the target cadence and the actor delay: no masked learn, no sync.
    Every draw of a generation is made first, from one generator, as
    ``[T, P, ...]`` tensors (``draw_iteration``): exploration, env resets,
    sample indices or PER uniforms and the algorithm's learn noise; so a
    member alone equals its slice of the batched program. The member
    functions (``_act``, the losses) run under ``torch.func.vmap``; the env
    steps on the flattened ``[P * N]`` batch; the optimizers, ring writes,
    priority scatters and target updates run outside vmap on the stacked
    leaves.

    Subclasses define ``_init_learner(gen)``, ``_act_params(learner)``,
    ``_act(params, obs, draws, epsilon)`` (one member), ``_learn(learner,
    batch, n_batch, weights, draws, learn_count) -> (learner, loss [P],
    td_abs [P, B])`` (stacked), ``_action_example()``,
    ``_draw_act(T, P, gen)`` and ``_draw_learn(T, P, gen)``.
    """

    _mutate_fields: Tuple[str, ...] = ("params",)

    def __init__(self, env, tx, *, num_envs: int = 64, steps_per_iter: int = 128,
                 buffer_size: int = 10_000, batch_size: int = 64, gamma: float = 0.99,
                 tau: float = 0.01, learn_every: int = 1, warmup: Optional[int] = None,
                 per: bool = False, per_alpha: float = 0.6, per_beta: float = 0.4,
                 n_step: int = 1, target_every: int = 0, prior_eps: float = 1e-6,
                 eps_start: float = 1.0, eps_decay: float = 0.999, eps_end: float = 0.05,
                 elitism: bool = True, tournament_size: int = 2, mutation_sd: float = 0.02,
                 mutation_prob: float = 0.5, device: DeviceLike = None):
        self.env = env
        self.tx = tx
        self.num_envs = int(num_envs)
        self.steps_per_iter = int(steps_per_iter)
        self.buffer_size = int(buffer_size)
        self.batch_size = int(batch_size)
        self.gamma = float(gamma)
        self.tau = float(tau)
        self.learn_every = int(learn_every)
        self.warmup = int(warmup) if warmup is not None else int(batch_size)
        self.per = bool(per)
        self.per_alpha = float(per_alpha)
        self.per_beta = float(per_beta)
        self.n_step = int(n_step)
        self.target_every = int(target_every)
        self.prior_eps = float(prior_eps)
        self.eps_start = float(eps_start)
        self.eps_decay = float(eps_decay)
        self.eps_end = float(eps_end)
        self.elitism = bool(elitism)
        self.tournament_size = int(tournament_size)
        self.mutation_sd = float(mutation_sd)
        self.mutation_prob = float(mutation_prob)
        self.device = resolve_device(device)
        if self.n_step > 1 and self.buffer_size % self.num_envs != 0:
            # the fold strides by num_envs: wraparound must keep env alignment
            self.buffer_size += self.num_envs - self.buffer_size % self.num_envs
        self._vec_step = make_autoreset_step(env)
        self.obs_space = env.observation_space

    # -- per-algorithm hooks ------------------------------------------------ #
    def _init_learner(self, gen: torch.Generator):  # pragma: no cover
        raise NotImplementedError

    def _act_params(self, learner):  # pragma: no cover
        raise NotImplementedError

    def _act(self, params, obs, draws, epsilon: float):  # pragma: no cover
        raise NotImplementedError

    def _learn(self, learner, batch, n_batch, weights, draws, learn_count: int):
        raise NotImplementedError  # pragma: no cover

    def _action_example(self) -> torch.Tensor:  # pragma: no cover
        raise NotImplementedError

    def _draw_act(self, T: int, P: int, gen: torch.Generator):  # pragma: no cover
        raise NotImplementedError

    def _draw_learn(self, T: int, P: int, gen: torch.Generator):
        return None

    # -- shared algorithm plumbing ------------------------------------------ #
    def _td_fields(self, batch, n_batch):
        """Preprocessed ``(obs, reward, done, next_obs, gamma_n)`` of the
        1-step batch or the n-step fold (``gamma_n = gamma ** steps`` per
        sample), every leaf ``[P, B, ...]``."""
        obs = preprocess_observation(self.obs_space, batch["obs"])
        if n_batch is not None:
            return (obs, n_batch["reward"], n_batch["done"],
                    preprocess_observation(self.obs_space, n_batch["next_obs"]),
                    torch.pow(torch.tensor(self.gamma, dtype=torch.float32,
                                           device=n_batch["steps"].device), n_batch["steps"]))
        return (obs, batch["reward"].float(), batch["done"].float(),
                preprocess_observation(self.obs_space, batch["next_obs"]), self.gamma)

    def _update_target(self, target, params, learn_count: int) -> None:
        """The value-based target cadence, in place: a hard copy every
        ``target_every`` learns when set, else a soft update with ``tau``."""
        if self.target_every > 0:
            if learn_count % self.target_every == 0:
                torch._foreach_copy_(tree_leaves(target), tree_leaves(params))
        else:
            soft_update_(target, params, self.tau)

    # -- members ------------------------------------------------------------ #
    @property
    def env_steps_per_generation(self) -> int:
        """Env steps one member takes in one generation."""
        return self.num_envs * self.steps_per_iter

    def init_member(self, gen: torch.Generator):
        """One member's learner, env state and first obs (unstacked)."""
        learner = self._init_learner(gen)
        env_state, obs = self.env.reset_fn(self.num_envs, split_key(gen, self.device))
        return learner, env_state, obs

    def init_population(self, gen: Union[torch.Generator, int], pop_size: int) -> ScanMemberState:
        """``pop_size`` members drawn one after another from ``gen`` (a CPU
        generator or a seed), stacked, with empty rings."""
        if not isinstance(gen, torch.Generator):
            gen = torch.Generator().manual_seed(int(gen))
        P, N = int(pop_size), self.num_envs
        learner, env_state, obs = tree_map(_stack, *[self.init_member(gen) for _ in range(P)])
        one = tree_map(lambda x: x[0, 0], obs)
        zero = torch.zeros((), device=self.device)
        example = {"obs": one, "action": self._action_example(), "reward": zero,
                   "next_obs": one, "done": zero, "boundary": zero}
        return ScanMemberState(
            learner=learner, ring=ring_init(example, self.buffer_size, P, self.device),
            env_state=env_state,
            step_count=torch.zeros((P, N), dtype=torch.int32, device=self.device), obs=obs,
            ep_ret=torch.zeros((P, N), device=self.device), tick=0, learn_count=0,
            epsilon=self.eps_start)

    # -- the draws ---------------------------------------------------------- #
    def draw_iteration(self, pop: ScanMemberState, gen: torch.Generator) -> Dict[str, Any]:
        """Every draw of one generation of ``pop``, from ``gen`` (on the
        population's device): ``reset`` (the state and obs each env would
        restart from at each tick, leaves ``[T, P, N, ...]``), ``sample``
        (``[T, P, B]``: PER's uniforms, or ring indices uniform in
        ``[0, size)`` for the fill each tick's sample will see), ``act`` and
        ``learn`` (the algorithm's)."""
        T, N, B = self.steps_per_iter, self.num_envs, self.batch_size
        P = int(pop.ep_ret.shape[0])
        dev = gen.device
        reset = self.env.reset_fn(T * P * N, gen)
        reset = tree_map(lambda x: x.reshape((T, P, N) + tuple(x.shape[1:])), reset)
        if self.per:
            sample = torch.rand((T, P, B), generator=gen, device=dev)
        else:
            size = torch.clamp(pop.ring.size + N * torch.arange(1, T + 1, device=dev),
                               max=self.buffer_size)
            raw = torch.randint(0, 2 ** 62, (T, P, B), generator=gen, device=dev)
            sample = raw % size[:, None, None]
        return {"reset": reset, "sample": sample, "act": self._draw_act(T, P, gen),
                "learn": self._draw_learn(T, P, gen)}

    # -- one generation of every member -------------------------------------- #
    def member_iteration(self, pop: ScanMemberState, draws: Dict[str, Any],
                         gen: Optional[torch.Generator] = None, collect: bool = False):
        """``steps_per_iter`` ticks of every member on ``draws``; returns
        ``(pop, fitness [P])``, and with ``collect`` the per-tick record
        (``member_iteration_debug``). The fitness is the censored return
        mean: finished episodes count their (segment) return, episodes in
        flight at the window's end their partial return, one each."""
        P, N = pop.ep_ret.shape
        unflat = lambda x: x.view((P, N) + tuple(x.shape[1:]))  # noqa: E731
        env_state = tree_map(_flat, pop.env_state)
        count = _flat(pop.step_count)
        learner, ring, obs, ep_ret = pop.learner, pop.ring, pop.obs, pop.ep_ret
        tick, learn_count, eps = pop.tick, pop.learn_count, pop.epsilon
        fsum = torch.zeros(P, device=ep_ret.device)
        fn = torch.zeros(P, device=ep_ret.device)
        record = []
        start = max(self.warmup, self.batch_size)
        for t in range(self.steps_per_iter):
            at = lambda x: x[t]  # noqa: E731
            obs_in = preprocess_observation(self.obs_space, obs)
            action = vmap(functools.partial(self._act, epsilon=eps))(
                self._act_params(learner), obs_in, tree_map(at, draws["act"]))
            vstate, next_obs, reward, term, trunc, final_obs = self._vec_step(
                VecState(env_state, count, gen), _flat(action),
                reset=tree_map(lambda x: _flat(x[t]), draws["reset"]))
            env_state, count = vstate.env_state, vstate.step_count
            reward, term, trunc = unflat(reward).float(), unflat(term), unflat(trunc)
            done = torch.logical_or(term, trunc).float()
            transition = {"obs": obs, "action": action, "reward": reward,
                          # the true successor, before the autoreset
                          "next_obs": tree_map(unflat, final_obs),
                          "done": term.float(), "boundary": done}
            ring = ring_write(ring, transition)
            tick += 1
            do_learn = ring.size >= start and tick % self.learn_every == 0
            loss = None
            if do_learn:
                learn_count += 1
                if self.per:
                    batch, idx, weights = ring_sample_per(ring, draws["sample"][t],
                                                          self.per_beta)
                else:
                    batch, idx, weights = ring_sample_uniform(ring, draws["sample"][t])
                n_batch = (ring_nstep_gather(ring, idx, self.n_step, self.gamma,
                                             stride=self.num_envs)
                           if self.n_step > 1 else None)
                learner, loss, td_abs = self._learn(
                    learner, batch, n_batch, weights, tree_map(at, draws["learn"]),
                    learn_count)
                if self.per:
                    ring = ring_update_priorities(ring, idx, td_abs + self.prior_eps,
                                                  self.per_alpha)
            ep_ret = ep_ret + reward
            fsum = fsum + torch.sum(ep_ret * done, dim=1)
            fn = fn + torch.sum(done, dim=1)
            ep_ret = ep_ret * (1.0 - done)
            eps = max(eps * self.eps_decay, self.eps_end)
            obs = tree_map(unflat, next_obs)
            if collect:
                record.append({"loss": loss, "do_learn": do_learn,
                               "sample": draws["sample"][t], "transition": transition})
        fitness = (fsum + torch.sum(ep_ret, dim=1)) / (fn + N)
        pop = ScanMemberState(learner, ring, tree_map(unflat, env_state), unflat(count), obs,
                              ep_ret, tick, learn_count, eps)
        return (pop, fitness, record) if collect else (pop, fitness)

    def member_iteration_debug(self, pop: ScanMemberState, draws: Dict[str, Any],
                               gen: Optional[torch.Generator] = None):
        """``member_iteration`` that also returns, per tick, the loss (None
        on a tick without a learn), the learn gate, the sample draws and the
        transition written: the cross-tier test replays them through the
        per-agent path."""
        return self.member_iteration(pop, draws, gen, collect=True)

    # -- evolution ----------------------------------------------------------- #
    def evolve(self, pop: ScanMemberState, fitness: torch.Tensor,
               gen: torch.Generator) -> ScanMemberState:
        """Tournament + Gaussian mutation of ``_mutate_fields`` over the
        learners (on the device, draws from ``gen``); rings and env states
        stay with their slot. ``ep_ret`` is zeroed: partial returns of the
        pre-evolution policy do not leak into the next fitness."""
        winners, do_mut = tournament_select(fitness, gen, self.tournament_size, self.elitism,
                                            self.mutation_prob)
        gathered = gather_members(pop.learner, winners)
        updates = {}
        for f in self._mutate_fields:
            tree = getattr(gathered, f)
            updates[f] = gaussian_mutate(tree, mutation_noise(tree, gen), do_mut,
                                         self.mutation_sd)
        return pop._replace(learner=gathered._replace(**updates),
                            ep_ret=torch.zeros_like(pop.ep_ret))

    # -- generation programs -------------------------------------------------- #
    def make_vmap_generation(self) -> Callable:
        """One card: ``pop, fitness = generation(pop, gen)``."""

        def iteration(pop: ScanMemberState, gen: torch.Generator):
            return self.member_iteration(pop, self.draw_iteration(pop, gen), gen)

        return make_vmap_generation(iteration, self.evolve)

    def make_pod_generation(self, *args, **kwargs) -> Callable:
        return make_pod_generation(*args, **kwargs)

    # -- snapshots ------------------------------------------------------------ #
    def state_dict(self, pop: ScanMemberState) -> Dict[str, Any]:
        return population_state_dict(pop)

    def load_state_dict(self, pop: ScanMemberState, blob: Dict[str, Any]) -> ScanMemberState:
        return population_load_state_dict(pop, blob)


# --------------------------------------------------------------------------- #
# Population snapshots
# --------------------------------------------------------------------------- #


def population_state_dict(pop: PyTree) -> Dict[str, Any]:
    """Host capture of a stacked population: every leaf, in ``tree_leaves``
    order, as a numpy array (a host integer as a 0-d array)."""
    return {"leaves": [x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x) for x in tree_leaves(pop)]}


def population_load_state_dict(pop: PyTree, blob: Dict[str, Any]) -> PyTree:
    """Rebuild a population from ``population_state_dict`` with ``pop`` (a
    live population of the same program) as the template: bit-exact, each
    tensor leaf on its template's device and dtype. Raises ``ValueError`` on
    a leaf count or shape that differs."""
    live, saved = tree_leaves(pop), blob["leaves"]
    if len(saved) != len(live):
        raise ValueError(f"snapshot has {len(saved)} leaves, live population has {len(live)}")
    out = []
    for leaf, s in zip(live, saved):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if shape != tuple(np.shape(s)):
            raise ValueError(f"snapshot leaf shape {np.shape(s)} != live {shape}")
        if isinstance(leaf, torch.Tensor):
            out.append(torch.from_numpy(np.array(s)).to(device=leaf.device, dtype=leaf.dtype))
        else:
            out.append(type(leaf)(np.asarray(s).item()))
    it = iter(out)
    return tree_map(lambda _: next(it), pop)


# --------------------------------------------------------------------------- #
# ScanRun: the host handle
# --------------------------------------------------------------------------- #


class ScanRun:
    """Drives a population program from the host: ``run(N)`` is N
    generations, each one call of the engine's generation function. It
    reads the fitness once per generation (its one host sync), ticks the
    telemetry's ``StepTimeline`` with the generation's env steps and the
    ``fitness_best`` / ``fitness_mean`` / ``generation_time_s`` metrics, and
    duck-types the resilience capture protocol (``checkpoint_dict`` /
    ``_restore`` / ``rng_state`` / ``set_rng_state``; the generator's state
    travels as a numpy byte array with its device type), so
    ``Resilience.attach(pop=[run])`` snapshots and resumes it."""

    def __init__(self, engine, pop_size: int, seed: int = 0, mesh=None, telemetry=None,
                 index: int = 0, plan=None):
        if mesh is not None or plan is not None:
            raise NotImplementedError(_POD.format("ScanRun(mesh=, plan=)"))
        self.engine = engine
        self.pop_size = int(pop_size)
        self.telemetry = telemetry
        self.index = index
        self._gen = torch.Generator(device=engine.device).manual_seed(int(seed))
        init = torch.Generator().manual_seed(int(seed))
        self.pop = engine.init_population(init, self.pop_size)
        self.generation = 0
        self.fitness_history: list = []
        self._gen_fn: Optional[Callable] = None

    def _generation_fn(self) -> Callable:
        if self._gen_fn is None:
            self._gen_fn = self.engine.make_vmap_generation()
        return self._gen_fn

    def run(self, generations: int) -> np.ndarray:
        """N generations; returns this call's ``[N, P]`` fitness history (also
        appended to ``fitness_history``)."""
        gen = self._generation_fn()
        steps = self.pop_size * self.engine.env_steps_per_generation
        out = []
        for _ in range(int(generations)):
            t0 = time.perf_counter()
            self.pop, fitness = gen(self.pop, self._gen)
            fitness = fitness.cpu().numpy()
            dt = time.perf_counter() - t0
            self.generation += 1
            out.append(fitness)
            self.fitness_history.append(fitness.tolist())
            if self.telemetry is not None:
                self.telemetry.step(env_steps=steps, metrics={
                    "fitness_best": float(fitness.max()),
                    "fitness_mean": float(fitness.mean()),
                    "generation_time_s": dt,
                })
        return np.asarray(out)

    # -- resilience capture protocol ---------------------------------------- #
    def checkpoint_dict(self) -> Dict[str, Any]:
        return {
            "agilerl_tpu_torch_class": type(self).__name__,
            "pop_size": self.pop_size,
            "generation": self.generation,
            "fitness_history": list(self.fitness_history),
            "pop": population_state_dict(self.pop),
        }

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        if int(ckpt["pop_size"]) != self.pop_size:
            raise ValueError(f"snapshot pop_size {ckpt['pop_size']} != live {self.pop_size}")
        self.pop = population_load_state_dict(self.pop, ckpt["pop"])
        self.generation = int(ckpt["generation"])
        self.fitness_history = list(ckpt["fitness_history"])

    def rng_state(self) -> Dict[str, Any]:
        blob = generator_to_host(self._gen)
        return {"key": blob["state"], "device": blob["device"]}

    def set_rng_state(self, state: Dict[str, Any]) -> None:
        """Raises when the state was taken from a generator of another
        device type (a card run's into a CPU run, or back)."""
        generator_from_host(self._gen, {"device": state["device"], "state": state["key"]})
