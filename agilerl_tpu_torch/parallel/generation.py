"""The on-policy half of the generation engine: the port of
``agilerl_tpu/parallel/generation.py`` (evolution as array ops, the
one-card generation contract, population snapshots and ``ScanRun``).

A population is a tree whose tensor leaves are stacked ``[P, ...]`` over
its members. Evolution splits into draws and a pure part: the draws come
from an explicit ``torch.Generator`` (``tournament_select``,
``mutation_noise``), and ``apply_evolution`` is a function of the
population and those draws alone, so the same draws give the same
population on any device. A leaf that is not a tensor (Adam's step count,
one host integer: every member takes the same number of steps) is the same
for every member, and the gather keeps it as it is.

``make_pod_generation`` and ``ScanRun(mesh=, plan=)`` (a population sharded
over several cards) come with Queue 1's slice 6; ``DeviceReplayRing``,
``ScanOffPolicy`` and the ring helpers with slice 5c-scan, over the replay
buffers of ``components/replay_buffer.py``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

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
# The off-policy scan tier (Queue 1's slice 5c-scan)
# --------------------------------------------------------------------------- #

_OFF_POLICY = ("{} (the off-policy scan tier) comes with Queue 1's slice 5c-scan, which "
               "stacks the replay buffers of components/replay_buffer.py over a population")


class DeviceReplayRing:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_OFF_POLICY.format("DeviceReplayRing"))


class ScanOffPolicy:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_OFF_POLICY.format("ScanOffPolicy"))


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
    travels as a numpy byte array)."""

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
            "agilerl_tpu_class": type(self).__name__,
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
        return {"key": self._gen.get_state().numpy().copy()}

    def set_rng_state(self, state: Dict[str, Any]) -> None:
        self._gen.set_state(torch.from_numpy(np.asarray(state["key"], dtype=np.uint8).copy()))
