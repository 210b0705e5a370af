"""Population factory and evolution glue: the port of the LLM half of
``agilerl_tpu/utils/utils.py`` (``create_population``,
``tournament_selection_and_mutation``, ``consolidate_mutations``,
``print_hyperparams``). The other algorithms, env makers and population
checkpoints come with their slices."""

from __future__ import annotations

import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_rng

# the JAX package's INIT_HP upper-case keys that name a GRPO/DPO constructor kwarg
_INIT_HP_MAP = {
    "BATCH_SIZE": "batch_size",
    "LR": "lr",
    "CLIP_COEF": "clip_coef",
    "MAX_GRAD_NORM": "max_grad_norm",
    "UPDATE_EPOCHS": "update_epochs",
}


def create_population(
    algo: str,
    observation_space=None,
    action_space=None,
    net_config: Optional[Dict[str, Any]] = None,
    INIT_HP: Optional[Dict[str, Any]] = None,
    hp_config=None,
    population_size: Optional[int] = None,
    num_envs: int = 1,
    device=None,
    accelerator=None,
    seed: Optional[int] = None,
    **kwargs,
) -> List:
    """Build a population of GRPO or DPO agents. ``kwargs`` go to every member
    (``config``, ``base_params``, token ids, ...); pass ``base_params`` to
    share one frozen base model across the population. Each member's seed is
    drawn from ``seed`` (or the global numpy stream), as in the JAX package."""
    if algo == "GRPO":
        from agilerl_tpu_torch.algorithms.grpo import GRPO as cls
    elif algo == "DPO":
        from agilerl_tpu_torch.algorithms.dpo import DPO as cls
    else:
        raise NotImplementedError(
            f"create_population is ported for GRPO and DPO only, not {algo!r}")

    INIT_HP = dict(INIT_HP or {})
    pop_size = population_size or INIT_HP.get("POP_SIZE", INIT_HP.get("POPULATION_SIZE", 4))
    ctor_kwargs = {_INIT_HP_MAP[k]: v for k, v in INIT_HP.items() if k in _INIT_HP_MAP}
    ctor_kwargs.update(kwargs)
    rng = derive_rng(seed=seed)
    return [cls(index=idx, hp_config=hp_config, device=device,
                 seed=int(rng.integers(0, 2**31 - 1)), **ctor_kwargs)
            for idx in range(pop_size)]


def consolidate_mutations(population: List) -> None:
    """Cross-process mutation-consistency check: every process runs the same
    seeded RNG, so the decisions are already identical; this verifies it
    (over ``torch.distributed`` when a process group is up) and raises on
    divergence. A single process has nothing to check."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return
    # not Python hash(): str hashing is salted per process
    local = [zlib.crc32(repr((agent.index, getattr(agent, "mut", None))).encode())
             for agent in population]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    if any(g != gathered[0] for g in gathered):
        raise RuntimeError("mutation decisions diverged across processes: the "
                           f"replicated-RNG invariant is broken (digests: {gathered})")


def tournament_selection_and_mutation(
    population: List,
    tournament,
    mutation,
    env_name: Optional[str] = None,
    algo: Optional[str] = None,
    elite_path: Optional[str] = None,
    save_elite: bool = False,
    accelerator=None,
    language_model: bool = False,
    lineage=None,
) -> List:
    """select -> mutate. ``lineage`` attaches to both engines for this call.
    Saving the elite needs checkpoints, which are not ported yet."""
    if save_elite:
        raise NotImplementedError("saving the elite needs checkpoints, not ported yet")
    if lineage is not None:
        tournament.lineage = lineage
        mutation.lineage = lineage
    _, population = tournament.select(population)
    return mutation.mutation(population)


def print_hyperparams(population: List) -> None:
    """Log per-agent HPs + fitness."""
    for agent in population:
        hps = {name: getattr(agent, name) for name in agent.hp_config.names()}
        fit = np.mean(agent.fitness[-5:]) if agent.fitness else float("nan")
        print(f"Agent {agent.index}: fitness(5)={fit:.2f} mut={agent.mut} "
              f"steps={agent.steps[-1]} {hps}")
