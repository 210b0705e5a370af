"""Population factory, env maker, evolution glue and population
checkpoints: the port of ``agilerl_tpu/utils/utils.py`` for GRPO, DPO, PPO,
DQN, RainbowDQN, CQN, DDPG and TD3 (``create_population``, ``make_vect_envs``,
``tournament_selection_and_mutation`` with ``save_elite``,
``save_population_checkpoint``, ``resume_population_from_checkpoint``,
``load_population_checkpoint``, ``consolidate_mutations``,
``print_hyperparams``). The other algorithms come with their slices."""

from __future__ import annotations

import importlib
import inspect
import pickle
import zlib
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from agilerl_tpu_torch.utils.rng import derive_rng

# the JAX package's INIT_HP key -> constructor kwarg map (each algorithm
# takes the keys its constructor names)
_INIT_HP_MAP = {
    "BATCH_SIZE": "batch_size", "LR": "lr", "LR_ACTOR": "lr_actor", "LR_CRITIC": "lr_critic",
    "GAMMA": "gamma", "TAU": "tau", "LEARN_STEP": "learn_step", "DOUBLE": "double",
    "N_STEP": "n_step", "PER": "per", "NUM_ATOMS": "num_atoms", "V_MIN": "v_min",
    "V_MAX": "v_max", "CLIP_COEF": "clip_coef", "ENT_COEF": "ent_coef", "VF_COEF": "vf_coef",
    "MAX_GRAD_NORM": "max_grad_norm", "UPDATE_EPOCHS": "update_epochs",
    "GAE_LAMBDA": "gae_lambda", "TARGET_KL": "target_kl", "POLICY_FREQ": "policy_freq",
    "O_U_NOISE": "O_U_noise", "EXPL_NOISE": "expl_noise", "MEAN_NOISE": "mean_noise",
    "THETA": "theta", "DT": "dt", "NUM_ENVS": "num_envs", "AGENT_IDS": "agent_ids",
    "LAMBDA": "lamb", "REG": "reg",
}


def _named_ctor_params(cls) -> set:
    """Named constructor parameters across the class's MRO."""
    named = set()
    for c in cls.__mro__:
        init = c.__dict__.get("__init__")
        if init is None:
            continue
        for p in inspect.signature(init).parameters.values():
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                named.add(p.name)
    return named


# the algorithms ported so far, by name -> module of agilerl_tpu_torch.algorithms
_ALGO_MODULES = {"GRPO": "grpo", "DPO": "dpo", "PPO": "ppo", "DQN": "dqn",
                 "RainbowDQN": "dqn_rainbow", "CQN": "cqn", "DDPG": "ddpg", "TD3": "td3"}


def _algo_class(algo: str):
    if algo not in _ALGO_MODULES:
        raise NotImplementedError(
            f"create_population is ported for {', '.join(_ALGO_MODULES)}, not {algo!r}")
    return getattr(importlib.import_module(
        f"agilerl_tpu_torch.algorithms.{_ALGO_MODULES[algo]}"), algo)


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
    """Build a population of GRPO, DPO, PPO, DQN, RainbowDQN, CQN, DDPG or
    TD3 agents. Each member gets the ``INIT_HP`` keys its constructor names, and
    ``observation_space``, ``action_space``, ``net_config`` and ``num_envs``
    where it names them. ``kwargs`` go to every member (GRPO/DPO: ``config``,
    ``base_params``, token ids, ...; pass ``base_params`` to share one frozen
    base model). Each member's seed is drawn from ``seed`` (or the global
    numpy stream), as in the JAX package; ``device=None`` puts every member
    on the card."""
    cls = _algo_class(algo)
    INIT_HP = dict(INIT_HP or {})
    pop_size = population_size or INIT_HP.get("POP_SIZE", INIT_HP.get("POPULATION_SIZE", 4))
    named = _named_ctor_params(cls)
    ctor_kwargs = {_INIT_HP_MAP[k]: v for k, v in INIT_HP.items()
                   if _INIT_HP_MAP.get(k) in named}
    ctor_kwargs.update(kwargs)
    if "num_envs" in named:
        ctor_kwargs.setdefault("num_envs", num_envs)
    ctor_kwargs.update({k: v for k, v in (("observation_space", observation_space),
                                          ("action_space", action_space),
                                          ("net_config", net_config)) if k in named})
    rng = derive_rng(seed=seed)
    return [cls(index=idx, hp_config=hp_config, device=device,
                seed=int(rng.integers(0, 2**31 - 1)), **ctor_kwargs)
            for idx in range(pop_size)]


def make_vect_envs(
    env_name: Optional[str] = None,
    num_envs: int = 1,
    *,
    make_env: Optional[Any] = None,
    should_async_vector: bool = True,
    prefer_device: bool = True,
    device=None,
    seed: int = 0,
    **env_kwargs,
):
    """Vectorised envs: an id of the port's registry (``envs/classic.py``)
    becomes a ``TorchVecEnv`` on ``device`` (``None``: the card, raising
    without one); any other id, or ``make_env``, goes through gymnasium's
    vector envs on the host (gymnasium is imported only then)."""
    if make_env is None and prefer_device and env_name is not None:
        from agilerl_tpu_torch.envs import classic

        if env_name in classic.REGISTRY:
            from agilerl_tpu_torch.envs.core import TorchVecEnv

            return TorchVecEnv(classic.make(env_name), num_envs=num_envs, seed=seed,
                               device=device)
    import gymnasium as gym

    if make_env is not None:
        fns = [make_env for _ in range(num_envs)]
    else:
        fns = [lambda: gym.make(env_name, **env_kwargs) for _ in range(num_envs)]
    vec_cls = gym.vector.AsyncVectorEnv if should_async_vector else gym.vector.SyncVectorEnv
    return vec_cls(fns)


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
    """select -> mutate -> with ``save_elite``, checkpoint the elite at
    ``elite_path`` (a directory, or a path without a suffix, gets
    ``{algo}_elite.ckpt``). ``lineage`` attaches to both engines for this
    call."""
    if lineage is not None:
        tournament.lineage = lineage
        mutation.lineage = lineage
    elite, population = tournament.select(population)
    population = mutation.mutation(population)
    if save_elite and elite_path is not None:
        path = Path(elite_path)
        if path.suffix == "":
            path = path / f"{algo or elite.algo}_elite.ckpt"
        elite.save_checkpoint(path)
    return population


def _member_path(save_path: str, index: int, suffix_step: Optional[int] = None) -> Path:
    p = Path(save_path)
    stem = f"{p.stem}_{index}" if suffix_step is None else f"{p.stem}_{index}_step{suffix_step}"
    return p.parent / f"{stem}{p.suffix or '.ckpt'}"


def save_population_checkpoint(population: List, save_path: str,
                               overwrite_checkpoints: bool = True, accelerator=None) -> None:
    """Checkpoint every member at ``{stem}_{index}{suffix}``; without
    ``overwrite_checkpoints`` the member's step count joins the name, so the
    history is kept."""
    for agent in population:
        agent.save_checkpoint(_member_path(
            save_path, agent.index, None if overwrite_checkpoints else agent.steps[-1]))


def resume_population_from_checkpoint(pop: List, checkpoint_path: Optional[str]) -> List:
    """Restore each member in place from its ``{stem}_{index}`` file where
    one exists (members without one keep their fresh weights). A torn or
    incompatible file is skipped with a warning, the member rolled back to
    its weights from before the attempt."""
    if checkpoint_path is None:
        return pop
    from agilerl_tpu_torch.observability import warn_once

    for agent in pop:
        f = _member_path(checkpoint_path, agent.index)
        if not f.exists():
            continue
        before = agent.checkpoint_dict()
        try:
            agent.load_checkpoint(f)
        except (pickle.UnpicklingError, EOFError, OSError, AttributeError, KeyError,
                IndexError, ValueError, ImportError) as e:
            try:
                agent._restore(before)
                detail = f"agent {agent.index} keeps its current weights"
            except Exception:
                detail = f"agent {agent.index} could not be rolled back and may be inconsistent"
            warn_once(f"resume:corrupt_checkpoint:{f.name}",
                      f"skipping corrupt/torn checkpoint {f} ({type(e).__name__}: {e}): {detail}")
    return pop


def load_population_checkpoint(algo: str, save_path: str, indices: List[int],
                               device=None, **kwargs) -> List:
    """Agents rebuilt from their ``{stem}_{index}`` checkpoints on
    ``device`` (``None`` means the card, as in ``load``)."""
    cls = _algo_class(algo)
    return [cls.load(_member_path(save_path, idx), device=device) for idx in indices]


def print_hyperparams(population: List) -> None:
    """Log per-agent HPs + fitness."""
    for agent in population:
        hps = {name: getattr(agent, name) for name in agent.hp_config.names()}
        fit = np.mean(agent.fitness[-5:]) if agent.fitness else float("nan")
        print(f"Agent {agent.index}: fitness(5)={fit:.2f} mut={agent.mut} "
              f"steps={agent.steps[-1]} {hps}")
