"""Population factory, env maker, evolution glue and population
checkpoints: the port of ``agilerl_tpu/utils/utils.py`` (whole) for GRPO, DPO, PPO,
DQN, RainbowDQN, CQN, DDPG, TD3, MADDPG, MATD3, IPPO, NeuralUCB and NeuralTS
(``create_population``,
``make_vect_envs``, ``tournament_selection_and_mutation`` with
``save_elite``, ``save_population_checkpoint``,
``resume_population_from_checkpoint``, ``load_population_checkpoint``,
``consolidate_mutations``, ``print_hyperparams``, ``get_algo_class``), the
multi-agent info helpers (``get_env_defined_actions``,
``extract_action_masks``, ``process_ma_infos``,
``apply_env_defined_actions``, ``forced_action_arrays``),
``make_multi_agent_vect_envs`` (the PettingZoo vector envs) and the host
helpers ``make_skill_vect_envs`` (gymnasium, imported at the call),
``observation_space_channels_to_first``, ``calculate_vectorized_scores``,
``plot_population_score`` (matplotlib, imported at the call),
``default_progress_bar`` (tqdm, imported at the call) and ``init_wandb``
(wandb, imported at the call; ``None`` without it). A device env gives
``{}`` infos, for which the helpers do nothing. ``gather_across_hosts`` and
``aggregate_metrics_across_hosts`` return the value itself in one process
and all-gather over ``torch.distributed`` when a process group is up."""

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
                 "RainbowDQN": "dqn_rainbow", "CQN": "cqn", "DDPG": "ddpg", "TD3": "td3",
                 "MADDPG": "maddpg", "MATD3": "matd3", "IPPO": "ippo",
                 "NeuralUCB": "neural_ucb_bandit", "NeuralTS": "neural_ts_bandit"}


def _algo_class(algo: str):
    if algo not in _ALGO_MODULES:
        raise NotImplementedError(
            f"create_population is ported for {', '.join(_ALGO_MODULES)}, not {algo!r}")
    return getattr(importlib.import_module(
        f"agilerl_tpu_torch.algorithms.{_ALGO_MODULES[algo]}"), algo)


def get_algo_class(algo: str):
    """The algorithm class of a name (``"Rainbow DQN"`` is ``RainbowDQN``);
    an unknown name raises ``KeyError`` listing the known ones."""
    name = "RainbowDQN" if algo == "Rainbow DQN" else algo
    if name not in _ALGO_MODULES:
        raise KeyError(f"Unknown algorithm {algo!r}; known: "
                       f"{sorted(list(_ALGO_MODULES) + ['Rainbow DQN'])}")
    return _algo_class(name)


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
    """Build a population of GRPO, DPO, PPO, DQN, RainbowDQN, CQN, DDPG, TD3,
    MADDPG, MATD3, IPPO, NeuralUCB or NeuralTS agents. Each member gets the
    ``INIT_HP`` keys its constructor names (``AGENT_IDS`` as ``agent_ids``), and
    ``observation_space``, ``action_space`` (a multi-agent algorithm's
    ``observation_spaces`` / ``action_spaces``: the per-agent dicts),
    ``net_config`` and ``num_envs`` where it names them. ``kwargs`` go to
    every member (GRPO/DPO: ``config``, ``base_params``, token ids, ...;
    pass ``base_params`` to share one frozen base model). Each member's seed is drawn from ``seed`` (or the global
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
                                          ("observation_spaces", observation_space),
                                          ("action_spaces", action_space),
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


def make_multi_agent_vect_envs(env, num_envs: int = 1, should_async_vector: bool = True,
                               **env_kwargs):
    """``num_envs`` copies of a PettingZoo parallel env, ``env(**env_kwargs)``
    each, vectorised: in worker processes (``AsyncPettingZooVecEnv``) or in
    this one (``PettingZooVecEnv``). The factory is bound with
    ``functools.partial``, which the async env's ``spawn`` workers can
    unpickle when ``env`` is a module-level class or function (the JAX
    package binds a lambda)."""
    import functools

    from agilerl_tpu_torch.vector import AsyncPettingZooVecEnv, PettingZooVecEnv

    fns = [functools.partial(env, **env_kwargs) for _ in range(num_envs)]
    return (AsyncPettingZooVecEnv if should_async_vector else PettingZooVecEnv)(fns)


def make_skill_vect_envs(env_name: str, skill, num_envs: int = 1):
    """A gymnasium ``AsyncVectorEnv`` of ``num_envs`` copies of ``env_name``,
    each wrapped in the curriculum ``skill`` (``wrappers/learning.Skill``);
    gymnasium is imported here."""
    import gymnasium as gym

    return gym.vector.AsyncVectorEnv(
        [lambda: skill(gym.make(env_name)) for _ in range(num_envs)])


def observation_space_channels_to_first(observation_space):
    """An image space's ``[H, W, C]`` as ``[C, H, W]``, through ``Dict`` and
    ``Tuple`` spaces; other spaces are returned as they are. The port's CNN
    is NHWC, so this serves channels-first torch policies (``MakeEvolvable``)
    and configs that set ``swap_channels``. Works on the port's spaces and
    on gymnasium's (the result is of the input's classes)."""
    from agilerl_tpu_torch.utils.spaces import space_kind

    kind = space_kind(observation_space)
    if kind == "dict":
        return type(observation_space)(
            {k: observation_space_channels_to_first(v)
             for k, v in observation_space.spaces.items()})
    if kind == "tuple":
        return type(observation_space)(
            tuple(observation_space_channels_to_first(s) for s in observation_space.spaces))
    if kind == "box" and len(observation_space.shape) == 3:
        return type(observation_space)(low=np.moveaxis(observation_space.low, -1, 0),
                                       high=np.moveaxis(observation_space.high, -1, 0),
                                       dtype=observation_space.dtype)
    return observation_space


def calculate_vectorized_scores(rewards: np.ndarray, terminations: np.ndarray,
                                include_unterminated: bool = False,
                                only_first_episode: bool = True) -> List[float]:
    """Episode scores from per-env reward rows ``[num_envs, T]``, cut at
    termination points: each env's first episode (or, with
    ``only_first_episode=False``, every one, and with
    ``include_unterminated`` the unfinished tail too); an env that never
    terminates scores its whole row."""
    rewards, terminations = np.asarray(rewards), np.asarray(terminations)
    episode_rewards: List[float] = []
    for env_index in range(rewards.shape[0]):
        term_idx = np.where(terminations[env_index] == 1)[0]
        if len(term_idx) == 0:
            episode_rewards.append(float(np.sum(rewards[env_index])))
            continue
        start = 0
        for t in term_idx:
            episode_rewards.append(float(np.sum(rewards[env_index, start:t + 1])))
            start = t + 1
            if only_first_episode:
                break
        if include_unterminated and not only_first_episode and start < rewards.shape[1]:
            episode_rewards.append(float(np.sum(rewards[env_index, start:])))
    return episode_rewards


def plot_population_score(pop, path: Optional[str] = None):
    """Each agent's fitness history as one curve (matplotlib, imported here;
    None when it is not installed). Saved to ``path`` when given."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, ax = plt.subplots()
    for agent in pop:
        ax.plot(agent.fitness, label=f"agent {agent.index}")
    ax.set_xlabel("evaluation")
    ax.set_ylabel("fitness")
    ax.legend()
    if path:
        fig.savefig(path)
    return fig


def default_progress_bar(total: int, desc: str = ""):
    """A tqdm ``trange`` (imported here), or a plain ``range`` without tqdm."""
    try:
        from tqdm import trange

        return trange(total, desc=desc)
    except ImportError:
        return range(total)


def init_wandb(project: str = "agilerl-tpu", config: Optional[dict] = None, **kwargs):
    """The ``wandb`` module after ``wandb.init``, or ``None`` when wandb does
    not import (or its init fails): the loops then log to their event sink
    only."""
    try:
        import wandb

        wandb.init(project=project, config=config, **kwargs)
        return wandb
    except Exception:
        return None


def _process_group():
    """The default process group's world size, or 1 without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def gather_across_hosts(value) -> np.ndarray:
    """All-gather a host-local scalar or array across processes, stacked on
    a leading process axis (``[1, ...]`` in one process).

    Deliberately not retried: a per-process retry of a collective pairs the
    retrying process with the wrong collective of its peers. Collectives fail
    fast; snapshot-resume is the recovery path."""
    arr = np.asarray(value)
    world = _process_group()
    if world == 1:
        return arr[None]
    import torch.distributed as dist

    gathered = [None] * world
    dist.all_gather_object(gathered, arr)
    return np.stack([np.asarray(g) for g in gathered])


def aggregate_metrics_across_hosts(value: float) -> float:
    """The mean of a host scalar over processes (the value itself in one
    process); not retried, as ``gather_across_hosts``."""
    if _process_group() == 1:
        return float(value)
    return float(np.mean(gather_across_hosts(np.asarray([value], np.float64))))


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
        # the rollback needs no frozen LLM base (``_restore`` ignores init_dict)
        before = (agent.checkpoint_dict(include_base=False)
                  if getattr(agent, "base_params", None) is not None
                  else agent.checkpoint_dict())
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


# --------------------------------------------------------------------------- #
# Multi-agent info helpers
# --------------------------------------------------------------------------- #


def get_env_defined_actions(info: Dict[str, Any], agents) -> Optional[Dict[str, Any]]:
    """Per-agent env-dictated actions of a PettingZoo info dict; None when
    no agent has one."""
    eda = {agent: info.get(agent, {}).get("env_defined_action", None) for agent in agents}
    if all(v is None for v in eda.values()):
        return None
    return eda


def extract_action_masks(info: Dict[str, Any], agents) -> Optional[Dict[str, Any]]:
    """Per-agent invalid-action masks of a PettingZoo info dict; None when
    absent."""
    masks = {agent: info.get(agent, {}).get("action_mask", None) for agent in agents}
    if all(v is None for v in masks.values()):
        return None
    return masks


def process_ma_infos(infos: Optional[Dict[str, Any]], agent_ids, device=None):
    """(action masks, env-defined actions) of a PettingZoo info dict: masks
    as ``[B, n]`` tensors on ``device`` (at least 2-D) or None per agent;
    ``(None, None)`` for an empty info (a device env's)."""
    if not infos:
        return None, None
    import torch

    masks = None
    raw_masks = extract_action_masks(infos, agent_ids)
    if raw_masks is not None:
        masks = {}
        for a in agent_ids:
            m = raw_masks[a]
            if m is not None:
                m = m if isinstance(m, torch.Tensor) else torch.as_tensor(np.asarray(m))
                m = m.to(device) if device is not None else m
                m = m[None] if m.dim() < 2 else m
            masks[a] = m
    return masks, get_env_defined_actions(infos, agent_ids)


def _apply_eda_np(forced, cur: np.ndarray) -> np.ndarray:
    if isinstance(forced, np.ma.MaskedArray):
        keep = np.ma.getmaskarray(forced)
        vals = np.broadcast_to(forced.filled(0), cur.shape)
        return np.where(np.broadcast_to(keep, cur.shape), cur, vals.astype(cur.dtype))
    forced_arr = np.asarray(forced)
    if forced_arr.dtype.kind == "f" and np.isnan(forced_arr).any():
        vals = np.broadcast_to(forced_arr, cur.shape)
        return np.where(np.isnan(vals), cur, np.nan_to_num(vals).astype(cur.dtype))
    return np.broadcast_to(forced_arr.astype(cur.dtype), cur.shape).copy()


def apply_env_defined_actions(eda: Optional[Dict[str, Any]], out: Dict[str, Any]
                              ) -> Dict[str, Any]:
    """Overwrite policy actions with env-dictated ones, row by row: a numpy
    masked array forces its unmasked rows, a float array with NaN its
    non-NaN rows, anything else every row. An action tensor is read to the
    host for it and written back to its device (one host read per forced
    agent: only host PettingZoo envs dictate actions)."""
    if eda is None:
        return out
    out = dict(out)
    for a, forced in eda.items():
        if forced is None:
            continue
        cur = out[a]
        if hasattr(cur, "detach"):
            import torch

            host = _apply_eda_np(forced, cur.detach().cpu().numpy())
            out[a] = torch.as_tensor(host, device=cur.device)
        else:
            out[a] = _apply_eda_np(forced, np.asarray(cur))
    return out


def forced_action_arrays(eda: Optional[Dict[str, Any]], agent_ids, batch: int,
                         action_spaces=None):
    """Env-defined actions as per-agent host ``(values, valid)`` pairs of
    the action's shape, to be resolved inside an on-policy act before the
    log-prob (valid element-wise: a NaN or masked component keeps the
    policy's component). ``action_spaces`` fixes the target shape as
    ``(batch,) + the space's action dims``. None when nothing is forced."""
    if eda is None:
        return None
    from agilerl_tpu_torch.utils.spaces import space_kind

    def space_trailing(space):
        if space is None:
            return None
        kind = space_kind(space)
        if kind == "multidiscrete":
            return (len(space.nvec),)
        if kind in ("box", "multibinary"):
            return tuple(space.shape)
        return ()

    def row_shape(arr, trailing):
        if trailing is not None:
            return (batch,) + trailing
        if arr.ndim == 0:
            return (batch,)
        if arr.shape[0] == batch:
            return arr.shape
        return (batch,) + arr.shape

    out = {}
    for a in agent_ids:
        forced = eda.get(a)
        if forced is None:
            continue
        trailing = space_trailing(action_spaces.get(a) if action_spaces else None)
        if isinstance(forced, np.ma.MaskedArray):
            arr = np.asarray(forced.filled(0))
            invalid = np.ma.getmaskarray(forced)
        else:
            arr = np.asarray(forced)
            invalid = np.isnan(arr) if arr.dtype.kind == "f" else np.zeros(arr.shape, bool)
        tgt = row_shape(arr, trailing)
        # a [B, 1] column against a scalar-per-row target drops its unit dims
        while arr.ndim > len(tgt) and arr.shape[-1] == 1:
            arr, invalid = arr[..., 0], invalid[..., 0]
        try:
            vals = np.broadcast_to(arr, tgt).copy()
        except ValueError:
            raise ValueError(
                f"env_defined_action for {a!r} has shape {np.asarray(forced).shape}, "
                f"incompatible with the action target shape {tgt}") from None
        if vals.dtype.kind == "f":
            vals = np.nan_to_num(vals)
        out[a] = (vals, (~np.broadcast_to(invalid, tgt)).copy())
    return out if out else None
