"""Offline datasets: the port of ``agilerl_tpu/utils/minari_utils.py`` (the
reference's h5 schema through h5py, the Minari on-disk layout read without
the minari package, a dataset into a replay buffer, and
``collect_offline_dataset``).

h5py is imported inside the functions that read or write a file (the
card's machine has none). ``_resolve_minari_path`` looks only at local
directories; a dataset id with no local file raises (the port downloads
nothing: where the JAX package would hand the id to ``minari.load_dataset``,
the port asks for a file or ``collect_offline_dataset``).

``collect_offline_dataset`` on a ``TorchVecEnv`` (or a device env, which it
vectorises on ``device``: the card when None) keeps every row on the env's
device and reads the whole dataset back once, at the end. Its action draws
are the JAX package's (one numpy stream from ``seed``). The stored
successor is the step's ``final_obs`` (the obs before the autoreset) and
``terminals`` flags termination only. Every function returns numpy arrays.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

_KEYS = ("observations", "actions", "rewards", "next_observations", "terminals")


def load_h5_dataset(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """An offline dataset with observations / actions / rewards /
    next_observations / terminals arrays (the reference's h5 schema); a
    file without next_observations gets each row's successor, the last row
    repeated."""
    import h5py

    out: Dict[str, np.ndarray] = {}
    with h5py.File(path, "r") as f:
        for key in _KEYS:
            if key in f:
                out[key] = np.asarray(f[key])
    if "next_observations" not in out and "observations" in out:
        obs = out["observations"]
        out["next_observations"] = np.concatenate([obs[1:], obs[-1:]], axis=0)
    return out


def save_h5_dataset(path: Union[str, Path], dataset: Dict[str, Any]) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for k, v in dataset.items():
            f.create_dataset(k, data=np.asarray(v))


def read_minari_h5(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """The Minari on-disk layout: one ``episode_<i>`` group per episode with
    observations (one row longer than the rest), actions, rewards and
    terminations."""
    import h5py

    obs, act, rew, next_obs, term = [], [], [], [], []
    with h5py.File(path, "r") as f:
        names = sorted((k for k in f.keys() if k.startswith("episode_")),
                       key=lambda s: int(s.rsplit("_", 1)[1]))
        if not names:
            raise ValueError(f"{path}: no episode_<i> groups; not a minari file")
        for name in names:
            g = f[name]
            o = np.asarray(g["observations"])
            obs.append(o[:-1])
            next_obs.append(o[1:])
            act.append(np.asarray(g["actions"]))
            rew.append(np.asarray(g["rewards"]))
            term.append(np.asarray(g["terminations"]))
    return {
        "observations": np.concatenate(obs),
        "actions": np.concatenate(act),
        "rewards": np.concatenate(rew).astype(np.float32),
        "next_observations": np.concatenate(next_obs),
        "terminals": np.concatenate(term).astype(np.float32),
    }


def _resolve_minari_path(dataset_id: str, data_dir=None) -> Optional[Path]:
    """A dataset's main_data.hdf5 on disk: a direct file path, or
    ``<root>/<id>/data/main_data.hdf5`` under ``data_dir``,
    ``MINARI_DATASETS_PATH`` or ``~/.minari/datasets``; None when absent."""
    direct = Path(dataset_id)
    if direct.is_file():
        return direct
    root = Path(data_dir or os.environ.get("MINARI_DATASETS_PATH",
                                           Path.home() / ".minari" / "datasets"))
    candidate = root / dataset_id / "data" / "main_data.hdf5"
    return candidate if candidate.is_file() else None


def minari_to_agile_dataset(dataset_id: str, data_dir=None, **kwargs) -> Dict[str, np.ndarray]:
    """A Minari dataset on disk, read by ``read_minari_h5``."""
    path = _resolve_minari_path(dataset_id, data_dir)
    if path is None:
        raise FileNotFoundError(
            f"no on-disk dataset for {dataset_id!r}: pass a path to a main_data.hdf5, set "
            "MINARI_DATASETS_PATH, load h5 data with load_h5_dataset, or generate data with "
            "collect_offline_dataset (nothing is downloaded)")
    return read_minari_h5(path)


def minari_to_agile_buffer(dataset_id: str, memory, data_dir=None) -> Any:
    """Fill a replay buffer from a Minari dataset on disk."""
    ds = minari_to_agile_dataset(dataset_id, data_dir=data_dir)
    memory.add({"obs": ds["observations"], "action": ds["actions"], "reward": ds["rewards"],
                "next_obs": ds["next_observations"], "done": ds["terminals"]}, batched=True)
    return memory


def collect_offline_dataset(env, agent=None, steps: int = 10_000, epsilon: float = 0.3,
                            seed: int = 0, num_envs: int = 8,
                            device=None) -> Dict[str, np.ndarray]:
    """Roll a policy (greedy ``agent`` actions, each vector step replaced by
    uniform random ones with probability ``epsilon``; random alone without
    an agent) for ``steps // num_envs`` vector steps. ``env`` is a vector
    env, or a device env (``envs/core.TorchEnv``) run as a ``TorchVecEnv``
    of ``num_envs`` on ``device`` (the card when None, raising without
    one). Returns numpy arrays."""
    from agilerl_tpu_torch.envs.core import TorchEnv, TorchVecEnv

    if isinstance(env, TorchEnv):
        env = TorchVecEnv(env, num_envs=num_envs, seed=seed, device=device)
    rng = np.random.default_rng(seed)
    num_envs = getattr(env, "num_envs", 1)
    env_dev = getattr(env, "device", None)
    on_device = isinstance(env_dev, torch.device)
    sp = getattr(env, "single_action_space", env.action_space)
    rows = {k: [] for k in _KEYS}
    obs, _ = env.reset(seed=seed)
    for _ in range(steps // num_envs):
        if agent is not None and rng.random() > epsilon:
            action = agent.get_action(obs, training=False)
            if not on_device:
                action = np.asarray(action.cpu() if isinstance(action, torch.Tensor) else action)
        else:
            if hasattr(sp, "n"):
                action = rng.integers(0, sp.n, size=num_envs)
            else:
                action = rng.uniform(sp.low, sp.high,
                                     size=(num_envs,) + tuple(sp.shape)).astype(np.float32)
            if on_device:
                action = torch.from_numpy(action).to(env_dev, non_blocking=True)
        next_obs, reward, terminated, truncated, info = env.step(action)
        final = info.get("final_obs", next_obs) if isinstance(info, dict) else next_obs
        for k, v in zip(_KEYS, (obs, action, reward, final, terminated)):
            rows[k].append(v)
        obs = next_obs
    if on_device:
        out = {k: torch.cat([torch.as_tensor(x, device=env_dev) for x in v]).cpu().numpy()
               for k, v in rows.items()}
    else:
        out = {k: np.concatenate([np.asarray(x) for x in v]) for k, v in rows.items()}
    out["rewards"] = out["rewards"].astype(np.float32)
    out["terminals"] = out["terminals"].astype(np.float32)
    return out
