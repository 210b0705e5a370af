"""PettingZoo parallel-env vectorisation, synchronous: the port of
``agilerl_tpu/vector/pz_vec_env.py`` (``PettingZooVecEnv`` and
``sanitize_ma_transition``).

``PettingZooVecEnv`` steps its envs one after another in this process, on
host numpy. Observations are stacked leaf by leaf, so Dict and Tuple spaces
keep their structure and every leaf its own dtype; an agent missing from an
env's dicts gets the async env's placeholder (NaN for float leaves, 0 for
integer ones; a reward of 0). An env whose agents are all done is reset in
the same step. Spaces are read through ``utils.spaces.space_kind``, so the
port's spaces and gymnasium's both work.

``sanitize_ma_transition``: dead or inactive agents of a PettingZoo vector
env arrive as NaN placeholder observations and rewards; the standard
multi-agent loops have no notion of inactivity, so the placeholders become
zeros before they can reach a buffer or a fitness sum. A device tensor is
cleaned with ``torch.where(torch.isnan(x), 0, x)`` and no host read; a host
array keeps the JAX package's ``np.nan_to_num(x, nan=0.0)`` where it holds a
NaN. The one difference: ``np.nan_to_num`` also clamps +-inf to the dtype's
largest finite values in an array that holds a NaN, where the tensor path
leaves +-inf as it is.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from agilerl_tpu_torch.vector.pz_async_vec_env import (
    _obs_leaves,
    _rebuild_obs,
    _space_leaves,
    placeholder_obs,
)


class PettingZooVecEnv:
    """``len(env_fns)`` PettingZoo parallel envs stepped in this process."""

    def __init__(self, env_fns: List[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)
        e0 = self.envs[0]
        self.agents = list(e0.possible_agents)
        self.possible_agents = list(e0.possible_agents)
        self.observation_spaces = {a: e0.observation_space(a) for a in self.agents}
        self.action_spaces = {a: e0.action_space(a) for a in self.agents}
        self.agent_ids = self.agents
        self._actions = None

    def observation_space(self, agent: str):
        return self.observation_spaces[agent]

    def action_space(self, agent: str):
        return self.action_spaces[agent]

    def _stack_obs(self, obs_list):
        """Per-env observation dicts stacked leaf by leaf (each leaf in its
        space's dtype), placeholders for missing agents."""
        out = {}
        for a in self.agents:
            space = self.observation_spaces[a]
            rows = [_obs_leaves(space, o[a]) if isinstance(o, dict) and o.get(a) is not None
                    else _obs_leaves(space, placeholder_obs(space)) for o in obs_list]
            leaves = [np.stack([np.asarray(r[li], dtype).reshape(shape) for r in rows])
                      for li, (_, dtype, shape) in enumerate(_space_leaves(space))]
            out[a] = _rebuild_obs(space, leaves)
        return out

    def reset(self, seed: Optional[int] = None, options=None):
        obs_list = []
        for i, e in enumerate(self.envs):
            obs, _ = e.reset(seed=None if seed is None else seed + i, options=options)
            obs_list.append(obs)
        return self._stack_obs(obs_list), {}

    def step_async(self, actions: Dict[str, np.ndarray]) -> None:
        self._actions = actions

    def step_wait(self):
        obs_l, rew_l, term_l, trunc_l = [], [], [], []
        for i, e in enumerate(self.envs):
            # a Discrete agent's action as a Python int, as gymnasium steps it
            act_i = {a: np.asarray(self._actions[a])[i] for a in self.agents}
            act_i = {a: int(v) if np.ndim(v) == 0 and hasattr(self.action_spaces[a], "n")
                     else v for a, v in act_i.items()}
            obs, rew, term, trunc, _ = e.step(act_i)
            if not e.agents:  # the episode is over: autoreset
                obs, _ = e.reset()
            obs_l.append(obs)
            rew_l.append(rew)
            term_l.append(term)
            trunc_l.append(trunc)

        def stack(dicts, default=0.0):
            return {a: np.stack([np.asarray(d.get(a, default)) for d in dicts])
                    for a in self.agents}

        return (self._stack_obs(obs_l), stack(rew_l), stack(term_l, False),
                stack(trunc_l, False), {})

    def step(self, actions):
        self.step_async(actions)
        return self.step_wait()

    def close(self):
        for e in self.envs:
            e.close()


def _clean(v):
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_clean(x) for x in v)
    if isinstance(v, torch.Tensor):
        if not v.is_floating_point():
            return v
        return torch.where(torch.isnan(v), torch.zeros((), dtype=v.dtype, device=v.device), v)
    arr = np.asarray(v)
    if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
        return np.nan_to_num(arr, nan=0.0)
    return v


def sanitize_ma_transition(obs_dict, reward_dict):
    """(obs, rewards) with every NaN placeholder replaced by zero."""
    return ({a: _clean(v) for a, v in obs_dict.items()},
            {a: _clean(v) for a, v in reward_dict.items()})
