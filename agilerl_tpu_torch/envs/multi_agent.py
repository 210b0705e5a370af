"""Multi-agent environments on the device: the port of
``agilerl_tpu/envs/multi_agent.py``.

``SimpleSpreadTorch`` (the JAX ``SimpleSpreadJax``): N agents on a plane
must cover N landmarks. Each agent observes its position and the offsets of
every landmark from it (``[pos, landmark offsets]``); a move is 0.1 per
step (Discrete(5): stay, left, right, down, up; or a Box(2) direction
clipped to +-1), positions are clipped to +-1.5, every agent gets the
shared reward ``-sum over landmarks of the nearest agent's distance``, and
an episode is truncated at ``max_steps``. Written batched over ``[N]``
tensors (``reset_fn(n, gen)``, ``step_fn(state, actions, gen)`` with a dict
of per-agent ``[N, ...]`` actions), as ``envs/classic.py``.

``MultiAgentTorchVecEnv`` (``MultiAgentJaxVecEnv``) is the
PettingZoo-parallel-like dict API over such an env: its state lives on its
device, its resets are drawn from its generator, ``reset`` and ``step``
return per-agent device tensors with no host read, an env autoresets on the
step on which any agent terminates or truncates, and ``info["final_obs"]``
is the successor before the autoreset.

``make_ma_autoreset_step`` is the stacked step of the population program
(``parallel/multi_agent.py``): actions and observations are agent-major
``[A, N, ...]``, the reward is the shared ``[N]`` one, and a per-env step
count truncates at ``max_episode_steps``; a caller that drew its resets
beforehand passes them as ``reset=(state, obs)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from agilerl_tpu_torch.envs.core import VecState, _select
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.spaces import Box, Discrete, as_tensor
from agilerl_tpu_torch.utils.tree import tree_map


class MAState(NamedTuple):
    pos: torch.Tensor  # [N, n_agents, 2]
    landmarks: torch.Tensor  # [N, n_agents, 2]
    t: torch.Tensor  # [N] int32


class SimpleSpreadTorch:
    """Cooperative navigation, batched over ``[N]`` envs."""

    def __init__(self, n_agents: int = 2, continuous: bool = False, max_steps: int = 25):
        self.n_agents = int(n_agents)
        self.continuous = bool(continuous)
        self.max_episode_steps = max_steps
        self.agent_ids = [f"agent_{i}" for i in range(self.n_agents)]
        obs_dim = 2 + 2 * self.n_agents
        self.observation_spaces = {a: Box(-np.inf, np.inf, (obs_dim,), np.float32)
                                   for a in self.agent_ids}
        if self.continuous:
            self.action_spaces = {a: Box(-1.0, 1.0, (2,), np.float32) for a in self.agent_ids}
        else:
            self.action_spaces = {a: Discrete(5) for a in self.agent_ids}

    def _obs(self, state: MAState) -> Dict[str, torch.Tensor]:
        n = state.pos.shape[0]
        return {aid: torch.cat([state.pos[:, i],
                                (state.landmarks - state.pos[:, i:i + 1]).reshape(n, -1)], dim=-1)
                for i, aid in enumerate(self.agent_ids)}

    def reset_fn(self, n: int, gen: torch.Generator):
        shape = (n, self.n_agents, 2)
        pos = torch.rand(shape, generator=gen, device=gen.device) * 2 - 1
        landmarks = torch.rand(shape, generator=gen, device=gen.device) * 2 - 1
        state = MAState(pos, landmarks, torch.zeros(n, dtype=torch.int32, device=gen.device))
        return state, self._obs(state)

    def _move(self, a: torch.Tensor) -> torch.Tensor:
        if self.continuous:
            return torch.clamp(a.float(), -1, 1) * 0.1
        zero = torch.zeros((), device=a.device)
        dx = torch.where(a == 1, -0.1, torch.where(a == 2, 0.1, zero))
        dy = torch.where(a == 3, -0.1, torch.where(a == 4, 0.1, zero))
        return torch.stack([dx, dy], dim=-1)

    def step_fn(self, state: MAState, actions: Dict[str, torch.Tensor], gen=None):
        moves = torch.stack([self._move(actions[aid]) for aid in self.agent_ids], dim=1)
        pos = torch.clamp(state.pos + moves, -1.5, 1.5)
        t = state.t + 1
        new = MAState(pos, state.landmarks, t)
        # d[n, agent, landmark]; the shared reward sums each landmark's nearest agent
        d = torch.linalg.vector_norm(pos[:, :, None, :] - state.landmarks[:, None, :, :], dim=-1)
        reward = -torch.sum(torch.amin(d, dim=1), dim=-1)
        truncated = t >= self.max_episode_steps
        terminated = torch.zeros_like(truncated)
        obs = self._obs(new)
        return (new, obs, {a: reward for a in self.agent_ids},
                {a: terminated for a in self.agent_ids}, {a: truncated for a in self.agent_ids})


def _any_agent(flags: Dict[str, torch.Tensor], ids) -> torch.Tensor:
    out = flags[ids[0]].bool()
    for a in ids[1:]:
        out = out | flags[a].bool()
    return out


def make_ma_autoreset_step(env) -> Callable:
    """``vec_step(vstate, actions [A, N, ...], reset=None) -> (vstate, obs
    [A, N, ...], reward [N], terminated [N], truncated [N], final_obs [A, N,
    ...])`` with gymnasium's autoreset semantics (``final_obs`` is the
    successor before the reset). Without ``reset`` every call draws one
    reset per env from ``vstate.gen``."""
    ids = env.agent_ids
    max_steps = env.max_episode_steps or 10 ** 9

    def vec_step(vstate: VecState, actions: torch.Tensor, reset=None):
        n = vstate.step_count.shape[0]
        act = {aid: actions[i] for i, aid in enumerate(ids)}
        new_state, obs, rew, term, trunc = env.step_fn(vstate.env_state, act, vstate.gen)
        step_count = vstate.step_count + 1
        terminated = _any_agent(term, ids)
        truncated = _any_agent(trunc, ids) | (step_count >= max_steps)
        done = terminated | truncated
        reset_state, reset_obs = reset if reset is not None else env.reset_fn(n, vstate.gen)
        out_state = tree_map(lambda r, s: _select(done, r, s), reset_state, new_state)
        obs_stacked = torch.stack([obs[a] for a in ids])
        reset_stacked = torch.stack([reset_obs[a] for a in ids])
        out_obs = torch.where(done.view((1, n) + (1,) * (obs_stacked.dim() - 2)), reset_stacked,
                              obs_stacked)
        out_count = torch.where(done, torch.zeros_like(step_count), step_count)
        # shared-reward envs: every agent sees the same scalar
        return (VecState(out_state, out_count, vstate.gen), out_obs, rew[ids[0]], terminated,
                truncated, obs_stacked)

    return vec_step


class MultiAgentTorchVecEnv:
    """Vectorised dict API (PettingZoo-parallel-like, batched) over a
    device multi-agent env. ``device=None`` means the card (raising without
    one); ``seed`` seeds the env's generator."""

    def __init__(self, env, num_envs: int = 1, seed: int = 0, device: DeviceLike = None):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(device)
        self.agents = env.agent_ids
        self.agent_ids = env.agent_ids
        self.observation_spaces = env.observation_spaces
        self.action_spaces = env.action_spaces
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._state: Optional[Any] = None

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._gen.manual_seed(int(seed))
        self._state, obs = self.env.reset_fn(self.num_envs, self._gen)
        return obs, {}

    def step(self, actions: Dict[str, Any]):
        actions = {a: as_tensor(v, self.device) for a, v in actions.items()}
        new, obs, rew, term, trunc = self.env.step_fn(self._state, actions, self._gen)
        ids = self.agent_ids
        done = _any_agent(term, ids) | _any_agent(trunc, ids)
        reset_state, reset_obs = self.env.reset_fn(self.num_envs, self._gen)
        self._state = tree_map(lambda r, s: _select(done, r, s), reset_state, new)
        out_obs = {a: _select(done, reset_obs[a], obs[a]) for a in ids}
        return out_obs, rew, term, trunc, {"final_obs": obs}

    def close(self):
        pass
