"""Device-side environment core: the port of ``agilerl_tpu/envs/core.py``.

An env is a batched state machine over ``[N]`` tensors:
``reset_fn(n, gen) -> (state, obs)`` and
``step_fn(state, action, gen) -> (state, obs, reward, terminated,
truncated)``, where ``state`` is a NamedTuple of ``[N, ...]`` tensors and
``gen`` a ``torch.Generator`` on the state's device. The JAX package writes
one env and ``vmap``s it; here every env is written batched.

- ``make_autoreset_step`` builds the vector step with gymnasium's autoreset
  semantics (the obs returned on the done step is the next episode's first
  obs; ``final_obs`` is the obs before the reset), a per-env step count and
  truncation at ``max_episode_steps``;
- ``TorchVecEnv`` is the gymnasium.vector-style API over it, with its state
  on its device: ``reset`` and ``step`` return tensors there, and no step
  syncs the host;
- ``rollout_scan`` is the JAX ``lax.scan`` rollout as a Python loop.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.spaces import as_tensor
from agilerl_tpu_torch.utils.tree import tree_map


class TorchEnv:
    """Base class: subclasses set observation_space and action_space and
    define the batched ``reset_fn`` and ``step_fn``."""

    observation_space = None
    action_space = None
    max_episode_steps: Optional[int] = None

    def reset_fn(self, n: int, gen: torch.Generator) -> Tuple[Any, Any]:  # pragma: no cover
        raise NotImplementedError

    def step_fn(self, state: Any, action: torch.Tensor,
                gen: torch.Generator) -> Tuple[Any, Any, torch.Tensor, torch.Tensor,
                                               torch.Tensor]:  # pragma: no cover
        raise NotImplementedError


class VecState(NamedTuple):
    env_state: Any  # [N, ...] leaves
    step_count: torch.Tensor  # [N] int32
    gen: torch.Generator


def _select(done: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` where ``done`` (per env, broadcast over trailing dims), else ``b``."""
    return torch.where(done.view(done.shape + (1,) * (a.dim() - 1)), a, b)


def make_autoreset_step(env: TorchEnv) -> Callable:
    """The vector step with per-env autoreset. Every call also draws one
    reset per env (used where done), as the JAX step does; a caller that
    drew its resets beforehand passes them as ``reset=(state, obs)``."""
    max_steps = env.max_episode_steps or 10 ** 9

    def vec_step(vstate: VecState, actions: torch.Tensor, reset=None):
        n = vstate.step_count.shape[0]
        new_state, obs, reward, terminated, truncated = env.step_fn(
            vstate.env_state, actions, vstate.gen)
        step_count = vstate.step_count + 1
        truncated = torch.logical_or(truncated, step_count >= max_steps)
        done = torch.logical_or(terminated, truncated)
        reset_state, reset_obs = reset if reset is not None else env.reset_fn(n, vstate.gen)
        out_state = tree_map(lambda r, s: _select(done, r, s), reset_state, new_state)
        out_obs = tree_map(lambda r, o: _select(done, r, o), reset_obs, obs)
        out_count = torch.where(done, torch.zeros_like(step_count), step_count)
        return (VecState(out_state, out_count, vstate.gen), out_obs, reward, terminated,
                truncated, obs)

    return vec_step


class TorchVecEnv:
    """gymnasium.vector-style API over a device-side env. ``device=None``
    means the card (raising without one); ``seed`` seeds the env's
    generator, as ``JaxVecEnv``'s key."""

    def __init__(self, env: TorchEnv, num_envs: int = 1, seed: int = 0,
                 device: DeviceLike = None):
        self.env = env
        self.num_envs = int(num_envs)
        self.device = resolve_device(device)
        self.observation_space = env.observation_space
        self.action_space = env.action_space
        self.single_observation_space = env.observation_space
        self.single_action_space = env.action_space
        self._step = make_autoreset_step(env)
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._state: Optional[VecState] = None

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._gen.manual_seed(int(seed))
        env_state, obs = self.env.reset_fn(self.num_envs, self._gen)
        self._state = VecState(env_state,
                               torch.zeros(self.num_envs, dtype=torch.int32, device=self.device),
                               self._gen)
        return obs, {}

    def step(self, actions):
        actions = as_tensor(actions, self.device)
        self._state, obs, reward, terminated, truncated, final_obs = self._step(
            self._state, actions)
        return obs, reward, terminated, truncated, {"final_obs": final_obs}

    def close(self):
        pass


def rollout_scan(env: TorchEnv, policy_fn: Callable[[Any, Any, torch.Generator], torch.Tensor],
                 policy_params: Any, num_envs: int, num_steps: int, gen: torch.Generator):
    """Policy + env rollout over ``num_steps`` with autoreset, on ``gen``'s
    device. ``policy_fn(params, obs, gen) -> actions``. Returns (trajectory
    dict of ``[T, N, ...]`` tensors, (final VecState, last obs))."""
    vec_step = make_autoreset_step(env)
    env_state, obs = env.reset_fn(num_envs, gen)
    vstate = VecState(env_state, torch.zeros(num_envs, dtype=torch.int32, device=gen.device), gen)
    traj = {"obs": [], "action": [], "reward": [], "done": []}
    for _ in range(num_steps):
        actions = policy_fn(policy_params, obs, gen)
        vstate, next_obs, reward, terminated, truncated, _ = vec_step(vstate, actions)
        traj["obs"].append(obs)
        traj["action"].append(actions)
        traj["reward"].append(reward)
        traj["done"].append(torch.logical_or(terminated, truncated).float())
        obs = next_obs
    stacked = {k: (tree_map(lambda *xs: torch.stack(xs), *v) if v else v)
               for k, v in traj.items()}
    return stacked, (vstate, obs)
