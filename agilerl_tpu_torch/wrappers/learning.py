"""Learning wrappers: the port of ``agilerl_tpu/wrappers/learning.py``
(``BanditEnv``, a labelled dataset as a contextual bandit, and ``Skill``, the
curriculum reward wrapper).

``BanditEnv`` is host numpy, as in the JAX package, with the port's own
spaces (``utils/spaces.py``: no gymnasium). Its sample index stream is the
JAX env's, ``np.random.default_rng(0)``, so both packages present the same
contexts in the same order.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from agilerl_tpu_torch.utils.spaces import Box, Discrete


class BanditEnv:
    """A labelled dataset as a contextual bandit. Each step presents one
    sample as one context per arm (the disjoint-model encoding: arm a's
    context holds the features in the a-th block of an ``arms * dim``
    vector); the reward is 1 for the sample's label, else 0."""

    def __init__(self, features: np.ndarray, targets: np.ndarray):
        self.features = np.asarray(features, np.float32)
        self.targets = np.asarray(targets).astype(np.int64)
        if self.features.ndim > 2:
            self.features = self.features.reshape(len(self.features), -1)
        self.num_samples, self.dim = self.features.shape
        self.arms = int(self.targets.max()) + 1
        self.context_dim = self.arms * self.dim
        self._rng = np.random.default_rng(0)
        self._idx = 0
        self.observation_space = Box(-np.inf, np.inf, (self.context_dim,), np.float32)
        self.action_space = Discrete(self.arms)

    def _context(self, i: int) -> np.ndarray:
        x = self.features[i]
        ctx = np.zeros((self.arms, self.context_dim), np.float32)
        for a in range(self.arms):
            ctx[a, a * self.dim:(a + 1) * self.dim] = x
        return ctx

    def reset(self) -> np.ndarray:
        self._idx = int(self._rng.integers(0, self.num_samples))
        return self._context(self._idx)

    def step(self, action) -> Tuple[np.ndarray, np.float32]:
        reward = np.float32(1.0 if int(action) == int(self.targets[self._idx]) else 0.0)
        self._idx = int(self._rng.integers(0, self.num_samples))
        return self._context(self._idx), reward

    def state_dict(self) -> Dict[str, Any]:
        """The sample stream and the current sample: what a whole-run
        snapshot needs to continue the same pulls (the JAX package's
        ``BanditEnv`` has no ``state_dict``, so its snapshots do not)."""
        return {"rng": self._rng.bit_generator.state, "idx": self._idx}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        bg = getattr(np.random, state["rng"]["bit_generator"])()
        bg.state = state["rng"]
        self._rng = np.random.Generator(bg)
        self._idx = int(state["idx"])


class Skill:
    """Curriculum skill wrapper: ``skill_reward`` reshapes each step's
    outcome (override it in a subclass); everything else is the env's."""

    def __init__(self, env):
        self.env = env
        self.observation_space = env.observation_space
        self.action_space = env.action_space

    def reset(self, **kwargs):
        return self.env.reset(**kwargs)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)
        return self.skill_reward(obs, reward, terminated, truncated, info)

    def skill_reward(self, obs, reward, terminated, truncated, info):
        """Override in subclasses to shape rewards for this skill."""
        return obs, reward, terminated, truncated, info

    def __getattr__(self, item):
        return getattr(self.env, item)
