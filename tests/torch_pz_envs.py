"""PettingZoo parallel-API test envs for tests/test_torch_pz_vec.py.

A module of its own, importing neither jax nor the JAX package, so that the
async vector envs' spawned workers, which import the env's module to
unpickle its factory, stay light. The spaces are gymnasium's, which both
packages' vector envs read.
"""

import numpy as np
from gymnasium import spaces


class TinyEnv:
    """Box(3) observations equal to the step count, Discrete(2) actions, a
    reward equal to the action, truncation after ``episode_len`` steps."""

    def __init__(self, n_agents=2, episode_len=5):
        self.possible_agents = [f"a_{i}" for i in range(n_agents)]
        self.agents = []
        self.episode_len = episode_len
        self._t = 0

    def observation_space(self, agent):
        return spaces.Box(-10, 10, (3,), np.float32)

    def action_space(self, agent):
        return spaces.Discrete(2)

    def reset(self, seed=None, options=None):
        self.agents = list(self.possible_agents)
        self._t = 0
        return {a: np.full(3, self._t, np.float32) for a in self.agents}, {}

    def step(self, actions):
        self._t += 1
        done = self._t >= self.episode_len
        obs = {a: np.full(3, self._t, np.float32) for a in self.agents}
        rew = {a: float(actions[a]) for a in self.agents}
        term = {a: False for a in self.agents}
        trunc = {a: done for a in self.agents}
        if done:
            self.agents = []
        return obs, rew, term, trunc, {}

    def close(self):
        pass


class RichEnv:
    """Mixed leaves and a dying agent: a_0 observes a Dict (uint8 image,
    Discrete flag, float32 vector), a_1 a Tuple (float64 vector,
    MultiBinary); a_1 drops out of the dicts from step 2 to the episode's
    end (``episode_len`` steps, terminated); observations follow a seeded
    stream."""

    possible_agents = ["a_0", "a_1"]

    def __init__(self, episode_len=3):
        self.agents = []
        self.episode_len = episode_len
        self._t = 0
        self._rng = np.random.default_rng(0)

    def observation_space(self, agent):
        if agent == "a_0":
            return spaces.Dict({"img": spaces.Box(0, 255, (2, 2, 1), np.uint8),
                                "flag": spaces.Discrete(4),
                                "vec": spaces.Box(-1, 1, (2,), np.float32)})
        return spaces.Tuple((spaces.Box(-5, 5, (3,), np.float64), spaces.MultiBinary(3)))

    def action_space(self, agent):
        return spaces.Discrete(3)

    def _obs(self):
        out = {}
        if "a_0" in self.agents:
            out["a_0"] = {"img": self._rng.integers(0, 256, (2, 2, 1)).astype(np.uint8),
                          "flag": np.int64(self._t % 4),
                          "vec": self._rng.uniform(-1, 1, 2).astype(np.float32)}
        if "a_1" in self.agents:
            out["a_1"] = (self._rng.normal(size=3), np.array([1, 0, self._t % 2], np.int8))
        return out

    def reset(self, seed=None, options=None):
        self.agents = list(self.possible_agents)
        self._t = 0
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        return self._obs(), {a: {"seen": seed} for a in self.agents}

    def step(self, actions):
        self._t += 1
        if self._t == 2:
            self.agents = [a for a in self.agents if a != "a_1"]
        done = self._t >= self.episode_len
        obs = self._obs()
        rew = {a: float(actions[a]) + 0.5 * self._t for a in self.agents}
        term = {a: done for a in self.agents}
        trunc = {a: False for a in self.agents}
        if done:
            self.agents = []
        return obs, rew, term, trunc, {}

    def close(self):
        pass


class CrashingEnv(TinyEnv):
    def step(self, actions):
        raise RuntimeError("worker exploded")
