"""PettingZoo parallel-env wrappers: the port of
``agilerl_tpu/wrappers/pettingzoo_wrappers.py`` (the single-env autoreset
wrapper for use outside the vector envs, which autoreset themselves)."""

from __future__ import annotations


class PettingZooAutoResetParallelWrapper:
    """Resets the wrapped parallel env once every agent's episode has ended
    (terminated or truncated). Everything else (agents, ``state()``,
    ``render_mode``, the spaces, ...) is the wrapped env's."""

    def __init__(self, env) -> None:
        self.env = env

    def __getattr__(self, name):
        # only called for names the wrapper itself does not have
        return getattr(self.env, name)

    def reset(self, seed=None, options=None):
        return self.env.reset(seed=seed, options=options)

    def step(self, actions):
        obs, rewards, terminations, truncations, infos = self.env.step(actions)
        agents = set(terminations) | set(truncations)
        if agents and all(terminations.get(a, False) or truncations.get(a, False)
                          for a in agents):
            obs, infos = self.env.reset()
        return obs, rewards, terminations, truncations, infos

    @property
    def unwrapped(self):
        return getattr(self.env, "unwrapped", self.env)
