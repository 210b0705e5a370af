"""Multi-agent probe environments and the learning checks: the port of
``agilerl_tpu/envs/probe_ma.py``.

Five reward families (constant, observation-dependent, discounted,
fixed-observation policy, policy) x vector / image observations x discrete
/ continuous actions, and the joint-action ``MultiPolicy`` pair, as device
envs batched over ``[N]`` tensors for ``MultiAgentTorchVecEnv``
(``reset_fn(n, gen)``, ``step_fn(state, actions, gen)``). Each carries the
JAX package's ground-truth tables (``sample_obs``, ``policy_values``,
``v_values``); image observations are NHWC ``(3, 3, 1)`` and go through
the port's CNN encoder. ``check_ma_q_learning_with_probe_env`` (MADDPG,
MATD3) and ``check_ma_on_policy_with_probe_env`` (IPPO) train on a probe
and assert against the tables.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from agilerl_tpu_torch.utils.spaces import Box, Discrete, space_kind

_IMG_SHAPE = (3, 3, 1)  # NHWC


class _MAState(NamedTuple):
    v: torch.Tensor  # [N, n_agents] per-agent scalar (drives obs and reward)
    t: torch.Tensor  # [N] int32


class _MAProbeBase:
    n_agents = 2
    obs_kind = "vector"  # vector | image
    continuous = False
    max_episode_steps = 1

    def __init__(self):
        self.agent_ids = [f"agent_{i}" for i in range(self.n_agents)]
        shape = (1,) if self.obs_kind == "vector" else _IMG_SHAPE
        self.observation_spaces = {a: Box(0.0, 1.0, shape, np.float32) for a in self.agent_ids}
        act = Box(0.0, 1.0, (1,), np.float32) if self.continuous else Discrete(2)
        self.action_spaces = {a: act for a in self.agent_ids}
        self._init_tables()

    # -- observations ----------------------------------------------------- #
    def _emit(self, v: torch.Tensor) -> torch.Tensor:
        """[N] scalars -> [N, *obs shape]."""
        shape = (1,) if self.obs_kind == "vector" else _IMG_SHAPE
        return v.float().reshape((-1,) + (1,) * len(shape)).expand((v.shape[0],) + shape) \
            .contiguous()

    def _obs_dict(self, state: _MAState):
        return {a: self._emit(state.v[:, i]) for i, a in enumerate(self.agent_ids)}

    def raw_obs(self, vs):
        """Host dict observation of the tables: ``vs`` holds one scalar per
        agent."""
        shape = (1,) if self.obs_kind == "vector" else _IMG_SHAPE
        return {a: np.full(shape, v, np.float32) for a, v in zip(self.agent_ids, vs)}

    def _flags(self, state: _MAState, val: bool = True):
        f = torch.full((state.t.shape[0],), val, dtype=torch.bool, device=state.t.device)
        return {a: f for a in self.agent_ids}

    def _state(self, v: torch.Tensor, n: int, device) -> _MAState:
        return _MAState(v, torch.zeros(n, dtype=torch.int32, device=device))

    def reset_fn(self, n: int, gen: torch.Generator):
        state = self._state(torch.zeros((n, self.n_agents), device=gen.device), n, gen.device)
        return state, self._obs_dict(state)

    @staticmethod
    def _cont_a(action: torch.Tensor) -> torch.Tensor:
        """[N] of a [N] or [N, 1] continuous action."""
        a = action.float()
        return a.reshape(a.shape[0], -1)[:, 0]

    def _init_tables(self):
        self.sample_obs = []
        self.policy_values = None
        self.v_values = None

    def _single_step(self, state, rewards):
        """A one-step episode's return: the same state, its obs, ``rewards``
        per agent, terminated."""
        return (state, self._obs_dict(state), rewards, self._flags(state),
                self._flags(state, False))


class _RandomBitsMixin:
    """reset: an independent Bernoulli bit per agent."""

    def reset_fn(self, n: int, gen: torch.Generator):
        v = (torch.rand((n, self.n_agents), generator=gen, device=gen.device) < 0.5).float()
        state = self._state(v, n, gen.device)
        return state, self._obs_dict(state)


class _ConstantRewardMA(_MAProbeBase):
    """Every agent gets reward 1 every one-step episode: critics -> 1."""

    def step_fn(self, state, actions, gen=None):
        one = torch.ones(state.t.shape[0], device=state.t.device)
        return self._single_step(state, {a: one for a in self.agent_ids})

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0] * self.n_agents)]
        self.v_values = [{a: 1.0 for a in self.agent_ids}]


class _ObsDependentRewardMA(_RandomBitsMixin, _MAProbeBase):
    """Reward +-1 fixed by each agent's own observation bit."""

    def step_fn(self, state, actions, gen=None):
        return self._single_step(state, {a: torch.where(state.v[:, i] > 0.5, 1.0, -1.0)
                                         for i, a in enumerate(self.agent_ids)})

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0, 0.0]), self.raw_obs([1.0, 1.0])]
        self.v_values = [{a: -1.0 for a in self.agent_ids}, {a: 1.0 for a in self.agent_ids}]


class _DiscountedRewardMA(_MAProbeBase):
    """Two steps, reward 1 on the second only: value(s0) = gamma * value(s1)."""

    max_episode_steps = 2
    checks_discounting = True

    def step_fn(self, state, actions, gen=None):
        t = state.t + 1
        v = t.float()[:, None].expand(-1, self.n_agents).contiguous()
        new = _MAState(v, t)
        reward = torch.where(t >= 2, 1.0, 0.0)
        done = t >= 2
        return (new, self._obs_dict(new), {a: reward for a in self.agent_ids},
                {a: done for a in self.agent_ids}, self._flags(new, False))

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0, 0.0]), self.raw_obs([1.0, 1.0])]


class _FixedObsPolicyMA(_MAProbeBase):
    """Fixed observation; each agent's action sets its reward: discrete,
    action 0 -> +1 else -1; continuous, ``-(a - 0.5) ** 2``."""

    def step_fn(self, state, actions, gen=None):
        rewards = {}
        for a in self.agent_ids:
            if self.continuous:
                rewards[a] = -torch.square(self._cont_a(actions[a]) - 0.5)
            else:
                rewards[a] = torch.where(actions[a].reshape(-1) == 0, 1.0, -1.0)
        return self._single_step(state, rewards)

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0] * self.n_agents)]
        if self.continuous:
            self.policy_values = [{a: np.full((1,), 0.5, np.float32) for a in self.agent_ids}]
        else:
            self.policy_values = [{a: 0 for a in self.agent_ids}]


class _PolicyMA(_RandomBitsMixin, _MAProbeBase):
    """Each agent must match its own observation bit: discrete, +1 on a
    match else -1; continuous, ``-(a - bit) ** 2``."""

    def step_fn(self, state, actions, gen=None):
        rewards = {}
        for i, a in enumerate(self.agent_ids):
            if self.continuous:
                rewards[a] = -torch.square(self._cont_a(actions[a]) - state.v[:, i])
            else:
                rewards[a] = torch.where(actions[a].reshape(-1) == state.v[:, i].long(), 1.0, -1.0)
        return self._single_step(state, rewards)

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0, 0.0]), self.raw_obs([1.0, 1.0])]
        if self.continuous:
            self.policy_values = [{a: np.zeros((1,), np.float32) for a in self.agent_ids},
                                  {a: np.ones((1,), np.float32) for a in self.agent_ids}]
        else:
            self.policy_values = [{a: 0 for a in self.agent_ids}, {a: 1 for a in self.agent_ids}]


class _MultiPolicyMA(_RandomBitsMixin, _MAProbeBase):
    """Joint-action probe: an agent is rewarded only when every agent
    matches its own bit, so the centralised critic must model the joint
    action."""

    def step_fn(self, state, actions, gen=None):
        if self.continuous:
            joint = -sum(torch.square(self._cont_a(actions[a]) - state.v[:, i])
                         for i, a in enumerate(self.agent_ids))
            return self._single_step(state, {a: joint for a in self.agent_ids})
        match = torch.ones(state.t.shape[0], dtype=torch.bool, device=state.t.device)
        for i, a in enumerate(self.agent_ids):
            match = match & (actions[a].reshape(-1) == state.v[:, i].long())
        reward = torch.where(match, 1.0, -1.0)
        return self._single_step(state, {a: reward for a in self.agent_ids})

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs([0.0, 0.0]), self.raw_obs([1.0, 1.0])]
        if self.continuous:
            self.policy_values = [{a: np.zeros((1,), np.float32) for a in self.agent_ids},
                                  {a: np.ones((1,), np.float32) for a in self.agent_ids}]
        else:
            self.policy_values = [{a: 0 for a in self.agent_ids}, {a: 1 for a in self.agent_ids}]


# --------------------------------------------------------------------------- #
# Named variants (the JAX package's 22 classes)
# --------------------------------------------------------------------------- #


def _variant(base, name, kind, continuous):
    cls = type(name, (base,), {"obs_kind": kind, "continuous": continuous})
    cls.__module__ = __name__
    return cls


_FAMILIES = {
    "ConstantReward": _ConstantRewardMA,
    "ObsDependentReward": _ObsDependentRewardMA,
    "DiscountedReward": _DiscountedRewardMA,
    "FixedObsPolicy": _FixedObsPolicyMA,
    "Policy": _PolicyMA,
}

for _fam, _base in _FAMILIES.items():
    for _img in (False, True):
        for _cont in (False, True):
            _name = f"{_fam}{'ContActions' if _cont else ''}{'Image' if _img else ''}EnvMA"
            globals()[_name] = _variant(_base, _name, "image" if _img else "vector", _cont)

MultiPolicyEnvMA = _variant(_MultiPolicyMA, "MultiPolicyEnvMA", "vector", False)
MultiPolicyImageEnvMA = _variant(_MultiPolicyMA, "MultiPolicyImageEnvMA", "image", False)


# --------------------------------------------------------------------------- #
# Checks
# --------------------------------------------------------------------------- #


def _fill_ma_buffer(env, vec, buf, steps: int, seed: int):
    """``steps`` vector steps of uniform random actions (host numpy draws)."""
    rng = np.random.default_rng(seed)
    n = vec.num_envs
    obs, _ = vec.reset(seed=seed)
    for _ in range(steps):
        actions = {}
        for a in env.agent_ids:
            space = env.action_spaces[a]
            if space_kind(space) == "box":
                actions[a] = rng.uniform(space.low, space.high,
                                         size=(n,) + space.shape).astype(np.float32)
            else:
                actions[a] = rng.integers(0, space.n, size=n)
        next_obs, rew, term, _, _ = vec.step(actions)
        done = {a: term[a].float() for a in env.agent_ids}
        buf.save_to_memory(obs, actions, rew, next_obs, done, is_vectorised=True)
        obs = next_obs
    return buf


def _batch_one(obs_dict):
    return {a: np.asarray(o)[None] for a, o in obs_dict.items()}


def _assert_policy(env, agent, atol: float) -> None:
    for obs_dict, prow in zip(env.sample_obs, env.policy_values):
        acts = agent.get_action(_batch_one(obs_dict), training=False)
        for a, want in prow.items():
            if want is None:
                continue
            got = acts[a].detach().cpu().numpy().reshape(-1)
            if space_kind(env.action_spaces[a]) == "discrete":
                assert int(got[0]) == int(want), (a, got, want)
            else:
                np.testing.assert_allclose(got, want, atol=atol)


def check_ma_q_learning_with_probe_env(env, algo_class, algo_args: dict, learn_steps: int = 300,
                                       seed: int = 42, atol: float = 0.25) -> None:
    """Train MADDPG / MATD3 on a probe env's random-action buffer (64 vector
    steps of 8 envs) and assert each agent's critic values and greedy
    actions against the env's tables."""
    from agilerl_tpu_torch.components.multi_agent_replay_buffer import MultiAgentReplayBuffer
    from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv

    agent = algo_class(**algo_args)
    vec = MultiAgentTorchVecEnv(env, num_envs=8, seed=seed, device=agent.dev)
    buf = MultiAgentReplayBuffer(max_size=2048, agent_ids=env.agent_ids, device=agent.dev,
                                 seed=seed)
    _fill_ma_buffer(env, vec, buf, steps=64, seed=seed)
    for _ in range(learn_steps):
        agent.learn(buf.sample(64))

    if getattr(env, "checks_discounting", False):
        # value(s0) = gamma * value(s1), value(s1) ~ 1, per agent
        v0 = agent.critic_values(_batch_one(env.sample_obs[0]))
        v1 = agent.critic_values(_batch_one(env.sample_obs[1]))
        for a in env.agent_ids:
            q1, q0 = float(v1[a].reshape(-1)[0]), float(v0[a].reshape(-1)[0])
            np.testing.assert_allclose(q1, 1.0, atol=atol)
            np.testing.assert_allclose(q0, agent.gamma * q1, atol=atol)
    if env.v_values is not None:
        for obs_dict, vrow in zip(env.sample_obs, env.v_values):
            preds = agent.critic_values(_batch_one(obs_dict))
            for a, want in vrow.items():
                np.testing.assert_allclose(float(preds[a].reshape(-1)[0]), want, atol=atol)
    if env.policy_values is not None:
        _assert_policy(env, agent, atol)


def check_ma_on_policy_with_probe_env(env, algo_class, algo_args: dict, train_iters: int = 60,
                                      seed: int = 42, atol: float = 0.2,
                                      solved_reward: Optional[float] = 0.95) -> None:
    """Train IPPO on a probe env (8 envs) and assert each agent's greedy
    action against the policy table. Training stops once the mean reward
    has stayed at ``solved_reward`` or above for three iterations in a row:
    on a solved one-step probe the normalised advantages are noise that can
    unsettle a perfect policy."""
    from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv

    agent = algo_class(**algo_args)
    vec = MultiAgentTorchVecEnv(env, num_envs=8, seed=seed, device=agent.dev)
    solved_streak = 0
    for _ in range(train_iters):
        mean_rew = agent.collect_rollouts(vec)
        agent.learn()
        if solved_reward is not None and mean_rew >= solved_reward:
            solved_streak += 1
            if solved_streak >= 3:
                break
        else:
            solved_streak = 0
    assert env.policy_values is not None
    _assert_policy(env, agent, atol)
