"""Probe environments and the learning checks: the port of the single-agent
part of ``agilerl_tpu/envs/probe.py`` (the five probe families over vector /
image / Dict observations and discrete / continuous actions, with their
ground-truth tables; ``check_policy_on_policy_with_probe_env``,
``fill_buffer_random``, ``check_q_learning_with_probe_env`` and
``check_policy_q_learning_with_probe_env``) and ``MemoryEnv``, the POMDP
probe of recurrent PPO. Batched over ``[N]`` tensors."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from agilerl_tpu_torch.envs.core import TorchEnv, TorchVecEnv
from agilerl_tpu_torch.utils.spaces import Box, Dict, Discrete, space_kind

_IMG_SHAPE = (3, 3, 1)  # NHWC


class _ProbeState(NamedTuple):
    v: torch.Tensor  # primary scalar (drives reward / box obs)
    w: torch.Tensor  # secondary scalar (Dict probes' discrete key)
    t: torch.Tensor


def _zeros(n: int, gen: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=gen.device)


def _bernoulli(n: int, gen: torch.Generator) -> torch.Tensor:
    return (torch.rand((n,), generator=gen, device=gen.device) < 0.5).float()


def _true(n: int, device) -> torch.Tensor:
    return torch.ones((n,), dtype=torch.bool, device=device)


class _ProbeBase(TorchEnv):
    """Shared machinery: obs emission per kind + space construction."""

    obs_kind = "vector"  # vector | image | dict
    continuous = False
    max_episode_steps = 1

    def __init__(self):
        if self.obs_kind == "vector":
            self.observation_space = Box(0.0, 1.0, (1,), np.float32)
        elif self.obs_kind == "image":
            self.observation_space = Box(0.0, 1.0, _IMG_SHAPE, np.float32)
        else:
            self.observation_space = Dict({"discrete": Discrete(2),
                                           "box": Box(0.0, 1.0, _IMG_SHAPE, np.float32)})
        if self.continuous:
            self.action_space = Box(0.0, 1.0, (1,), np.float32)
        else:
            self.action_space = Discrete(2)
        self._init_tables()

    def _emit(self, v: torch.Tensor, w: torch.Tensor):
        v = v.float()
        if self.obs_kind == "vector":
            return v[:, None]
        img = v.view(-1, 1, 1, 1).expand((-1,) + _IMG_SHAPE).contiguous()
        if self.obs_kind == "image":
            return img
        return {"box": img, "discrete": w.to(torch.int32)}

    def raw_obs(self, v, w=0):
        """Host-side obs (unbatched) for the ground-truth tables."""
        if self.obs_kind == "vector":
            return np.full((1,), v, np.float32)
        if self.obs_kind == "image":
            return np.full(_IMG_SHAPE, v, np.float32)
        return {"box": np.full(_IMG_SHAPE, v, np.float32), "discrete": np.int64(w)}

    @staticmethod
    def _cont_a(action: torch.Tensor) -> torch.Tensor:
        return action.reshape(action.shape[0], -1)[:, 0].float()

    def _init_tables(self):
        self.sample_obs = []
        self.sample_actions = None
        self.q_values = None
        self.v_values = None
        self.policy_values = None

    def _done(self, state, obs, reward):
        n = reward.shape[0]
        return state, obs, reward, _true(n, reward.device), ~_true(n, reward.device)


# --------------------------------------------------------------------------- #
# Families
# --------------------------------------------------------------------------- #


class _ConstantReward(_ProbeBase):
    """One step, fixed obs, reward 1 regardless of action. Value -> 1."""

    def reset_fn(self, n, gen):
        st = _ProbeState(_zeros(n, gen), _zeros(n, gen), _zeros(n, gen, torch.int32))
        return st, self._emit(st.v, st.w)

    def step_fn(self, state, action, gen):
        return self._done(state, self._emit(state.v, state.w), torch.ones_like(state.v))

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs(0, 0)]
        self.v_values = [1.0]
        if self.continuous:
            self.sample_actions = [np.full((1,), 0.5, np.float32)]
            self.q_values = [[1.0]]
        else:
            self.q_values = [[1.0, 1.0]]


class _ObsDependentReward(_ProbeBase):
    """One step; reward fixed by the observation, not the action.
    vector/image: r = +1 if v == 1 else -1. Dict: r = +1 iff discrete == box."""

    def reset_fn(self, n, gen):
        v = _bernoulli(n, gen)
        w = _bernoulli(n, gen) if self.obs_kind == "dict" else v
        return _ProbeState(v, w, _zeros(n, gen, torch.int32)), self._emit(v, w)

    def _reward(self, state, action):
        if self.obs_kind == "dict":
            hit = state.v == state.w
        else:
            hit = state.v > 0.5
        return torch.where(hit, 1.0, -1.0)

    def step_fn(self, state, action, gen):
        return self._done(state, self._emit(state.v, state.w), self._reward(state, action))

    def _init_tables(self):
        super()._init_tables()
        if self.obs_kind == "dict":
            self.sample_obs = [self.raw_obs(v, w) for w in (0, 1) for v in (0, 1)]
            rewards = [1.0, -1.0, -1.0, 1.0]  # (w, v): 00 01 10 11
        else:
            self.sample_obs = [self.raw_obs(0), self.raw_obs(1)]
            rewards = [-1.0, 1.0]
        self.v_values = rewards
        if self.continuous:
            self.sample_actions = [np.full((1,), 0.5, np.float32)] * len(rewards)
            self.q_values = [[r] for r in rewards]
        else:
            self.q_values = [[r, r] for r in rewards]


class _DiscountedReward(_ProbeBase):
    """Two steps; obs = t; reward 1 only on the second step, so
    value(s0) = gamma * value(s1) (the discounting probe)."""

    max_episode_steps = 2
    checks_discounting = True

    def reset_fn(self, n, gen):
        st = _ProbeState(_zeros(n, gen), _zeros(n, gen), _zeros(n, gen, torch.int32))
        return st, self._emit(st.v, st.w)

    def step_fn(self, state, action, gen):
        t = state.t + 1
        v = t.float()
        done = t >= 2
        reward = torch.where(done, 1.0, 0.0)
        return _ProbeState(v, v, t), self._emit(v, v), reward, done, torch.zeros_like(done)

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs(0, 0), self.raw_obs(1, 1)]
        if self.continuous:
            self.sample_actions = [np.full((1,), 0.5, np.float32)] * 2


class _FixedObsPolicy(_ProbeBase):
    """One step, fixed obs; the action determines the reward.
    discrete: action 0 -> +1, action 1 -> -1. continuous: r = -(a - 0.5)^2."""

    def __init__(self, continuous: Optional[bool] = None):
        if continuous is not None:
            self.continuous = continuous
        super().__init__()

    def reset_fn(self, n, gen):
        st = _ProbeState(_zeros(n, gen), _zeros(n, gen), _zeros(n, gen, torch.int32))
        return st, self._emit(st.v, st.w)

    def step_fn(self, state, action, gen):
        if self.continuous:
            reward = -torch.square(self._cont_a(action) - 0.5)
        else:
            reward = torch.where(action.reshape(-1) == 0, 1.0, -1.0)
        return self._done(state, self._emit(state.v, state.w), reward)

    def _init_tables(self):
        super()._init_tables()
        self.sample_obs = [self.raw_obs(0, 0)]
        if self.continuous:
            self.sample_actions = [np.full((1,), 0.5, np.float32)]
            self.q_values = [[0.0]]
            self.policy_values = [np.full((1,), 0.5, np.float32)]
        else:
            self.q_values = [[1.0, -1.0]]
            self.policy_values = [0]


class _Policy(_ProbeBase):
    """One step; the correct action depends on the observation.
    vector/image discrete: act == v. dict discrete: r = +1 iff act ==
    discrete and discrete == box. continuous: target a = v (1[v == w] for
    dict)."""

    def reset_fn(self, n, gen):
        v = _bernoulli(n, gen)
        w = _bernoulli(n, gen) if self.obs_kind == "dict" else v
        return _ProbeState(v, w, _zeros(n, gen, torch.int32)), self._emit(v, w)

    def step_fn(self, state, action, gen):
        if self.continuous:
            target = (state.v == state.w).float() if self.obs_kind == "dict" else state.v
            reward = -torch.square(self._cont_a(action) - target)
        else:
            a = action.reshape(-1)
            if self.obs_kind == "dict":
                hit = (a == state.w.long()) & (state.v == state.w)
            else:
                hit = a == state.v.long()
            reward = torch.where(hit, 1.0, -1.0)
        return self._done(state, self._emit(state.v, state.w), reward)

    def _init_tables(self):
        super()._init_tables()
        if self.obs_kind == "dict":
            self.sample_obs = [self.raw_obs(v, w) for w in (0, 1) for v in (0, 1)]
            if self.continuous:
                targets = [1.0, 0.0, 0.0, 1.0]  # (w, v): 00 01 10 11
                self.sample_actions = [np.full((1,), t, np.float32) for t in targets]
                self.q_values = [[0.0]] * 4
                self.policy_values = [np.full((1,), t, np.float32) for t in targets]
            else:
                self.q_values = [[1.0, -1.0], [-1.0, -1.0], [-1.0, -1.0], [-1.0, 1.0]]
                self.policy_values = [0, None, None, 1]
        else:
            self.sample_obs = [self.raw_obs(0), self.raw_obs(1)]
            if self.continuous:
                self.sample_actions = [np.zeros((1,), np.float32), np.ones((1,), np.float32)]
                self.q_values = [[0.0], [0.0]]
                self.policy_values = [np.zeros((1,), np.float32), np.ones((1,), np.float32)]
            else:
                self.q_values = [[1.0, -1.0], [-1.0, 1.0]]
                self.policy_values = [0, 1]


# --------------------------------------------------------------------------- #
# Named variants (the JAX package's names)
# --------------------------------------------------------------------------- #


def _variant(base, name, kind, continuous):
    cls = type(name, (base,), {"obs_kind": kind, "continuous": continuous})
    cls.__module__ = __name__
    return cls


ConstantRewardEnv = _variant(_ConstantReward, "ConstantRewardEnv", "vector", False)
ConstantRewardImageEnv = _variant(_ConstantReward, "ConstantRewardImageEnv", "image", False)
ConstantRewardDictEnv = _variant(_ConstantReward, "ConstantRewardDictEnv", "dict", False)
ConstantRewardContActionsEnv = _variant(_ConstantReward, "ConstantRewardContActionsEnv", "vector", True)
ConstantRewardContActionsImageEnv = _variant(_ConstantReward, "ConstantRewardContActionsImageEnv", "image", True)
ConstantRewardContActionsDictEnv = _variant(_ConstantReward, "ConstantRewardContActionsDictEnv", "dict", True)

ObsDependentRewardEnv = _variant(_ObsDependentReward, "ObsDependentRewardEnv", "vector", False)
ObsDependentRewardImageEnv = _variant(_ObsDependentReward, "ObsDependentRewardImageEnv", "image", False)
ObsDependentRewardDictEnv = _variant(_ObsDependentReward, "ObsDependentRewardDictEnv", "dict", False)
ObsDependentRewardContActionsEnv = _variant(_ObsDependentReward, "ObsDependentRewardContActionsEnv", "vector", True)
ObsDependentRewardContActionsImageEnv = _variant(_ObsDependentReward, "ObsDependentRewardContActionsImageEnv", "image", True)
ObsDependentRewardContActionsDictEnv = _variant(_ObsDependentReward, "ObsDependentRewardContActionsDictEnv", "dict", True)

DiscountedRewardEnv = _variant(_DiscountedReward, "DiscountedRewardEnv", "vector", False)
DiscountedRewardImageEnv = _variant(_DiscountedReward, "DiscountedRewardImageEnv", "image", False)
DiscountedRewardDictEnv = _variant(_DiscountedReward, "DiscountedRewardDictEnv", "dict", False)
DiscountedRewardContActionsEnv = _variant(_DiscountedReward, "DiscountedRewardContActionsEnv", "vector", True)
DiscountedRewardContActionsImageEnv = _variant(_DiscountedReward, "DiscountedRewardContActionsImageEnv", "image", True)
DiscountedRewardContActionsDictEnv = _variant(_DiscountedReward, "DiscountedRewardContActionsDictEnv", "dict", True)


class FixedObsPolicyEnv(_FixedObsPolicy):
    """Vector FixedObsPolicy; ``continuous=True`` selects the Box-action probe."""

    obs_kind = "vector"


FixedObsPolicyImageEnv = _variant(_FixedObsPolicy, "FixedObsPolicyImageEnv", "image", False)
FixedObsPolicyDictEnv = _variant(_FixedObsPolicy, "FixedObsPolicyDictEnv", "dict", False)
FixedObsPolicyContActionsEnv = _variant(_FixedObsPolicy, "FixedObsPolicyContActionsEnv", "vector", True)
FixedObsPolicyContActionsImageEnv = _variant(_FixedObsPolicy, "FixedObsPolicyContActionsImageEnv", "image", True)
FixedObsPolicyContActionsDictEnv = _variant(_FixedObsPolicy, "FixedObsPolicyContActionsDictEnv", "dict", True)

PolicyEnv = _variant(_Policy, "PolicyEnv", "vector", False)
PolicyImageEnv = _variant(_Policy, "PolicyImageEnv", "image", False)
PolicyDictEnv = _variant(_Policy, "PolicyDictEnv", "dict", False)
PolicyContActionsEnv = _variant(_Policy, "PolicyContActionsEnv", "vector", True)
PolicyContActionsImageEnv = _variant(_Policy, "PolicyContActionsImageEnv", "image", True)
PolicyContActionsImageEnvSimple = _variant(_Policy, "PolicyContActionsImageEnvSimple", "image", True)
PolicyContActionsDictEnv = _variant(_Policy, "PolicyContActionsDictEnv", "dict", True)


class _ScalarState(NamedTuple):
    obs: torch.Tensor  # [N, 2]: [cue, is_first_step]
    t: torch.Tensor  # [N] int32


class MemoryEnv(TorchEnv):
    """POMDP probe: a cue bit is shown only at t = 0, and at t = 2 the agent
    must act equal to it (+1, else -1). Solvable only with memory: it
    separates recurrent PPO from flat PPO."""

    max_episode_steps = 3

    def __init__(self):
        self.observation_space = Box(0.0, 1.0, (2,), np.float32)
        self.action_space = Discrete(2)

    def reset_fn(self, n, gen):
        cue = _bernoulli(n, gen).float()
        obs = torch.stack([cue, torch.ones_like(cue)], dim=-1)
        return _ScalarState(obs, torch.zeros(n, dtype=torch.int32, device=cue.device)), obs

    def step_fn(self, state, action, gen):
        t = state.t + 1
        cue = state.obs[:, 0]
        done = t >= 3
        hit = action.to(torch.int32) == cue.to(torch.int32)
        reward = torch.where(done, torch.where(hit, 1.0, -1.0), 0.0)
        blank = torch.zeros_like(state.obs)
        new = _ScalarState(torch.stack([cue, torch.zeros_like(cue)], dim=-1), t)
        return new, blank, reward, done, torch.zeros_like(done)


# --------------------------------------------------------------------------- #
# The on-policy check
# --------------------------------------------------------------------------- #


def _batched_table_obs(obs):
    if isinstance(obs, dict):
        return {k: np.asarray(v)[None] for k, v in obs.items()}
    return np.asarray(obs)[None]


def check_policy_on_policy_with_probe_env(
    env: TorchEnv, algo_class, algo_args: dict, train_iters: int = 60, seed: int = 42,
    atol: float = 0.2, solved_reward: Optional[float] = None,
) -> None:
    """Train an on-policy agent on a probe env (8 envs on the agent's
    device) and assert its deterministic policy against the env's table.
    With ``solved_reward``, stop once the mean per-step reward has stayed at
    or above it for three iterations in a row."""
    from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts

    agent = algo_class(**algo_args)
    vec = TorchVecEnv(env, num_envs=8, seed=seed, device=agent.dev)
    streak = 0
    for _ in range(train_iters):
        mean_rew = collect_rollouts(agent, vec, n_steps=agent.learn_step)
        agent.learn()
        if solved_reward is not None and mean_rew >= solved_reward:
            streak += 1
            if streak >= 3:
                break
        else:
            streak = 0

    assert env.policy_values is not None, "probe env has no policy table"
    for obs, pol in zip(env.sample_obs, env.policy_values):
        if pol is None:
            continue
        action, _, _ = agent.actor(agent.preprocess_observation(_batched_table_obs(obs)),
                                   deterministic=True)
        action = action.cpu().numpy()
        if space_kind(env.action_space) == "discrete":
            assert int(action[0]) == int(pol), f"policy({obs!r}) = {action[0]}, want {pol}"
        else:
            np.testing.assert_allclose(action.reshape(-1), pol, atol=atol)


# --------------------------------------------------------------------------- #
# The Q-learning check
# --------------------------------------------------------------------------- #


def fill_buffer_random(env: TorchEnv, memory, steps: int, num_envs: int = 8, seed: int = 0):
    """``steps`` vector steps of uniform-random actions (numpy, from
    ``seed``) on ``num_envs`` envs on the buffer's device, each stored with
    its true successor (``final_obs``) and its terminated flag."""
    vec = TorchVecEnv(env, num_envs=num_envs, seed=seed, device=memory.device)
    obs, _ = vec.reset(seed=seed)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        if space_kind(env.action_space) == "box":
            action = rng.uniform(env.action_space.low, env.action_space.high,
                                 size=(num_envs,) + tuple(env.action_space.shape))
            action = torch.from_numpy(action.astype(np.float32))
        else:
            action = torch.from_numpy(rng.integers(0, env.action_space.n, size=num_envs))
        next_obs, reward, terminated, truncated, info = vec.step(action.to(memory.device))
        memory.add({"obs": obs, "action": action, "reward": reward.float(),
                    "next_obs": info.get("final_obs", next_obs),
                    "done": terminated.float()}, batched=True)
        obs = next_obs
    return memory


def check_q_learning_with_probe_env(env: TorchEnv, algo_class, algo_args: dict,
                                    learn_steps: int = 500, seed: int = 42,
                                    atol: float = 0.3) -> None:
    """Train a Q-learner on a probe env's random-action buffer (256
    transitions) and assert its Q-values against the env's table (a
    discounting probe: Q(s1) ~ 1 and Q(s0) ~ gamma * Q(s1))."""
    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer

    agent = algo_class(**algo_args)
    memory = ReplayBuffer(max_size=2048, device=agent.dev, seed=seed)
    fill_buffer_random(env, memory, steps=256 // 8, num_envs=8, seed=seed)
    for _ in range(learn_steps):
        agent.learn(memory.sample(64))

    def q_of(obs):
        pre = agent.preprocess_observation(_batched_table_obs(obs))
        return agent.actor(pre).detach().cpu().numpy()

    if getattr(env, "checks_discounting", False):
        q0 = float(q_of(env.sample_obs[0]).max())
        q1 = float(q_of(env.sample_obs[1]).max())
        np.testing.assert_allclose(q1, 1.0, atol=max(atol, 0.15))
        np.testing.assert_allclose(q0, agent.gamma * q1, atol=max(atol, 0.15))
        return
    for obs, qrow in zip(env.sample_obs, env.q_values):
        if qrow is None:
            continue
        np.testing.assert_allclose(q_of(obs)[0], qrow, atol=atol)


def check_policy_q_learning_with_probe_env(env: TorchEnv, algo_class, algo_args: dict,
                                           learn_steps: int = 400, seed: int = 42,
                                           atol: float = 0.25) -> None:
    """Train an actor-critic off-policy agent (DDPG / TD3) on a continuous
    probe env's random-action buffer (512 transitions) and assert its critic
    against the env's Q table (a discounting probe: critic(s1, a) ~ 1 and
    critic(s0, a) ~ gamma * critic(s1, a)) and its greedy action against the
    policy table."""
    from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer

    agent = algo_class(**algo_args)
    memory = ReplayBuffer(max_size=2048, device=agent.dev, seed=seed)
    fill_buffer_random(env, memory, steps=64, num_envs=8, seed=seed)
    for _ in range(learn_steps):
        agent.learn(memory.sample(64))

    def q_of(obs, act):
        pre = agent.preprocess_observation(_batched_table_obs(obs))
        action = torch.as_tensor(np.asarray(act, np.float32)[None], device=agent.dev)
        return agent.critic(pre, action).detach().cpu().numpy().reshape(-1)

    if getattr(env, "checks_discounting", False):
        q0 = float(q_of(env.sample_obs[0], env.sample_actions[0])[0])
        q1 = float(q_of(env.sample_obs[1], env.sample_actions[1])[0])
        np.testing.assert_allclose(q1, 1.0, atol=max(atol, 0.15))
        np.testing.assert_allclose(q0, agent.gamma * q1, atol=max(atol, 0.15))
        return
    if env.q_values is not None and env.sample_actions is not None:
        for obs, act, qrow in zip(env.sample_obs, env.sample_actions, env.q_values):
            if qrow is not None:
                np.testing.assert_allclose(q_of(obs, act), qrow, atol=atol)
    if env.policy_values is not None:
        for obs, pol in zip(env.sample_obs, env.policy_values):
            if pol is None:
                continue
            action = agent.get_action(_batched_table_obs(obs), training=False)
            np.testing.assert_allclose(action.cpu().numpy().reshape(-1), pol, atol=atol)
