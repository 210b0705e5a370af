"""Parity of the port's device-side envs (agilerl_tpu_torch.envs) with the
JAX package's, on the CPU: every classic env's step on identical batched
states against the JAX ``step_fn`` (atol 1e-6), the probe envs' steps and
tables, autoreset with ``final_obs``, truncation at ``max_episode_steps``,
reset bounds, and ``rollout_scan``."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.envs import classic as JC  # noqa: E402
from agilerl_tpu.envs import probe as JP  # noqa: E402
from agilerl_tpu_torch.envs import classic as TC  # noqa: E402
from agilerl_tpu_torch.envs import probe as TP  # noqa: E402
from agilerl_tpu_torch.envs.core import TorchVecEnv, rollout_scan  # noqa: E402
from agilerl_tpu_torch.utils.utils import make_vect_envs  # noqa: E402

torch.set_num_threads(1)
N = 64


def _states(name, rng):
    """A batch of states spread over each env's reachable range (and past
    its termination bounds), as numpy arrays per state field."""
    if name in ("CartPole-v1", "VisualCartPole-v0"):
        return [rng.uniform(-2.6, 2.6, N), rng.uniform(-3, 3, N), rng.uniform(-0.25, 0.25, N),
                rng.uniform(-3, 3, N)]
    if name == "Pendulum-v1":
        return [rng.uniform(-7, 7, N), rng.uniform(-8, 8, N)]
    return [rng.uniform(-1.25, 0.6, N), rng.uniform(-0.07, 0.07, N)]


def _actions(env, rng):
    if hasattr(env.action_space, "n"):
        return rng.integers(0, env.action_space.n, N)
    return rng.uniform(-2.5, 2.5, (N, 1)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(TC.REGISTRY))
def test_classic_step_matches_jax(name):
    rng = np.random.default_rng(0)
    jenv, tenv = JC.make(name), TC.make(name)
    assert jenv.max_episode_steps == tenv.max_episode_steps
    assert tenv.observation_space.shape == jenv.observation_space.shape
    fields = [f.astype(np.float32) for f in _states(name, rng)]
    actions = _actions(jenv, rng)
    jstate = type(jenv.reset_fn(jax.random.PRNGKey(0))[0])(*map(jnp.asarray, fields))
    tstate = type(tenv.reset_fn(1, torch.Generator())[0])(*map(torch.from_numpy, fields))
    key = jax.random.split(jax.random.PRNGKey(1), N)
    jout = jax.vmap(jenv.step_fn)(jstate, jnp.asarray(actions), key)
    tout = tenv.step_fn(tstate, torch.from_numpy(actions), torch.Generator())
    for i, (j, t) in enumerate(zip(jax.tree_util.tree_leaves(jout[:3]),
                                   jax.tree_util.tree_leaves(tuple(tout[:3])))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6, err_msg=str(i))
    for j, t in zip(jout[3:], tout[3:]):  # terminated, truncated
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the batch crosses the termination bounds in CartPole and MountainCar
    if name in ("CartPole-v1", "MountainCar-v0"):
        assert 0 < int(np.asarray(jout[3]).sum()) < N


def test_reset_bounds():
    gen = torch.Generator().manual_seed(0)
    s, obs = TC.CartPole().reset_fn(4096, gen)
    assert obs.shape == (4096, 4) and obs.abs().max() <= 0.05 and obs.std() > 0.025
    s, obs = TC.Pendulum().reset_fn(4096, gen)
    assert s.theta.abs().max() <= math.pi and s.theta_dot.abs().max() <= 1.0
    np.testing.assert_allclose(obs[:, 0].numpy(), torch.cos(s.theta).numpy(), atol=1e-6)
    for env in (TC.MountainCar(), TC.MountainCarContinuous()):
        s, obs = env.reset_fn(4096, gen)
        assert ((s.position >= -0.6) & (s.position <= -0.4)).all() and (s.velocity == 0).all()
    s, obs = TC.VisualCartPole(size=12).reset_fn(3, gen)
    assert obs.shape == (3, 12, 12, 1) and 0 <= obs.min() and obs.max() <= 1


def test_autoreset_final_obs_and_truncation():
    env = TorchVecEnv(TC.CartPole(), num_envs=8, seed=3, device="cpu")
    obs, _ = env.reset()
    ones = torch.ones(8, dtype=torch.long)
    seen_done = 0
    for _ in range(40):  # always pushing right ends every episode early
        prev = obs
        obs, reward, term, trunc, info = env.step(ones)
        assert (reward == 1).all() and not trunc.any()
        fo = info["final_obs"]
        done = term
        # not done: the returned obs is the step's own obs
        assert torch.equal(obs[~done], fo[~done])
        if done.any():
            seen_done += int(done.sum())
            # done: final_obs is past a termination bound, obs a fresh reset
            past = (fo[done, 0].abs() > 2.4) | (fo[done, 2].abs() > 12 * math.pi / 180)
            assert past.all()
            assert obs[done].abs().max() <= 0.05
            assert (env._state.step_count[done] == 0).all()
        assert not torch.equal(prev, obs)
    assert seen_done >= 8
    # truncation at max_episode_steps (500): the count reaches it, the env resets
    env.reset()
    env._state = env._state._replace(step_count=torch.full((8,), 499, dtype=torch.int32))
    state = env._state.env_state
    env._state = env._state._replace(env_state=type(state)(*(torch.zeros(8) for _ in state)))
    obs, reward, term, trunc, info = env.step(torch.tensor([0, 1] * 4))
    assert trunc.all() and not term.any()
    assert (env._state.step_count == 0).all()
    assert obs.abs().max() <= 0.05 and info["final_obs"][:, 1].abs().min() > 0.1


def test_vec_env_gives_tensors_on_its_device_and_replays_its_seed():
    a = make_vect_envs("Pendulum-v1", 4, device="cpu", seed=7)
    b = make_vect_envs("Pendulum-v1", 4, device="cpu", seed=7)
    oa, _ = a.reset()
    ob, _ = b.reset()
    assert isinstance(oa, torch.Tensor) and torch.equal(oa, ob)
    act = np.full((4, 1), 0.5, np.float32)
    for _ in range(3):
        ra = a.step(act)
        rb = b.step(torch.from_numpy(act))
        assert all(torch.equal(x, y) for x, y in zip(ra[:4], rb[:4]))
    assert a.single_action_space.shape == (1,) and a.num_envs == 4


PROBES = ["ConstantRewardEnv", "ObsDependentRewardDictEnv", "DiscountedRewardImageEnv",
          "FixedObsPolicyEnv", "FixedObsPolicyContActionsEnv", "PolicyEnv", "PolicyDictEnv",
          "PolicyContActionsDictEnv"]


@pytest.mark.parametrize("name", PROBES)
def test_probe_env_matches_jax(name):
    jenv, tenv = getattr(JP, name)(), getattr(TP, name)()
    for attr in ("sample_actions", "q_values", "v_values", "policy_values"):
        want, got = getattr(jenv, attr), getattr(tenv, attr)
        assert (want is None) == (got is None), attr
        if want is not None:
            assert len(want) == len(got)
            for w, g in zip(want, got):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=attr)
    for w, g in zip(jenv.sample_obs, tenv.sample_obs):
        for k in (sorted(w) if isinstance(w, dict) else [None]):
            np.testing.assert_array_equal(np.asarray(g if k is None else g[k]),
                                          np.asarray(w if k is None else w[k]))
    # one step from every (v, w) pair and action, against the JAX step_fn
    rng = np.random.default_rng(1)
    v = rng.integers(0, 2, N).astype(np.float32)
    w = rng.integers(0, 2, N).astype(np.float32)
    t = rng.integers(0, 2, N).astype(np.int32)
    actions = _actions(jenv, rng) if jenv.continuous else rng.integers(0, 2, N)
    if jenv.continuous:
        actions = np.clip(actions, 0, 1)
    jstate = JP._ProbeState(jnp.asarray(v), jnp.asarray(w), jnp.asarray(t))
    jout = jax.vmap(jenv.step_fn)(jstate, jnp.asarray(actions),
                                  jax.random.split(jax.random.PRNGKey(0), N))
    tstate = TP._ProbeState(torch.from_numpy(v), torch.from_numpy(w), torch.from_numpy(t))
    tout = tenv.step_fn(tstate, torch.from_numpy(actions), torch.Generator())
    for j, g in zip(jax.tree_util.tree_leaves(jout[1:]), jax.tree_util.tree_leaves(tout[1:])):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(j).astype(np.float64), rtol=0, atol=1e-6)
    # resets draw v (and w) by distribution only
    st, obs = tenv.reset_fn(2000, torch.Generator().manual_seed(2))
    jst, _ = jax.vmap(jenv.reset_fn)(jax.random.split(jax.random.PRNGKey(2), 2000))
    assert abs(float(st.v.mean()) - float(jnp.mean(jst.v))) < 0.06


def test_rollout_scan_collects_a_trajectory():
    env = TC.CartPole()

    def policy(params, obs, gen):
        return (obs[:, 2] + 0.5 * obs[:, 3] > 0).long()

    gen = torch.Generator().manual_seed(0)
    traj, (vstate, last_obs) = rollout_scan(env, policy, None, 6, 30, gen)
    assert traj["obs"].shape == (30, 6, 4) and traj["done"].shape == (30, 6)
    assert traj["reward"].sum() == 180 and last_obs.shape == (6, 4)
    # the balancing policy keeps every pole up for 30 steps
    assert traj["done"].sum() == 0 and (vstate.step_count == 30).all()
