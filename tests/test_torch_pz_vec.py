"""Parity of the port's PettingZoo stack (agilerl_tpu_torch: ``vector/``,
``wrappers/pettingzoo_wrappers.py``, ``wrappers/agent.py``,
``utils/utils.make_multi_agent_vect_envs``) with the JAX package's on the
CPU: the sync and async vector envs on the same env classes, seeds and
actions (Dict / Tuple / mixed-dtype leaves, the dead agent's NaN and zero
placeholders, final observations and the autoreset rows, exactly equal),
worker errors with their tracebacks, closing twice; the autoreset wrapper;
``RSNorm``'s statistics (numpy and the tensor path, rtol 1e-12) and
``AsyncAgentsWrapper`` against the JAX wrappers; MADDPG through
``train_multi_agent_off_policy`` on the PettingZoo vector env. Async cases
use 2 envs. The test envs live in tests/torch_pz_envs.py, which imports no
jax, so the spawned workers stay light."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.vector import AsyncPettingZooVecEnv as JAsync  # noqa: E402
from agilerl_tpu.vector import PettingZooVecEnv as JSync  # noqa: E402
from agilerl_tpu.wrappers.agent import AsyncAgentsWrapper as JAsyncAgents  # noqa: E402
from agilerl_tpu.wrappers.agent import RSNorm as JRSNorm  # noqa: E402
from agilerl_tpu.wrappers.pettingzoo_wrappers import (  # noqa: E402
    PettingZooAutoResetParallelWrapper as JAutoReset,
)
from agilerl_tpu_torch.components.multi_agent_replay_buffer import (  # noqa: E402
    MultiAgentReplayBuffer,
)
from agilerl_tpu_torch.training.train_multi_agent_off_policy import (  # noqa: E402
    train_multi_agent_off_policy,
)
from agilerl_tpu_torch.utils.utils import (  # noqa: E402
    create_population,
    make_multi_agent_vect_envs,
)
from agilerl_tpu_torch.vector import AsyncPettingZooVecEnv, PettingZooVecEnv  # noqa: E402
from agilerl_tpu_torch.wrappers import (  # noqa: E402
    AsyncAgentsWrapper,
    PettingZooAutoResetParallelWrapper,
    RSNorm,
)
from tests.torch_pz_envs import CrashingEnv, RichEnv, TinyEnv  # noqa: E402

torch.set_num_threads(1)


def _assert_equal(a, b, where=""):
    """Trees of arrays equal leaf for leaf, in dtype and value (NaN == NaN)."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), where
        for k in b:
            _assert_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(b, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{where}/{i}")
    elif b is None:
        assert a is None, where
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=where)


def _rich_fns():
    return [functools.partial(RichEnv, episode_len=n) for n in (3, 4)]


def _drive(port, ref, steps=7):
    """The same seeded reset and action stream through both envs, every
    output held equal (the infos' autoreset rows and final observations
    included)."""
    try:
        (po, _), (jo, _) = port.reset(seed=3), ref.reset(seed=3)
        _assert_equal(po, jo, "reset")
        rng = np.random.default_rng(0)
        for t in range(steps):
            actions = {a: rng.integers(0, 3, port.num_envs) for a in port.agents}
            pout, jout = port.step(actions), ref.step(actions)
            for name, p, j in zip(("obs", "rew", "term", "trunc"), pout[:4], jout[:4]):
                _assert_equal(p, j, f"step {t} {name}")
            for key in ("autoreset", "final_obs"):
                _assert_equal(pout[4].get(key), jout[4].get(key), f"step {t} {key}")
        return pout
    finally:
        port.close()
        ref.close()


def test_sync_vec_env_matches_jax():
    out = _drive(PettingZooVecEnv(_rich_fns()), JSync(_rich_fns()))
    assert out[0]["a_0"]["img"].dtype == np.uint8 and out[0]["a_1"][1].dtype == np.int8


def test_async_vec_env_matches_jax():
    """Dict / Tuple leaves in their dtypes, a_1's placeholders while dead
    (NaN float leaves, zero integer leaves, NaN rewards), final
    observations and the autoreset rows of envs whose episodes end at
    different steps."""
    out = _drive(AsyncPettingZooVecEnv(_rich_fns()), JAsync(_rich_fns()))
    obs, rew = out[0], out[1]
    # after 7 steps a_1 is alive in env 0 (step 1 of an episode) and dead in env 1
    assert np.isfinite(obs["a_1"][0][0]).all() and np.isnan(obs["a_1"][0][1]).all()
    assert not obs["a_1"][1][1].any() and np.isnan(rew["a_1"][1])


def test_async_worker_error_and_close_twice():
    env = AsyncPettingZooVecEnv([CrashingEnv, CrashingEnv])
    env.reset(seed=0)
    with pytest.raises(RuntimeError, match="worker exploded") as err:
        env.step({a: np.zeros(2, np.int64) for a in env.agents})
    assert "Traceback" in str(err.value)
    env.close()
    env.close()
    assert not any(p.is_alive() for p in env._procs)
    with pytest.raises(RuntimeError, match="not running"):
        env.reset()


def test_async_call_order_is_enforced():
    env = AsyncPettingZooVecEnv([TinyEnv, TinyEnv])
    try:
        env.reset(seed=0)
        with pytest.raises(RuntimeError, match="without a pending"):
            env.step_wait()
        env.step_async({a: np.ones(2, np.int64) for a in env.agents})
        with pytest.raises(RuntimeError, match="pending"):
            env.reset()
        obs, rew, *_ = env.step_wait()
        np.testing.assert_array_equal(rew["a_0"], [1.0, 1.0])
        np.testing.assert_array_equal(obs["a_1"], np.ones((2, 3), np.float32))
    finally:
        env.close()


@pytest.mark.parametrize("should_async", [False, True])
def test_make_multi_agent_vect_envs(should_async):
    env = make_multi_agent_vect_envs(TinyEnv, num_envs=2, should_async_vector=should_async,
                                     episode_len=2)
    try:
        assert isinstance(env, AsyncPettingZooVecEnv if should_async else PettingZooVecEnv)
        obs, _ = env.reset(seed=0)
        assert obs["a_0"].shape == (2, 3)
        for _ in range(3):  # across the autoreset
            obs, *_ = env.step({a: np.zeros(2, np.int64) for a in env.agents})
        np.testing.assert_array_equal(obs["a_0"][:, 0], [1.0, 1.0])
    finally:
        env.close()


def test_autoreset_wrapper_matches_jax():
    port, ref = PettingZooAutoResetParallelWrapper(RichEnv()), JAutoReset(RichEnv())
    _assert_equal(port.reset(seed=1), ref.reset(seed=1))
    assert port.possible_agents == ["a_0", "a_1"] and port.unwrapped is port.env
    for t in range(7):
        actions = {a: t % 3 for a in port.agents}
        _assert_equal(port.step(actions), ref.step(actions), f"step {t}")


class _StubAgent:
    observation_space = gspaces.Dict({"x": gspaces.Box(-1, 1, (3,)),
                                      "k": gspaces.Discrete(4)})

    def get_action(self, obs, training=True):
        return obs

    def learn(self, experiences):
        return experiences


def test_rsnorm_statistics_match_jax():
    """The running statistics and the normalised observations of both
    wrappers on the same batches: the numpy path, and the port's tensor
    path (f64 statistics on the tensor's device) on the same values."""
    port, ref, dev = RSNorm(_StubAgent()), JRSNorm(_StubAgent()), RSNorm(_StubAgent())
    rng = np.random.default_rng(0)
    for _ in range(4):
        obs = {"x": rng.normal(3.0, 2.0, (5, 3)).astype(np.float32), "k": rng.integers(0, 4, 5)}
        p, j = port.get_action(obs), ref.get_action(obs)
        d = dev.get_action({"x": torch.as_tensor(obs["x"]), "k": torch.as_tensor(obs["k"])})
        np.testing.assert_allclose(p["x"], j["x"], rtol=1e-6)
        np.testing.assert_array_equal(p["k"], j["k"])
        assert isinstance(d["x"], torch.Tensor) and d["x"].dtype == torch.float32
        np.testing.assert_allclose(d["x"].numpy(), p["x"], rtol=1e-6, atol=1e-7)
    assert port.rms["k"] is None and ref.rms["k"] is None
    for rms in (port.rms["x"], dev.rms["x"]):
        np.testing.assert_allclose(np.asarray(rms.mean), ref.rms["x"].mean, rtol=1e-12)
        np.testing.assert_allclose(np.asarray(rms.var), ref.rms["x"].var, rtol=1e-12)
        assert rms.count == ref.rms["x"].count
    assert isinstance(dev.rms["x"].mean, torch.Tensor) and dev.rms["x"].mean.dtype == torch.float64
    batch = {"obs": {"x": np.ones((2, 3), np.float32), "k": np.zeros(2, np.int64)}}
    np.testing.assert_allclose(port.learn(batch)["obs"]["x"], ref.learn(batch)["obs"]["x"],
                               rtol=1e-6)


class _StubMA:
    observation_spaces = {"a": gspaces.Box(-1, 1, (2,)), "b": gspaces.Box(-1, 1, (2,))}

    def __init__(self, as_tensor):
        self.as_tensor = as_tensor

    def get_action(self, obs, **kw):
        n = next(iter(obs.values())).shape[0]
        acts = {a: np.arange(n, dtype=np.float32) + i for i, a in enumerate(sorted(obs))}
        return {a: torch.as_tensor(v) for a, v in acts.items()} if self.as_tensor else acts


def test_async_agents_wrapper_matches_jax():
    """Vectorised turn buffering over NaN-placeholder rows through both
    wrappers (the port's agent answering with tensors): the same masked
    actions and the same closed transitions."""
    port, ref = AsyncAgentsWrapper(_StubMA(True)), JAsyncAgents(_StubMA(False))
    nan = np.full(2, np.nan, np.float32)
    steps = [
        ({"a": np.array([[1, 1], [2, 2]], np.float32), "b": np.stack([nan, nan])},
         {"a": np.zeros(2), "b": np.full(2, np.nan)}, {"a": np.zeros(2), "b": np.zeros(2)}, None),
        ({"a": np.stack([nan, np.array([3, 3], np.float32)]),
          "b": np.array([[4, 4], [nan[0], nan[1]]], np.float32)},
         {"a": np.array([0.5, 1.0]), "b": np.array([0.0, np.nan])},
         {"a": np.zeros(2), "b": np.zeros(2)}, None),
        ({"a": np.array([[5, 5], [6, 6]], np.float32), "b": np.array([[7, 7], [8, 8]], np.float32)},
         {"a": np.array([0.25, 0.0]), "b": np.array([1.0, 2.0])},
         {"a": np.array([0.0, 1.0]), "b": np.array([0.0, 1.0])}, np.array([False, True])),
    ]
    for t, (obs, rew, done, autoreset) in enumerate(steps):
        pa, ja = port.get_action(obs), ref.get_action(obs)
        _assert_equal(pa, ja, f"actions {t}")
        pc = port.record_step(obs, pa, rew, done, autoreset=autoreset)
        jc = ref.record_step(obs, ja, rew, done, autoreset=autoreset)
        assert [(a, i) for a, i, _ in pc] == [(a, i) for a, i, _ in jc]
        for (_, _, p), (_, _, j) in zip(pc, jc):
            _assert_equal(p, j, f"transition {t}")
    assert len(pc) > 0


def test_maddpg_trains_through_the_pettingzoo_vector_env():
    env = make_multi_agent_vect_envs(TinyEnv, num_envs=2, should_async_vector=False,
                                     episode_len=4)
    pop = create_population("MADDPG", env.observation_spaces, env.action_spaces,
                            {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
                             "head_config": {"hidden_size": (16,)}},
                            {"BATCH_SIZE": 8, "LEARN_STEP": 2, "POP_SIZE": 2},
                            agent_ids=env.agent_ids, seed=0, device="cpu")
    memory = MultiAgentReplayBuffer(max_size=128, agent_ids=env.agent_ids, device="cpu")
    pop, fit = train_multi_agent_off_policy(env, "tiny", "MADDPG", pop, memory, max_steps=32,
                                            evo_steps=16, eval_steps=4, verbose=False)
    assert np.shape(fit) == (2, 2) and np.isfinite(fit).all() and len(memory) == 64
