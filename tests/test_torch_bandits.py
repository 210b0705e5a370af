"""Parity of the port's contextual bandits (agilerl_tpu_torch:
``wrappers/learning.BanditEnv``, ``algorithms/neural_ucb_bandit``,
``algorithms/neural_ts_bandit``, ``create_population``,
``training/train_bandits``) with the JAX package's on the CPU in f32: the
env's contexts and rewards, one UCB pull and one TS pull on the JAX normal
draws (arm and ``U``, 1e-5), three learns on the same batches (loss and
weights, rtol 1e-5), the mutation hook, checkpoints with the bandit state,
population seeds, ``train_bandits`` resume and the learning gate of the
JAX package's bandit test (score > 0.6); the in-repo iris fixture against
scikit-learn's copy."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.neural_ts_bandit import NeuralTS as JTS  # noqa: E402
from agilerl_tpu.algorithms.neural_ucb_bandit import NeuralUCB as JUCB  # noqa: E402
from agilerl_tpu.hpo.mutation import Mutations as JMutations  # noqa: E402
from agilerl_tpu.utils.utils import create_population as j_create_population  # noqa: E402
from agilerl_tpu.wrappers.learning import BanditEnv as JBanditEnv  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.neural_ts_bandit import NeuralTS  # noqa: E402
from agilerl_tpu_torch.algorithms.neural_ucb_bandit import NeuralUCB  # noqa: E402
from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer  # noqa: E402
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.training.train_bandits import train_bandits  # noqa: E402
from agilerl_tpu_torch.utils.tree import tree_from_numpy, tree_leaves, tree_to_numpy  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population  # noqa: E402
from agilerl_tpu_torch.wrappers.learning import BanditEnv  # noqa: E402

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
IRIS = Path(__file__).parent / "fixtures" / "iris" / "iris.csv"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n)
    centers = rng.normal(size=(3, 4)) * 2.0
    return centers[labels] + rng.normal(size=(n, 4)) * 0.5, labels


def _pair(cls_t, cls_j, gamma=1.0):
    features, labels = _data()
    obs = gspaces.Box(-np.inf, np.inf, (12,), np.float32)
    act = gspaces.Discrete(3)
    jagent = cls_j(obs, act, net_config=NET, lr=1e-2, gamma=gamma, lamb=0.5, reg=1e-2, seed=0)
    tagent = cls_t(obs, act, net_config=NET, lr=1e-2, gamma=gamma, lamb=0.5, reg=1e-2, seed=0,
                   device="cpu")
    load_params_from_numpy(tagent, {"actor": _np(jagent.actor.params)})
    tagent._reinit_bandit_grads()
    return jagent, tagent, BanditEnv(features, labels), JBanditEnv(features, labels)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _flat(tree[k], prefix + (k,)).items()}
    return {prefix: np.asarray(tree)}


def _assert_tree(got, want, rtol=1e-5, atol=1e-6):
    g, w = _flat(tree_to_numpy(got)), _flat(_np(want))
    assert g.keys() == w.keys()
    for path in g:
        np.testing.assert_allclose(g[path], w[path], rtol=rtol, atol=atol, err_msg=str(path))


def test_bandit_env_matches_jax():
    features, labels = _data()
    t, j = BanditEnv(features, labels), JBanditEnv(features, labels)
    assert (t.arms, t.dim, t.context_dim) == (j.arms, j.dim, j.context_dim)
    assert t.observation_space.shape == j.observation_space.shape == (12,)
    assert t.action_space.n == j.action_space.n == 3
    np.testing.assert_array_equal(t.reset(), j.reset())
    actions = np.random.default_rng(1).integers(0, 3, 40)
    for a in actions:
        tc, tr = t.step(a)
        jc, jr = j.step(a)
        np.testing.assert_array_equal(tc, jc)
        assert tr == jr and tr.dtype == np.float32


def test_ucb_pull_matches_jax():
    jagent, tagent, env, _ = _pair(NeuralUCB, JUCB, gamma=0.7)
    context = env.reset()
    for _ in range(3):  # U grows with each pulled arm's squared gradient
        jarm = jagent.get_action(context)
        tarm = tagent.get_action(context)
        assert int(tarm) == int(jarm)
        _assert_tree(tagent.U, jagent.U)
        context, _ = env.step(tarm)
    assert int(tagent.get_action(context, training=False)) == int(
        jagent.get_action(context, training=False))


def test_ts_pull_on_the_jax_draw_matches_jax():
    jagent, tagent, env, _ = _pair(NeuralTS, JTS, gamma=2.0)
    score = jagent.jit_fn("score", jagent._score_fn)
    context = env.reset()
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jarm, jagent.U = score(jagent.actor.params, jagent.U, jnp.asarray(context),
                               jnp.float32(jagent.gamma), key)
        draws = np.asarray(jax.random.normal(key, (3,)))
        tarm = tagent.get_action(context, draws=draws)
        assert int(tarm) == int(jarm)
        _assert_tree(tagent.U, jagent.U)
        context, _ = env.step(tarm)
    tagent.get_action(context)  # the agent's own draws


@pytest.mark.parametrize("cls_t,cls_j", [(NeuralUCB, JUCB), (NeuralTS, JTS)])
def test_three_learns_match_jax(cls_t, cls_j):
    jagent, tagent, _, _ = _pair(cls_t, cls_j)
    rng = np.random.default_rng(2)
    for _ in range(3):
        batch = {"obs": rng.normal(size=(16, 12)).astype(np.float32),
                 "reward": rng.integers(0, 2, 16).astype(np.float32)}
        jl = jagent.learn({k: jnp.asarray(v) for k, v in batch.items()})
        tl = tagent.learn(batch)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    _assert_tree(tagent.actor.params, jagent.actor.params)
    _assert_tree(tagent.theta_0, jagent.theta_0, atol=0)


def test_mutation_hook_resets_the_bandit_state_as_jax():
    """An architecture mutation through both engines: the same method and
    shapes, theta_0 the new weights and U back at lamb on the new shapes."""
    jagent, tagent, env, _ = _pair(NeuralUCB, JUCB)
    context = env.reset()
    jagent.get_action(context)
    tagent.get_action(context)
    kw = dict(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
              new_layer_prob=0.5, rand_seed=3)
    jagent = JMutations(**kw).mutation([jagent])[0]
    tagent = Mutations(**kw).mutation([tagent])[0]
    assert tagent.mut == jagent.mut
    assert dataclasses.asdict(tagent.actor.config) == dataclasses.asdict(jagent.actor.config)
    for u, p in zip(tree_leaves(tagent.U), tree_leaves(tagent.actor.params)):
        assert u.shape == p.shape and bool((u == tagent.lamb).all())
    for t0, p in zip(tree_leaves(tagent.theta_0), tree_leaves(tagent.actor.params)):
        assert torch.equal(t0, p)
    _assert_tree(tagent.U, jagent.U, atol=0)
    assert np.isfinite(tagent.learn({"obs": np.ones((4, 12), np.float32),
                                     "reward": np.ones(4, np.float32)}))


def test_checkpoint_round_trip_keeps_the_bandit_state(tmp_path):
    _, tagent, env, _ = _pair(NeuralTS, JTS)
    context = env.reset()
    for _ in range(4):
        context, _ = env.step(tagent.get_action(context))
    clone = tagent.clone()
    tagent.save_checkpoint(tmp_path / "ts.ckpt")
    ckpt = tagent.checkpoint_dict()
    assert isinstance(tree_leaves(ckpt["bandit_state"]["U"])[0], np.ndarray)
    loaded = NeuralTS.load(tmp_path / "ts.ckpt", device="cpu")
    for other in (loaded, clone):
        for a, b in zip(tree_leaves(other.U) + tree_leaves(other.theta_0),
                        tree_leaves(tagent.U) + tree_leaves(tagent.theta_0)):
            assert torch.equal(a, b)
        assert int(other.get_action(context, training=False)) == int(
            tagent.get_action(context, training=False))
    assert tree_leaves(tree_from_numpy(ckpt["bandit_state"]["theta_0"], "cpu"))[0].dtype == \
        torch.float32


@pytest.mark.parametrize("algo", ["NeuralUCB", "NeuralTS"])
def test_create_population_matches_jax(algo):
    features, labels = _data()
    jenv = JBanditEnv(features, labels)
    tenv = BanditEnv(features, labels)
    hp = {"BATCH_SIZE": 32, "LR": 2e-3, "LAMBDA": 0.8, "REG": 1e-3, "LEARN_STEP": 3,
          "POP_SIZE": 3}
    jpop = j_create_population(algo, jenv.observation_space, jenv.action_space, NET, hp, seed=4)
    tpop = create_population(algo, tenv.observation_space, tenv.action_space, NET, hp, seed=4,
                             device="cpu")
    assert [type(a).__name__ for a in tpop] == [algo] * 3
    for t, j in zip(tpop, jpop):
        assert (t.index, t.lamb, t.reg, t.lr, t.batch_size, t.learn_step) == (
            j.index, j.lamb, j.reg, j.lr, j.batch_size, j.learn_step)
        assert t.rng.integers(0, 2**31) == j.rng.integers(0, 2**31)


def test_train_bandits_resume_round_trip(tmp_path):
    """As the JAX package's test_resume_bandits_roundtrip: a run that
    checkpoints, then a resumed run of one step restores its weights and
    its bandit state."""
    env = BanditEnv(*_data())
    ckpt = str(tmp_path / "ucb.ckpt")

    def make():
        return create_population(
            "NeuralUCB", env.observation_space, env.action_space, population_size=1, seed=0,
            net_config=NET, device="cpu",
            INIT_HP={"BATCH_SIZE": 16, "LR": 1e-3, "LAMBDA": 1.0, "REG": 0.000625,
                     "LEARN_STEP": 2})

    trained, fit = train_bandits(env, "bandit", "NeuralUCB", make(),
                                 ReplayBuffer(max_size=512, device="cpu"), max_steps=60,
                                 episode_steps=30, evo_steps=30, eval_steps=10, eval_loop=1,
                                 checkpoint=30, checkpoint_path=ckpt,
                                 overwrite_checkpoints=True, verbose=False)
    assert np.shape(fit) == (1, 2)
    restored, _ = train_bandits(env, "bandit", "NeuralUCB", make(),
                                ReplayBuffer(max_size=512, device="cpu"), max_steps=1,
                                checkpoint_path=ckpt, resume=True, verbose=False)
    for a, b in zip(tree_leaves(restored[0].actor.params) + tree_leaves(restored[0].U),
                    tree_leaves(trained[0].actor.params) + tree_leaves(trained[0].U)):
        assert torch.equal(a, b)
    assert restored[0].steps == trained[0].steps
    # resilience= runs (a cadence snapshot at the boundary); wb=True raises
    from agilerl_tpu_torch.resilience import Resilience

    res = Resilience(tmp_path / "snap", save_every=30, handle_signals=False)
    train_bandits(env, "bandit", "NeuralUCB", make(), ReplayBuffer(max_size=512, device="cpu"),
                  max_steps=30, evo_steps=30, eval_steps=10, resilience=res, verbose=False)
    assert [(s.kind, s.step) for s in res.manager.snapshots()] == [("cadence", 30)]
    with pytest.raises(NotImplementedError, match="wb"):
        train_bandits(env, "bandit", "NeuralUCB", make(), None, wb=True)


def test_train_bandits_evolves_a_population():
    env = BanditEnv(*_data())
    pop = create_population("NeuralTS", env.observation_space, env.action_space, NET,
                            {"BATCH_SIZE": 16, "LEARN_STEP": 2, "POP_SIZE": 2}, seed=1,
                            device="cpu")
    memory = ReplayBuffer(max_size=256, device="cpu")
    pop, fit = train_bandits(env, "bandit", "NeuralTS", pop, memory, max_steps=80,
                             evo_steps=40, eval_steps=20,
                             tournament=TournamentSelection(2, True, 2, 1,
                                                            rng=np.random.default_rng(0)),
                             mutation=Mutations(activation=0, rand_seed=0), verbose=False)
    assert np.shape(fit) == (2, 2) and np.isfinite(fit).all()
    assert len(memory) == 160 and memory.flush_every == 8


@pytest.mark.parametrize("cls", [NeuralUCB, NeuralTS])
def test_bandit_learns(cls):
    """The JAX package's TestBandits.test_bandit_learns on the port."""
    rng = np.random.default_rng(0)
    features = rng.normal(size=(64, 4)).astype(np.float32)
    env = BanditEnv(features, (features[:, 0] > 0).astype(np.int64))
    agent = cls(gspaces.Box(-np.inf, np.inf, (env.context_dim,)), gspaces.Discrete(env.arms),
                net_config=NET, lr=3e-3, seed=0, device="cpu")
    buf = ReplayBuffer(max_size=512, device="cpu")
    context = env.reset()
    for step in range(150):
        arm = agent.get_action(context)
        next_context, reward = env.step(arm)
        buf.add({"obs": context[int(arm)], "reward": reward, "action": np.int32(arm),
                 "next_obs": context[int(arm)], "done": np.float32(1)})
        context = next_context
        if len(buf) >= 32 and step % 2 == 0:
            agent.learn(buf.sample(32))
    assert agent.test(env, max_steps=50) > 0.6  # better than random (0.5)


def test_iris_fixture_matches_sklearn():
    data = np.loadtxt(IRIS, delimiter=",", skiprows=1)
    assert data.shape == (150, 5)
    np.testing.assert_array_equal(np.bincount(data[:, 4].astype(int)), [50, 50, 50])
    datasets = pytest.importorskip("sklearn.datasets")
    iris = datasets.load_iris()
    np.testing.assert_array_equal(data[:, :4], iris.data)
    np.testing.assert_array_equal(data[:, 4].astype(int), iris.target)
