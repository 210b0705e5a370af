"""Parity of the port's DQN family (agilerl_tpu_torch: ``networks/q_networks``,
``algorithms/{dqn,dqn_rainbow,cqn}``, ``algorithms/core/fused``) with the
JAX package's on the CPU in f32: the Q-networks on carried weights, the C51
projection, three ``learn`` steps of DQN (plain and double), CQN and Rainbow
(with and without the paired n-step batch) on identical batches,
``learn_from_buffer`` against ``learn`` on the batch its draws pick, greedy
actions, masked exploration, mutation with a valid target net, and two
Q-learning probe checks."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.cqn import CQN as JCQN  # noqa: E402
from agilerl_tpu.algorithms.dqn import DQN as JDQN  # noqa: E402
from agilerl_tpu.algorithms.dqn_rainbow import RainbowDQN as JRainbow  # noqa: E402
from agilerl_tpu.algorithms.dqn_rainbow import categorical_projection as j_project  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.cqn import CQN  # noqa: E402
from agilerl_tpu_torch.algorithms.dqn import DQN  # noqa: E402
from agilerl_tpu_torch.algorithms.dqn_rainbow import RainbowDQN, categorical_projection  # noqa: E402
from agilerl_tpu_torch.components import replay_buffer as RB  # noqa: E402
from agilerl_tpu_torch.envs.probe import (  # noqa: E402
    ConstantRewardEnv,
    DiscountedRewardEnv,
    check_q_learning_with_probe_env,
)
from agilerl_tpu_torch.hpo import Mutations  # noqa: E402
from agilerl_tpu_torch.networks.q_networks import QNetwork, RainbowQNetwork  # noqa: E402
from agilerl_tpu_torch.utils.tree import tree_map  # noqa: E402

torch.set_num_threads(1)

OBS = gspaces.Box(-1.0, 1.0, (4,), np.float32)
ACT = gspaces.Discrete(3)
NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
RAINBOW = dict(num_atoms=11, v_min=-2.0, v_max=2.0, noise_std=0.0)
SIGMAS = ("kernel_sigma", "bias_sigma")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
    return out


def _pair(kind, **kw):
    """A JAX agent and a port agent carrying its weights."""
    args = dict(net_config=NET, lr=1e-2, gamma=0.9, tau=0.1, seed=0, **kw)
    if kind.startswith("rainbow"):
        args.update(RAINBOW, n_step=3)
        jagent, cls = JRainbow(OBS, ACT, **args), RainbowDQN
    elif kind == "cqn":
        jagent, cls = JCQN(OBS, ACT, cql_alpha=0.5, **args), CQN
        args["cql_alpha"] = 0.5
    else:
        jagent, cls = JDQN(OBS, ACT, double=kind == "double", **args), DQN
        args["double"] = kind == "double"
    tagent = cls(OBS, ACT, device="cpu", **args)
    assert dataclasses.asdict(tagent.actor.config) == dataclasses.asdict(jagent.actor.config)
    load_params_from_numpy(tagent, {"actor": _np(jagent.actor.params),
                                    "actor_target": _np(jagent.actor_target.params)})
    return jagent, tagent


def _batch(rng, n=32):
    return {"obs": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
            "action": rng.integers(0, 3, n),
            "reward": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.uniform(-1, 1, (n, 4)).astype(np.float32),
            "done": (rng.random(n) < 0.3).astype(np.float32)}


def _zero_sigmas(tree):
    """Rainbow's noise scales set to 0 (a tree of either package)."""
    if isinstance(tree, dict):
        return {k: (v * 0 if k in SIGMAS else _zero_sigmas(v)) for k, v in tree.items()}
    return tree


def _assert_weights(tagent, jagent, atol=1e-5):
    for name in ("actor", "actor_target"):
        got = _flat(getattr(tagent, name).params)
        want = _flat(_np(getattr(jagent, name).params))
        assert set(got) == set(want)
        for p, w in want.items():
            if p.rsplit("/", 1)[-1] in SIGMAS:
                continue  # noise scales take noise-dependent steps
            np.testing.assert_allclose(got[p], w, atol=atol, rtol=0, err_msg=f"{name}{p}")


def test_q_networks_apply_on_carried_weights():
    """QNetwork, ContinuousQNetwork and RainbowQNetwork (expected Q and atom
    log-probabilities; at noise_std 0 the noisy apply equals the mean
    apply) on the JAX weights, atol 1e-5."""
    from agilerl_tpu.networks.q_networks import ContinuousQNetwork as JCQ
    from agilerl_tpu.networks.q_networks import QNetwork as JQ
    from agilerl_tpu.networks.q_networks import RainbowQNetwork as JRQ
    from agilerl_tpu_torch.networks.base import params_from_numpy
    from agilerl_tpu_torch.networks.q_networks import ContinuousQNetwork

    rng = np.random.default_rng(0)
    obs = rng.uniform(-1, 1, (9, 4)).astype(np.float32)
    jq = JQ(OBS, ACT, key=jax.random.PRNGKey(0), **NET)
    tq = QNetwork(OBS, ACT, device="cpu", **NET)
    tq.params = params_from_numpy(_np(jq.params), tq.config, "cpu")
    np.testing.assert_allclose(tq(torch.from_numpy(obs)).numpy(), np.asarray(jq(obs)), atol=1e-5)
    box = gspaces.Box(-1.0, 1.0, (2,), np.float32)
    act = rng.uniform(-1, 1, (9, 2)).astype(np.float32)
    jc = JCQ(OBS, box, key=jax.random.PRNGKey(3), **NET)
    tc = ContinuousQNetwork(OBS, box, device="cpu", **NET)
    assert dataclasses.asdict(tc.config) == dataclasses.asdict(jc.config)
    tc.params = params_from_numpy(_np(jc.params), tc.config, "cpu")
    np.testing.assert_allclose(tc(torch.from_numpy(obs), torch.from_numpy(act)).numpy(),
                               np.asarray(jc(obs, act)), atol=1e-5)
    for std in (0.5, 0.0):
        jr = JRQ(OBS, ACT, num_atoms=11, v_min=-2.0, v_max=2.0, noise_std=std,
                 key=jax.random.PRNGKey(1), **NET)
        tr = RainbowQNetwork(OBS, ACT, num_atoms=11, v_min=-2.0, v_max=2.0, noise_std=std,
                             device="cpu", **NET)
        assert dataclasses.asdict(tr.config) == dataclasses.asdict(jr.config)
        tr.params = params_from_numpy(_np(jr.params), tr.config, "cpu",
                                      init=RainbowQNetwork.init_params)
        assert set(tr.params) == {"encoder", "head", "value"}
        x = torch.from_numpy(obs)
        np.testing.assert_allclose(tr(x).numpy(), np.asarray(jr(obs)), atol=1e-5)
        np.testing.assert_allclose(tr(x, q_values=False).numpy(),
                                   np.asarray(jr(obs, q_values=False)), atol=1e-5)
        np.testing.assert_allclose(tr.support().numpy(), np.asarray(jr.support()), atol=1e-6)
        if std == 0.0:
            noisy = tr(x, key=torch.Generator().manual_seed(0)).numpy()
            np.testing.assert_allclose(noisy, np.asarray(jr(obs, key=jax.random.PRNGKey(2))),
                                       atol=1e-5)


def test_categorical_projection_matches_jax():
    """The C51 projection on random targets, targets clipped at both ends,
    and targets whose ``b`` is an integer (full mass on ``lower``): equal to
    the JAX one at atol 1e-6, and each row still sums to 1."""
    rng = np.random.default_rng(0)
    n, atoms = 12, 11
    support = np.linspace(-2.0, 2.0, atoms).astype(np.float32)
    dist = rng.dirichlet(np.ones(atoms), n).astype(np.float32)
    reward = rng.normal(size=n).astype(np.float32)
    reward[:3] = [5.0, -5.0, 0.4]  # clipped high, clipped low, b integral (done)
    done = (rng.random(n) < 0.3).astype(np.float32)
    done[:3] = [0.0, 0.0, 1.0]
    for gamma in (0.9, 1.0, 0.0):
        want = np.asarray(j_project(jnp.asarray(dist), jnp.asarray(reward), jnp.asarray(done),
                                    gamma, jnp.asarray(support), -2.0, 2.0))
        got = categorical_projection(*(torch.from_numpy(x) for x in (dist, reward, done)),
                                     gamma, torch.from_numpy(support), -2.0, 2.0).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert got[2, 6] == pytest.approx(1.0, abs=1e-6)  # gamma 0: r = 0.4 is atom 6


@pytest.mark.parametrize("kind", ["dqn", "double", "cqn", "rainbow", "rainbow_n_step"])
def test_learn_matches_jax(kind):
    """Three learn steps on identical batches (PER tuples for Rainbow, with
    the paired n-step batch for rainbow_n_step): loss rtol 1e-5, every weight
    of the online and target nets atol 1e-5, Rainbow's priorities rtol 1e-5.
    Rainbow runs at noise_std 0 with its noise scales set back to 0 before
    each step in both packages, so no step depends on the noise."""
    jagent, tagent = _pair(kind)
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = _batch(rng)
        if kind.startswith("rainbow"):
            for ag in (jagent, tagent):
                for name in ("actor", "actor_target"):
                    getattr(ag, name).params = _zero_sigmas(getattr(ag, name).params)
            idx = np.arange(32)
            w = rng.uniform(0.2, 1.0, 32).astype(np.float32)
            exp = (batch, idx, w) + ((_batch(rng),) if kind == "rainbow_n_step" else ())
            (jl, jp), (tl, tp) = jagent.learn(exp), tagent.learn(exp)
            np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7)
        else:
            jl, tl = jagent.learn(batch), tagent.learn(batch)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_weights(tagent, jagent)


@pytest.mark.parametrize("kind", ["dqn_uniform", "dqn_per", "cqn_per", "rainbow_per_n_step"])
def test_learn_from_buffer_equals_learn_on_its_batch(kind):
    """``learn_from_buffer`` on given draws equals ``learn`` on the batch
    (and PER weights, and paired n-step batch) those draws pick: the same
    loss, weights and written-back priorities."""
    algo, mode = kind.split("_", 1)
    cls = {"dqn": DQN, "cqn": CQN, "rainbow": RainbowDQN}[algo]
    args = dict(net_config=NET, lr=1e-2, gamma=0.9, tau=0.1, batch_size=16, seed=0,
                device="cpu", **(dict(RAINBOW, n_step=3) if algo == "rainbow" else {}))
    a = cls(OBS, ACT, **args)
    b = cls(OBS, ACT, **args)
    b.actor.params = tree_map(torch.clone, a.actor.params)
    b.actor_target.params = tree_map(torch.clone, a.actor_target.params)
    per = "per" in mode
    memory = (RB.PrioritizedReplayBuffer if per else RB.ReplayBuffer)(64, device="cpu")
    nst = RB.MultiStepReplayBuffer(64, n_step=3, gamma=0.9, device="cpu") \
        if "n_step" in mode else None
    rng = np.random.default_rng(2)
    for _ in range(10):
        tr = {k: v[:4] for k, v in _batch(rng).items()}
        if nst is None:
            memory.stage(tr, batched=True)
        else:
            nst.stage(dict(tr, _boundary=tr["done"]), batched=True)
    for step in range(2):
        RB.drain_staging(memory, nst)
        if per:
            draws = torch.from_numpy(rng.random(16).astype(np.float32))
            batch, idx, w = RB._per_sample(memory.per_state, draws, 0.4)
            exp = (batch, idx, w) + ((nst.sample_from_indices(idx),) if nst else ())
        else:
            draws = torch.from_numpy(rng.integers(0, len(memory), 16))
            exp = memory.sample_from_indices(draws)
        before = memory.per_state.priorities.clone() if per else None
        want = b.learn(exp)
        got = a.learn_from_buffer(memory, nst, beta=0.4, draws=draws)
        assert isinstance(got, torch.Tensor) and got.dim() == 0
        want_loss = want[0] if isinstance(want, tuple) else want
        np.testing.assert_allclose(float(got), want_loss, rtol=1e-6)
        for name in ("actor", "actor_target"):
            for p, x in _flat(getattr(b, name).params).items():
                np.testing.assert_allclose(_flat(getattr(a, name).params)[p], x, atol=1e-7,
                                           err_msg=f"{step}: {name}{p}")
        if per:
            expect = before.clone()
            RB._per_update(RB.PERState(memory.per_state.buffer, expect,
                                       memory.per_state.max_priority), idx,
                           torch.from_numpy(want[1]), memory.alpha)
            np.testing.assert_allclose(memory.per_state.priorities.numpy(), expect.numpy(),
                                       rtol=1e-6)


@pytest.mark.parametrize("kind", ["dqn", "rainbow"])
def test_greedy_get_action_matches_jax(kind):
    """Greedy actions on carried weights, batched, unbatched and masked,
    equal the JAX package's."""
    jagent, tagent = _pair(kind)
    rng = np.random.default_rng(3)
    obs = rng.uniform(-1, 1, (64, 4)).astype(np.float32)
    mask = rng.random((64, 3)) < 0.6
    mask[:, 0] = True
    np.testing.assert_array_equal(tagent.get_action(obs, training=False).numpy(),
                                  np.asarray(jagent.get_action(obs, training=False)))
    np.testing.assert_array_equal(
        tagent.get_action(obs, action_mask=mask, training=False).numpy(),
        np.asarray(jagent.get_action(obs, action_mask=mask, training=False)))
    assert int(tagent.get_action(obs[0], training=False)) == \
        int(np.asarray(jagent.get_action(obs[0], training=False)))


def test_masked_exploration_never_picks_a_masked_action():
    """Epsilon 1 with a mask: every action is allowed, and every allowed
    action of a row is drawn (uniform among the allowed)."""
    agent = DQN(OBS, ACT, net_config=NET, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    mask = rng.random((2000, 3)) < 0.5
    mask[np.arange(2000), rng.integers(0, 3, 2000)] = True
    obs = rng.uniform(-1, 1, (2000, 4)).astype(np.float32)
    a = agent.get_action(obs, epsilon=1.0, action_mask=mask).numpy()
    assert mask[np.arange(2000), a].all()
    two = mask.sum(1) == 2
    counts = np.bincount(a[two & mask[:, 1] & mask[:, 2] & ~mask[:, 0]], minlength=3)
    assert counts[0] == 0 and min(counts[1], counts[2]) > 0.35 * (counts[1] + counts[2])
    unmasked = agent.get_action(obs, epsilon=1.0).numpy()
    assert set(np.unique(unmasked)) == {0, 1, 2}


@pytest.mark.parametrize("algo", ["dqn", "rainbow"])
def test_mutations_leave_a_valid_target_net(algo):
    """Architecture mutations (for Rainbow a head layer mutation too, which
    moves the value stream with the head) rebuild actor_target from actor;
    learn_from_buffer then learns on the new shapes."""
    cls = RainbowDQN if algo == "rainbow" else DQN
    agent = cls(OBS, ACT, net_config=NET, batch_size=8, seed=0, device="cpu",
                **(RAINBOW if algo == "rainbow" else {}))
    memory = RB.PrioritizedReplayBuffer(32, device="cpu")
    memory.add({k: v[:16] for k, v in _batch(np.random.default_rng(5)).items()}, batched=True)
    agent.learn_from_buffer(memory)
    for seed in range(4):
        agent = Mutations(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                          new_layer_prob=0.5, rand_seed=seed).mutation([agent])[0]
        if algo == "rainbow":
            agent.actor.apply_mutation("head.add_layer", rng=np.random.default_rng(seed))
            Mutations()._reinit_shared(agent)
            agent.reinit_optimizers()
            agent.mutation_hook()
            value = agent.actor.params["value"]
            assert len(agent.actor.config.head.hidden_size) == \
                sum(k.startswith("layer_") for k in value)
        assert agent.actor_target.config == agent.actor.config
        assert all(np.array_equal(x, _flat(agent.actor.params)[p])
                   for p, x in _flat(agent.actor_target.params).items())
        loss = agent.learn_from_buffer(memory)
        assert torch.isfinite(loss)


@pytest.mark.parametrize("env_cls", [ConstantRewardEnv, DiscountedRewardEnv])
def test_dqn_probe_checks(env_cls):
    """The JAX package's DQN probe grid settings
    (tests/test_algorithms/test_probe_grid.py:55-67), through the port's
    check_q_learning_with_probe_env."""
    env = env_cls()
    check_q_learning_with_probe_env(
        env, DQN, dict(observation_space=env.observation_space, action_space=env.action_space,
                       lr=2e-3, gamma=0.9, tau=0.5, double=False, seed=0,
                       net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}},
                       device="cpu"),
        learn_steps=400)
