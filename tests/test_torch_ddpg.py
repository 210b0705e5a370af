"""Parity of the port's DDPG and TD3 (agilerl_tpu_torch: ``algorithms/ddpg``,
``algorithms/td3``, the sampled learn path of ``training/train_off_policy``,
``check_policy_q_learning_with_probe_env``) with the JAX package's on the CPU
in f32: carried weights, three learns (critic step, actor step on the
cadence, soft targets) on identical batches, TD3's smoothing on the JAX
draws, OU and Gaussian noise on the JAX draws, ``learn_from_buffer`` against
``learn`` on its batch, the sampled PER path against the JAX loop's branch,
an architecture mutation against the JAX engine's, the policy probe, and
both algorithms through ``train_off_policy`` on uniform replay and PER."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.ddpg import DDPG as JDDPG  # noqa: E402
from agilerl_tpu.algorithms.dqn import DQN as JDQN  # noqa: E402
from agilerl_tpu.algorithms.td3 import TD3 as JTD3  # noqa: E402
from agilerl_tpu.components.replay_buffer import PrioritizedReplayBuffer as JPER  # noqa: E402
from agilerl_tpu.components.sampler import Sampler as JSampler  # noqa: E402
from agilerl_tpu.hpo.mutation import Mutations as JMutations  # noqa: E402
from agilerl_tpu_torch.algorithms.core import fused as F  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.ddpg import DDPG, ou_noise_step  # noqa: E402
from agilerl_tpu_torch.algorithms.dqn import DQN  # noqa: E402
from agilerl_tpu_torch.algorithms.td3 import TD3  # noqa: E402
from agilerl_tpu_torch.components import replay_buffer as RB  # noqa: E402
from agilerl_tpu_torch.components.sampler import Sampler  # noqa: E402
from agilerl_tpu_torch.envs.core import TorchVecEnv  # noqa: E402
from agilerl_tpu_torch.envs.classic import Pendulum  # noqa: E402
from agilerl_tpu_torch.envs.probe import (  # noqa: E402
    FixedObsPolicyEnv,
    check_policy_q_learning_with_probe_env,
)
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.training.train_off_policy import (  # noqa: E402
    sampled_learn,
    train_off_policy,
)
from agilerl_tpu_torch.utils.tree import tree_map  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population  # noqa: E402

torch.set_num_threads(1)

OBS = gspaces.Box(-1.0, 1.0, (3,), np.float32)
ACT = gspaces.Box(np.array([-2.0, -1.0], np.float32), np.array([2.0, 0.5], np.float32))
NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
HP = dict(net_config=NET, lr_actor=1e-2, lr_critic=1e-2, gamma=0.9, tau=0.1, policy_freq=2,
          batch_size=16, seed=0)


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


def _nets(agent):
    return agent.registry.all_network_names()


def _pair(kind, **kw):
    """A JAX agent and a port agent carrying its weights (all six or four
    networks)."""
    jcls, tcls = (JTD3, TD3) if kind == "td3" else (JDDPG, DDPG)
    args = dict(HP, **kw)
    jagent = jcls(OBS, ACT, **args)
    tagent = tcls(OBS, ACT, device="cpu", **args)
    for name in _nets(tagent):
        assert dataclasses.asdict(getattr(tagent, name).config) == \
            dataclasses.asdict(getattr(jagent, name).config), name
    load_params_from_numpy(tagent, {n: _np(getattr(jagent, n).params) for n in _nets(tagent)})
    return jagent, tagent


def _batch(rng, n=16):
    return {"obs": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "action": rng.uniform(-1, 0.5, (n, 2)).astype(np.float32),
            "reward": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            "done": (rng.random(n) < 0.3).astype(np.float32)}


def _assert_weights(tagent, jagent, atol=1e-5):
    for name in _nets(tagent):
        got = _flat(getattr(tagent, name).params)
        want = _flat(_np(getattr(jagent, name).params))
        assert set(got) == set(want)
        for p, w in want.items():
            np.testing.assert_allclose(got[p], w, atol=atol, rtol=0, err_msg=f"{name}{p}")


def test_ddpg_learn_matches_jax():
    """Three learns on identical batches (the critic's TD step and soft
    target each time, the actor's step and soft target on learns 2 of
    policy_freq 2): critic loss rtol 1e-5, every weight of the four networks
    atol 1e-5; then greedy actions on the carried weights atol 1e-6."""
    jagent, tagent = _pair("ddpg")
    rng = np.random.default_rng(1)
    for _ in range(3):
        batch = _batch(rng)
        np.testing.assert_allclose(tagent.learn(batch), jagent.learn(batch), rtol=1e-5)
        _assert_weights(tagent, jagent)
    obs = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    np.testing.assert_allclose(tagent.get_action(obs, training=False).numpy(),
                               np.asarray(jagent.get_action(obs, training=False)), atol=1e-6)


def test_td3_learn_with_smoothing_matches_jax():
    """Three TD3 learns on identical batches and the JAX smoothing draws
    (``jax.random.normal`` of the learn's key, fed to the port's core):
    summed twin-critic loss rtol 1e-5, every weight of the six networks
    atol 1e-5 (targets move only on the policy cadence)."""
    jagent, tagent = _pair("td3", policy_noise=0.3, noise_clip=0.4)
    rng = np.random.default_rng(2)
    for i in range(3):
        batch = _batch(rng)
        key = jax.random.PRNGKey(10 + i)
        # the JAX learn, on a key of our choosing
        jagent.next_key = lambda key=key: key
        jl = jagent.learn(batch)
        # the port's learn (_update) on the same draws: the twin step, then
        # the actor on the cadence
        normal = torch.from_numpy(np.array(jax.random.normal(key, (16, 2))))
        pre = F.preprocess_batch(batch, tagent.observation_space, tagent.dev)
        tagent._learn_counter += 1
        update = tagent._learn_counter % tagent.policy_freq == 0
        tl = float(tagent._twin_update(pre, None, normal, update))
        if update:
            tagent._actor_update(pre)
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_weights(tagent, jagent)


def test_ou_and_gaussian_noise_match_jax():
    """Five steps of OU noise and one Gaussian draw on the JAX package's
    normals: atol 1e-7; the port's own draws come from the agent's
    generator, on its device."""
    for ou in (True, False):
        jagent, tagent = _pair("ddpg", O_U_noise=ou, expl_noise=0.3, mean_noise=0.05,
                               theta=0.2, dt=0.05)
        state = torch.zeros(4, 2)
        for i in range(5 if ou else 1):
            key = jax.random.PRNGKey(i)
            jagent.next_key = lambda key=key: key
            want = np.asarray(jagent.action_noise((4, 2)))
            normal = torch.from_numpy(np.array(jax.random.normal(key, (4, 2))))
            if ou:
                state = ou_noise_step(state, normal, 0.2, 0.05, 0.3, 0.05)
                got = state
            else:
                got = 0.05 + 0.3 * normal
            np.testing.assert_allclose(got.numpy(), want, atol=1e-7)
        noise = tagent.action_noise((4, 2), gen=torch.Generator().manual_seed(3))
        normal = torch.randn((4, 2), generator=torch.Generator().manual_seed(3))
        want = (ou_noise_step(torch.zeros(4, 2), normal, 0.2, 0.05, 0.3, 0.05) if ou
                else 0.05 + 0.3 * normal)
        assert noise.device == torch.device("cpu") and torch.equal(noise, want)


@pytest.mark.parametrize("kind", ["ddpg", "td3"])
def test_learn_from_buffer_equals_learn_on_its_batch(kind):
    """``learn_from_buffer`` on given indices (and TD3's smoothing draws
    from a given generator) equals ``learn`` on the rows those indices pick:
    the same loss and weights, bit for bit; it returns a 0-d device tensor
    and refuses a PER buffer."""
    cls = TD3 if kind == "td3" else DDPG
    a = cls(OBS, ACT, device="cpu", **HP)
    b = cls(OBS, ACT, device="cpu", **HP)
    for name in _nets(a):
        getattr(b, name).params = tree_map(torch.clone, getattr(a, name).params)
    memory = RB.ReplayBuffer(64, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(10):
        memory.stage({k: v[:4] for k, v in _batch(rng).items()}, batched=True)
    for step in range(3):
        draws = torch.from_numpy(rng.integers(0, 40, 16))
        b.next_key = lambda device="cpu", s=step: torch.Generator().manual_seed(s)
        want = b.learn(memory.sample_from_indices(draws))
        got = a.learn_from_buffer(memory, draws=draws, key=torch.Generator().manual_seed(step))
        assert isinstance(got, torch.Tensor) and got.dim() == 0
        assert float(got) == want
        for name in _nets(a):
            for p, x in _flat(getattr(b, name).params).items():
                np.testing.assert_array_equal(_flat(getattr(a, name).params)[p], x,
                                              err_msg=f"{step}: {name}{p}")
    with pytest.raises(NotImplementedError, match="uniform replay"):
        a.learn_from_buffer(RB.PrioritizedReplayBuffer(8, device="cpu"))


def _per_buffers(rows=48, seed=4):
    rng = np.random.default_rng(seed)
    jbuf = JPER(64, alpha=0.6, seed=seed)
    tbuf = RB.PrioritizedReplayBuffer(64, alpha=0.6, device="cpu")
    for _ in range(rows // 4):
        tr = {"obs": rng.uniform(-1, 1, (4, 3)).astype(np.float32),
              "action": rng.integers(0, 2, 4), "reward": rng.normal(size=4).astype(np.float32),
              "next_obs": rng.uniform(-1, 1, (4, 3)).astype(np.float32),
              "done": (rng.random(4) < 0.3).astype(np.float32)}
        jbuf.add(tr, batched=True)
        tbuf.add(tr, batched=True)
    return jbuf, tbuf


def test_sampled_per_path_matches_the_jax_loop_branch():
    """The loop's sampled learn path under PER (``Sampler.sample`` at the
    agent's beta, ``learn`` on the tuple, ``update_priorities`` with what it
    returns), for a DQN agent on carried weights, against the JAX loop's
    branch (``train_off_policy.py:313-331``) on the same rows and the JAX
    buffer's own uniforms: loss rtol 1e-5, priorities rtol 1e-5, max
    priority rtol 1e-5, weights atol 1e-5, twice in a row. A DDPG agent
    takes the same path: it learns and writes no priorities."""
    obs = gspaces.Box(-1.0, 1.0, (3,), np.float32)
    act = gspaces.Discrete(2)
    args = dict(net_config=NET, lr=1e-2, gamma=0.9, tau=0.1, batch_size=16, seed=0)
    jagent = JDQN(obs, act, **args)
    tagent = DQN(obs, act, device="cpu", **args)
    load_params_from_numpy(tagent, {n: _np(getattr(jagent, n).params)
                                    for n in ("actor", "actor_target")})
    jbuf, tbuf = _per_buffers()
    jsampler, tsampler = JSampler(memory=jbuf, per=True), Sampler(memory=tbuf, per=True)
    for _ in range(2):
        _, key = jax.random.split(jbuf._key)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (16,))))
        # the JAX branch, as the JAX loop runs it
        sampled = jsampler.sample(jagent.batch_size, beta=getattr(jagent, "beta", None))
        result = jagent.learn(sampled)
        if isinstance(result, tuple) and result[1] is not None:
            jbuf.update_priorities(sampled[1], result[1])
        loss = sampled_learn(tagent, tsampler, tbuf, per=True, draws=u)
        np.testing.assert_allclose(loss, result[0], rtol=1e-5)
        np.testing.assert_allclose(tbuf.per_state.priorities.numpy(),
                                   np.asarray(jbuf.per_state.priorities), rtol=1e-5, atol=0)
        np.testing.assert_allclose(float(tbuf.per_state.max_priority),
                                   float(jbuf.per_state.max_priority), rtol=1e-5)
        _, _, w = RB._per_sample(tbuf.per_state, u, 0.4)
        _, _, jw = jbuf.sample(16, beta=0.4, key=key)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-5)

    ddpg = DDPG(OBS, ACT, device="cpu", **HP)
    rng = np.random.default_rng(5)
    per = RB.PrioritizedReplayBuffer(64, device="cpu")
    per.add(_batch(rng, 32), batched=True)
    before = per.per_state.priorities.clone()
    loss = sampled_learn(ddpg, Sampler(memory=per, per=True), per, per=True)
    assert np.isfinite(loss) and torch.equal(per.per_state.priorities, before)


@pytest.mark.parametrize("kind", ["ddpg", "td3"])
def test_architecture_mutation_matches_jax(kind):
    """One architecture mutation per seed through both engines (the method
    drawn on the actor, applied to every eval net with one seed, the
    targets rebuilt): the same method, configs and preserved weights
    (atol 0 on the slabs both keep) on every network; a learn follows on
    the new shapes."""
    for seed in range(3):
        jagent, tagent = _pair(kind)
        before = {n: _flat(getattr(tagent, n).params) for n in _nets(tagent)}
        kw = dict(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                  new_layer_prob=0.5, rand_seed=seed)
        jagent = JMutations(**kw).mutation([jagent])[0]
        tagent = Mutations(**kw).mutation([tagent])[0]
        assert tagent.mut == jagent.mut
        for name in _nets(tagent):
            tnet, jnet = getattr(tagent, name), getattr(jagent, name)
            assert dataclasses.asdict(tnet.config) == dataclasses.asdict(jnet.config), name
            got, want = _flat(tnet.params), _flat(_np(jnet.params))
            assert {p: v.shape for p, v in got.items()} == {p: v.shape for p, v in want.items()}
            for p, old in before[name].items():
                if p in got:
                    slab = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, got[p].shape))
                    np.testing.assert_array_equal(got[p][slab], want[p][slab],
                                                  err_msg=f"{seed}: {name}{p}")
        for t_eval, t_tgt in (("actor", "actor_target"), ("critic", "critic_target")):
            for p, x in _flat(getattr(tagent, t_tgt).params).items():
                np.testing.assert_array_equal(_flat(getattr(tagent, t_eval).params)[p], x)
        assert np.isfinite(tagent.learn(_batch(np.random.default_rng(seed))))


@pytest.mark.parametrize("cls", [DDPG, TD3])
def test_policy_probe(cls):
    """The JAX package's DDPG probe settings
    (tests/test_algorithms/test_ddpg_probe.py) through the port's
    check_policy_q_learning_with_probe_env: the critic within 0.25 of the Q
    table and the greedy action of the policy table."""
    env = FixedObsPolicyEnv(continuous=True)
    check_policy_q_learning_with_probe_env(
        env, cls, dict(observation_space=env.observation_space, action_space=env.action_space,
                       lr_actor=3e-3, lr_critic=5e-3, gamma=0.9, tau=0.3, policy_freq=1,
                       O_U_noise=False, seed=2, device="cpu",
                       net_config={"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}}),
        learn_steps=400)


@pytest.mark.parametrize("algo", ["DDPG", "TD3"])
@pytest.mark.parametrize("per", [False, True])
def test_train_off_policy_runs_ddpg_and_td3(algo, per):
    """create_population and two generations of train_off_policy on the
    device Pendulum (uniform replay through learn_from_buffer, PER through
    the sampled path): finite fitness per agent and generation, every row
    stored, a DDPG checkpoint round trip with the same greedy actions."""
    env = TorchVecEnv(Pendulum(), num_envs=4, device="cpu")
    pop = create_population(algo, env.observation_space, env.action_space, NET,
                            {"POP_SIZE": 2, "BATCH_SIZE": 16, "LEARN_STEP": 2,
                             "O_U_NOISE": algo == "DDPG"}, device="cpu", seed=0)
    memory = (RB.PrioritizedReplayBuffer if per else RB.ReplayBuffer)(1000, device="cpu")
    pop, fit = train_off_policy(
        env, "Pendulum-v1", algo, pop, memory, max_steps=160, evo_steps=80, per=per,
        eval_steps=10, tournament=TournamentSelection(2, True, 2, 1),
        mutation=Mutations(activation=0, rand_seed=0), verbose=False)
    assert np.isfinite(fit).all() and np.shape(fit) == (2, 2) and len(memory) == 320
    if algo == "DDPG" and not per:
        import tempfile
        from pathlib import Path

        with tempfile.TemporaryDirectory() as work:
            pop[0].save_checkpoint(Path(work) / "ddpg.ckpt")
            loaded = DDPG.load(Path(work) / "ddpg.ckpt", device="cpu")
        obs = torch.rand(5, 3)
        assert torch.equal(loaded.get_action(obs, training=False),
                           pop[0].get_action(obs, training=False))
