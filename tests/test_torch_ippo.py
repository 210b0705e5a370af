"""Parity of the port's IPPO and its population program
(agilerl_tpu_torch: ``algorithms/ippo``, ``hpo/mutation``'s learn_step
branch, ``training/train_multi_agent_on_policy``,
``parallel/multi_agent.EvoIPPO``) with the JAX package's on the CPU in f32:
one IPPO ``learn`` on identical rollouts and the JAX permutations,
``collect_rollouts``' truncation bootstrap, masks and forced actions, an
architecture mutation against the JAX engine, the learn_step repair (the
JAX package's fault pinned), the loop's shapes against the JAX loop, the
policy probe, EvoIPPO's GAE and per-agent update against the JAX ones, a
member alone against its batched slice, snapshots, ScanRun and checkpoints."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import optax  # noqa: E402
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.core.registry import HyperparameterConfig as JHPConfig  # noqa: E402
from agilerl_tpu.algorithms.core.registry import RLParameter as JRLParameter  # noqa: E402
from agilerl_tpu.algorithms.ippo import IPPO as JIPPO  # noqa: E402
from agilerl_tpu.envs.multi_agent import MultiAgentJaxVecEnv, SimpleSpreadJax  # noqa: E402
from agilerl_tpu.hpo import Mutations as JMutations  # noqa: E402
from agilerl_tpu.hpo import TournamentSelection as JTournament  # noqa: E402
from agilerl_tpu.modules.mlp import MLPConfig as JMLPConfig  # noqa: E402
from agilerl_tpu.networks import distributions as JD  # noqa: E402
from agilerl_tpu.networks.base import NetworkConfig as JNetworkConfig  # noqa: E402
from agilerl_tpu.parallel.multi_agent import EvoIPPO as JEvoIPPO  # noqa: E402
from agilerl_tpu.training.train_multi_agent_on_policy import (  # noqa: E402
    train_multi_agent_on_policy as j_train,
)
from agilerl_tpu_torch.algorithms.core import optimizer as O  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.core.registry import (  # noqa: E402
    HyperparameterConfig,
    RLParameter,
)
from agilerl_tpu_torch.algorithms.ippo import IPPO  # noqa: E402
from agilerl_tpu_torch.envs import probe_ma as PM  # noqa: E402
from agilerl_tpu_torch.envs.multi_agent import (  # noqa: E402
    MultiAgentTorchVecEnv,
    SimpleSpreadTorch,
)
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules.mlp import MLPConfig  # noqa: E402
from agilerl_tpu_torch.networks import distributions as D  # noqa: E402
from agilerl_tpu_torch.networks.base import EvolvableNetwork, NetworkConfig  # noqa: E402
from agilerl_tpu_torch.parallel import (  # noqa: E402
    EvoIPPO,
    IPPOMemberState,
    ScanRun,
    population_load_state_dict,
)
from agilerl_tpu_torch.training.train_multi_agent_on_policy import (  # noqa: E402
    train_multi_agent_on_policy,
)
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402
from agilerl_tpu_torch.utils.utils import (  # noqa: E402
    create_population,
    load_population_checkpoint,
    save_population_checkpoint,
)

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
IDS = ["agent_0", "agent_1"]
N, T = 4, 8  # envs, learn_step


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


def _spaces(continuous, ids=IDS):
    obs = {a: gspaces.Box(-np.inf, np.inf, (6,), np.float32) for a in ids}
    act = ({a: gspaces.Box(-1.0, 1.0, (2,), np.float32) for a in ids} if continuous
           else {a: gspaces.Discrete(5) for a in ids})
    return obs, act


def _pair(continuous, ids=IDS, **kw):
    """A JAX IPPO and a port IPPO carrying its weights (every group's actor
    and critic, the normal's log_std too)."""
    obs, act = _spaces(continuous, ids)
    args = dict(dict(agent_ids=ids, net_config=NET, batch_size=16, lr=1e-2, learn_step=T,
                     num_envs=N, gamma=0.9, update_epochs=2, seed=0), **kw)
    jagent, tagent = JIPPO(obs, act, **args), IPPO(obs, act, device="cpu", **args)
    for name in ("actors", "critics"):
        for gid in tagent.grouped_agents:
            assert dataclasses.asdict(getattr(tagent, name)[gid].config) == \
                dataclasses.asdict(getattr(jagent, name)[gid].config)
    load_params_from_numpy(tagent, {n: {g: _np(net.params) for g, net in
                                        getattr(jagent, n).items()} for n in ("actors", "critics")})
    return jagent, tagent


def _adam(state):
    """The Adam moments' node (``mu``, ``nu``, ``count``) of an optimizer state."""
    if hasattr(state, "mu"):
        return state
    for sub in (state if isinstance(state, tuple) else getattr(state, "inner_state", ())):
        found = _adam(sub) if isinstance(sub, tuple) else None
        if found is not None:
            return found
    inner = getattr(state, "inner_state", None)
    return _adam(inner) if inner is not None else None


def _rollout(rng, continuous, rows):
    """One group's ``T`` buffered steps (``rows`` env rows each)."""
    steps = []
    for _ in range(T):
        act = (rng.normal(size=(rows, 2)).astype(np.float32) if continuous
               else rng.integers(0, 5, rows).astype(np.int32))
        steps.append(dict(obs=rng.normal(size=(rows, 6)).astype(np.float32), action=act,
                          reward=rng.normal(size=rows).astype(np.float32),
                          done=(rng.random(rows) < 0.2).astype(np.float32),
                          value=rng.normal(size=rows).astype(np.float32),
                          log_prob=(rng.normal(size=rows) - 1.5).astype(np.float32)))
    return steps


@pytest.mark.parametrize("continuous", [False, True])
def test_ippo_learn_matches_jax(continuous):
    """Identical rollouts in each group's buffer (continuous: two groups, one
    of two agents stacked as env rows; discrete: the one group of two), the
    same last obs and dones, the JAX package's permutations: the mean loss
    rtol 1e-5, the advantages atol 1e-5, every weight and Adam moment of
    each group atol 1e-5."""
    ids = ["agent_0", "agent_1", "scout_0"] if continuous else IDS
    jagent, tagent = _pair(continuous, ids)
    rng = np.random.default_rng(0)
    for gid, members in tagent.grouped_agents.items():
        for step in _rollout(rng, continuous, N * len(members)):
            jagent.rollout_buffers[gid].add(**step)
            tagent.rollout_buffers[gid].add(**{k: torch.from_numpy(v) for k, v in step.items()})
    last_obs = {a: rng.normal(size=(N, 6)).astype(np.float32) for a in ids}
    last_done = {a: (rng.random(N) < 0.5).astype(np.float32) for a in ids}
    jagent._last_obs, jagent._last_done = last_obs, last_done
    tagent._last_obs = {a: torch.from_numpy(v) for a, v in last_obs.items()}
    tagent._last_done = {a: torch.from_numpy(v) for a, v in last_done.items()}
    keys = list(jax.random.split(jax.random.PRNGKey(3), 4))
    minibatches = {}
    for gid, members in tagent.grouped_agents.items():
        total = T * N * len(members)
        nb = total // 16
        minibatches[gid] = [torch.from_numpy(np.asarray(
            jax.random.permutation(k, total))[: nb * 16].reshape(nb, 16).astype(np.int64))
            for k in keys[:2]]
        keys = keys[2:]
    it = iter(jax.random.split(jax.random.PRNGKey(3), 4))
    jagent.next_key = lambda: next(it)
    jloss = jagent.learn()
    tloss = tagent.learn(minibatches=minibatches)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for gid in tagent.grouped_agents:
        np.testing.assert_allclose(tagent.rollout_buffers[gid].state.advantages.numpy(),
                                   np.asarray(jagent.rollout_buffers[gid].state.advantages),
                                   atol=1e-5)
        assert tagent.rollout_buffers[gid].state.t == 0
        for name in ("actors", "critics"):
            got = _flat(getattr(tagent, name)[gid].params)
            for p, want in _flat(_np(getattr(jagent, name)[gid].params)).items():
                np.testing.assert_allclose(got[p], want, atol=1e-5, err_msg=f"{name}[{gid}]{p}")
        tadam = _adam(tagent.optimizer.opt_state[gid])
        jadam = _adam(jagent.optimizer.opt_state[gid])
        assert int(tadam.count) == int(jadam.count) == 2 * (T * N * len(
            tagent.grouped_agents[gid]) // 16)
        for a, b in zip(tree_leaves((tadam.mu, tadam.nu)),
                        jax.tree_util.tree_leaves((jadam.mu, jadam.nu))):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_collect_rollouts_bootstrap_masks_and_forced_actions():
    """30 steps on SimpleSpread (4 envs, truncation at 25): each group's
    buffer holds both agents as env rows; the reward where an episode is
    truncated carries gamma * V(final_obs) and nowhere else (atol 1e-6); the
    returned mean equals the buffer's rewards' mean. An action mask latches
    masked mode (never violated; later steps carry all-ones masks) and an
    env-defined action is the buffered action with its own log-prob."""
    env = SimpleSpreadTorch(2)
    vec = MultiAgentTorchVecEnv(env, num_envs=N, seed=0, device="cpu")
    _, agent = _pair(False, learn_step=30)
    seen = []
    step = vec.step

    def recording(actions):
        out = step(actions)
        seen.append(out)
        return out

    vec.step = recording
    mean = agent.collect_rollouts(vec)
    buf = agent.rollout_buffers["agent"]
    assert buf.state.t == 30 and buf.state.data["obs"].shape == (30, 2 * N, 6)
    rewards = buf.state.data["reward"]
    for t, (_, rew, term, trunc, info) in enumerate(seen):
        for i, a in enumerate(IDS):
            want = rew[a].clone()
            if trunc[a].any():
                v = EvolvableNetwork.apply(agent.critics["agent"].config,
                                           agent.critics["agent"].params,
                                           info["final_obs"][a])[..., 0]
                want = want + 0.9 * v * (trunc[a] & ~term[a])
            torch.testing.assert_close(rewards[t, i * N:(i + 1) * N], want, rtol=0, atol=1e-6)
    assert seen[24][3]["agent_0"].all() and not seen[23][3]["agent_0"].any()
    np.testing.assert_allclose(mean, float(rewards.mean()), atol=1e-5)
    agent.learn()

    obs = {a: torch.randn(N, 6) for a in IDS}
    info = {"agent_0": {"action_mask": np.array([0, 1, 0, 0, 1])},
            "agent_1": {"env_defined_action": np.array([3, np.nan, 3, np.nan])}}
    acts = agent.get_action(obs, infos=info)
    assert set(acts["agent_0"].tolist()) <= {1, 4} and agent._ma_masked
    assert acts["agent_1"][0] == 3 and acts["agent_1"][2] == 3
    logits = EvolvableNetwork.apply(agent.actors["agent"].config, agent.actors["agent"].params,
                                    obs["agent_1"])
    cfg = agent.actors["agent"].dist_config
    torch.testing.assert_close(agent._cached_logps["agent_1"],
                               D.log_prob(cfg, logits, acts["agent_1"]), rtol=0, atol=1e-6)
    agent.get_action(obs)
    assert torch.equal(agent._cached_masks["agent_0"], torch.ones(N, 5))


def test_architecture_mutation_matches_jax():
    """One architecture mutation per seed through both engines (the method
    drawn on the first group's actor, applied to every actor and critic
    with one seed, the per-group optimizer states re-initialised): the same
    method, configs and preserved weights (atol 0 on the slabs both keep);
    a collect and a learn follow on the new shapes."""
    vec = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=N, seed=0, device="cpu")
    for seed in range(3):
        jagent, tagent = _pair(seed == 1)
        before = {(n, "agent"): _flat(getattr(tagent, n)["agent"].params)
                  for n in ("actors", "critics")}
        kw = dict(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                  new_layer_prob=0.5, rand_seed=seed)
        jagent = JMutations(**kw).mutation([jagent])[0]
        tagent = Mutations(**kw).mutation([tagent])[0]
        assert tagent.mut == jagent.mut
        for (name, gid), old_params in before.items():
            tnet, jnet = getattr(tagent, name)[gid], getattr(jagent, name)[gid]
            assert dataclasses.asdict(tnet.config) == dataclasses.asdict(jnet.config)
            got, want = _flat(tnet.params), _flat(_np(jnet.params))
            assert {p: v.shape for p, v in got.items()} == {p: v.shape for p, v in want.items()}
            for p, old in old_params.items():
                if p in got:
                    slab = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, got[p].shape))
                    np.testing.assert_array_equal(got[p][slab], want[p][slab])
        assert set(tagent.optimizer.opt_state) == {"agent"}
        if seed != 1:
            tagent.collect_rollouts(vec)
            assert np.isfinite(tagent.learn())


def test_learn_step_mutation_resizes_every_group_buffer():
    """The port's repair: a learn_step mutation gives every group's buffer
    the new horizon, reallocated at the next collect. The JAX engine (its
    hpo/mutation.py:303-305 resizes ``rollout_buffer`` only) leaves IPPO's
    buffers at the old horizon: a shorter collect leaves stale rows in the
    16-row buffer, and a longer one drops its rows past row 16."""
    ids = ["agent_0", "agent_1", "scout_0"]
    for rand_seed in (1, 5):
        jagent, tagent = _pair(False, ids, learn_step=16, num_envs=2)
        for agent, hp, rlp, M in ((jagent, JHPConfig, JRLParameter, JMutations),
                                  (tagent, HyperparameterConfig, RLParameter, Mutations)):
            agent.registry.hp_config = hp(learn_step=rlp(min=8, max=64, dtype=int))
            M(no_mutation=0, architecture=0, parameters=0, activation=0, rl_hp=1,
              rand_seed=rand_seed).mutation([agent])
            assert agent.mut == "learn_step" and agent.learn_step != 16
        assert tagent.learn_step == jagent.learn_step
        for gid in ("agent", "scout"):
            assert tagent.rollout_buffers[gid].capacity == tagent.learn_step
            assert tagent.rollout_buffers[gid].state is None
            # the JAX package's fault, pinned
            assert jagent.rollout_buffers[gid].capacity == 16
    # a learn follows on the new horizon in the port
    agent = IPPO(*_spaces(False), agent_ids=IDS, net_config=NET, learn_step=16, num_envs=N,
                 batch_size=16, seed=0, device="cpu")
    agent.registry.hp_config = HyperparameterConfig(learn_step=RLParameter(min=8, max=64,
                                                                           dtype=int))
    Mutations(no_mutation=0, architecture=0, parameters=0, activation=0, rl_hp=1,
              rand_seed=1).mutation([agent])
    vec2 = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=N, seed=0, device="cpu")
    agent.collect_rollouts(vec2)
    assert agent.rollout_buffers["agent"].state.data["obs"].shape[:2] == (agent.learn_step, 2 * N)
    assert np.isfinite(agent.learn())


def test_jax_rollout_buffer_drops_rows_past_its_capacity():
    """What the JAX buffer does with the rows of a collect longer than its
    horizon (the upward learn_step mutation): its scatter drops them, and
    its cursor runs past the capacity."""
    from agilerl_tpu.components.rollout_buffer import RolloutBuffer as JRolloutBuffer

    buf = JRolloutBuffer(capacity=4, num_envs=2)
    for t in range(6):
        buf.add(obs=np.full((2, 1), t, np.float32), action=np.zeros(2),
                reward=np.full(2, float(t)), done=np.zeros(2), value=np.zeros(2),
                log_prob=np.zeros(2))
    assert int(buf.state.t) == 6
    np.testing.assert_array_equal(np.asarray(buf.state.data["reward"])[:, 0], [0, 1, 2, 3])


def test_train_multi_agent_on_policy_returns_the_jax_loops_shapes(tmp_path):
    """Population 2 of IPPO on SimpleSpread (2 agents, 4 envs, learn_step 8),
    one generation of 32 env steps, tournament and mutation: the port's loop
    returns what the JAX loop returns (population size, one finite fitness
    per agent, steps); resilience= runs (a cadence snapshot) and wb= raises."""
    hp = {"POP_SIZE": 2, "BATCH_SIZE": 16, "LEARN_STEP": 8, "NUM_ENVS": 4, "AGENT_IDS": IDS}
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from agilerl_tpu.utils.utils import create_population as j_create

            env = MultiAgentJaxVecEnv(SimpleSpreadJax(2), num_envs=4, seed=0)
            pop = j_create("IPPO", env.observation_spaces, env.action_spaces, NET, hp, seed=0)
            tourn, mut, train = JTournament(2, True, 2, 1), JMutations(1.0, 0, 0, 0, 0, 0), j_train
        else:
            env = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=4, seed=0, device="cpu")
            pop = create_population("IPPO", env.observation_spaces, env.action_spaces, NET, hp,
                                    seed=0, device="cpu")
            assert all(a.num_envs == 4 and a.agent_ids == IDS for a in pop)
            tourn = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
            mut, train = Mutations(1.0, 0, 0, 0, 0, 0, rand_seed=0), train_multi_agent_on_policy
        pop, fits = train(env, "simple_spread", "IPPO", pop, max_steps=32, evo_steps=32,
                          eval_steps=5, tournament=tourn, mutation=mut, verbose=False)
        out[pkg] = dict(pop=len(pop), fits=[len(f) for f in fits],
                        finite=bool(np.isfinite(np.asarray(fits)).all()),
                        steps=[a.steps for a in pop], algo=[type(a).__name__ for a in pop])
    assert out["torch"] == out["jax"] and out["torch"]["fits"] == [1, 1]
    from agilerl_tpu_torch.resilience import Resilience

    for hook in (dict(resilience=Resilience(tmp_path, save_every=1, handle_signals=False)),
                 dict(wb=True)):
        if "wb" in hook:
            with pytest.raises(NotImplementedError, match="slice 6"):
                train_multi_agent_on_policy(env, "s", "IPPO", pop, max_steps=1, **hook)
            continue
        train_multi_agent_on_policy(env, "s", "IPPO", pop, max_steps=64, evo_steps=32,
                                    eval_steps=5, verbose=False, **hook)
        assert [s.kind for s in hook["resilience"].manager.snapshots()] == ["cadence"]


@pytest.mark.parametrize("env_name", ["PolicyEnvMA", "FixedObsPolicyEnvMA"])
def test_policy_probe(env_name):
    """The JAX package's IPPO probe settings (tests/test_envs/test_probe_ma.py).
    PolicyEnvMA, that test's probe: PPO on a solved one-step probe is
    seed-sensitive in both packages (solved on the CPU on 28 of seeds 0-39
    by the port, 18 of seeds 0-22 by the JAX package), so the gate is the
    population gate's: at least two of seeds 0-2 pass; the seeds run until
    the gate is decided (the verdict does not depend on their order; the
    port's seed 0 is the slow one, 50 iterations without solving).
    FixedObsPolicyEnvMA (16 of 16 seeds on the CPU) on seed 0."""
    env = getattr(PM, env_name)()
    seeds, need = ((1, 2, 0), 2) if env_name == "PolicyEnvMA" else ((0,), 1)
    passed = failed = 0
    for seed in seeds:
        if passed >= need or failed > len(seeds) - need:
            break  # the gate is decided
        try:
            PM.check_ma_on_policy_with_probe_env(
                env, IPPO, dict(observation_spaces=env.observation_spaces,
                                action_spaces=env.action_spaces, agent_ids=env.agent_ids,
                                net_config={"latent_dim": 16, "encoder_config": {
                                    "hidden_size": (32,)}},
                                num_envs=8, learn_step=32, batch_size=64, update_epochs=4,
                                lr=5e-3, gamma=0.9, ent_coef=0.01, seed=seed, device="cpu"),
                train_iters=50)
            passed += 1
        except AssertionError:
            failed += 1
    assert passed >= need, passed


def test_ippo_checkpoint_round_trip(tmp_path):
    """An IPPO after a learn, saved and loaded (and through
    load_population_checkpoint): weights and per-group Adam states equal,
    the same greedy actions."""
    vec = MultiAgentTorchVecEnv(SimpleSpreadTorch(2, continuous=True), num_envs=N, seed=0,
                                device="cpu")
    _, agent = _pair(True)
    agent.collect_rollouts(vec)
    agent.learn()
    agent.save_checkpoint(tmp_path / "ippo.ckpt")
    save_population_checkpoint([agent], str(tmp_path / "pop.ckpt"))
    for loaded in (IPPO.load(tmp_path / "ippo.ckpt", device="cpu"),
                   load_population_checkpoint("IPPO", str(tmp_path / "pop.ckpt"), [0],
                                              device="cpu")[0]):
        for name in ("actors", "critics"):
            for p, x in _flat(getattr(agent, name)["agent"].params).items():
                np.testing.assert_array_equal(_flat(getattr(loaded, name)["agent"].params)[p], x)
        for a, b in zip(tree_leaves(loaded.optimizer.opt_state),
                        tree_leaves(agent.optimizer.opt_state)):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
        obs = {a: torch.randn(8, 6) for a in IDS}
        for a in IDS:
            assert torch.equal(loaded.get_action(obs, training=False)[a],
                               agent.get_action(obs, training=False)[a])


# --------------------------------------------------------------------------- #
# EvoIPPO
# --------------------------------------------------------------------------- #

LATENT, HIDDEN = 8, 16


def _configs(pkg, out):
    mlp, net = (JMLPConfig, JNetworkConfig) if pkg == "jax" else (MLPConfig, NetworkConfig)
    enc = mlp(num_inputs=6, num_outputs=LATENT, hidden_size=(HIDDEN,), output_vanish=False)
    return [net(encoder_kind="mlp", encoder=enc, latent_dim=LATENT,
                head=mlp(num_inputs=LATENT, num_outputs=n, hidden_size=(HIDDEN,)))
            for n in (out, 1)]


def _evo_pair(continuous=False, **kw):
    kw = dict(dict(num_envs=4, rollout_len=8, update_epochs=2, num_minibatches=2), **kw)
    jenv, tenv = SimpleSpreadJax(2, continuous), SimpleSpreadTorch(2, continuous)
    out = 2 if continuous else 5
    ja, jc = _configs("jax", out)
    ta, tc = _configs("torch", out)
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    jevo = JEvoIPPO(jenv, ja, jc, JD.dist_config_from_space(jenv.action_spaces["agent_0"]),
                    optax.adam(1e-2), **kw)
    tevo = EvoIPPO(tenv, ta, tc, D.dist_config_from_space(tenv.action_spaces["agent_0"]),
                   O.adam(1e-2), device="cpu", **kw)
    return jevo, tevo


def test_evoippo_gae_matches_jax():
    """GAE over [T, P, A, N] at once against the JAX per-agent GAE vmapped
    over agents (each agent's rewards, values, the shared dones): atol 1e-6."""
    jevo, tevo = _evo_pair()
    rng = np.random.default_rng(1)
    rew, val = (rng.normal(size=(8, 2, 4)).astype(np.float32) for _ in range(2))
    done = (rng.random((8, 1, 4)) < 0.2).astype(np.float32).repeat(2, axis=1)
    last = rng.normal(size=(2, 4)).astype(np.float32)
    jadv, jret = jax.vmap(jevo._gae, in_axes=(1, 1, 1, 0), out_axes=(1, 1))(rew, val, done, last)
    adv, ret = tevo._gae(*(torch.from_numpy(x) for x in (rew, val, done, last)))
    np.testing.assert_allclose(adv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.asarray(jret), atol=1e-6)


@pytest.mark.parametrize("continuous", [False, True])
def test_evoippo_agent_update_matches_jax(continuous):
    """Two epochs of two minibatches for each of two agents' stacked rows, in
    the JAX package's permutations: the mean loss rtol 1e-5, the weights
    and Adam moments rtol 1e-5, atol 5e-6 (f32 summation order through four
    Adam steps at lr 1e-2)."""
    jevo, tevo = _evo_pair(continuous)
    jpop = jax.jit(jevo.init_member)(jax.random.PRNGKey(3))
    rng = np.random.default_rng(2)
    A, R = 2, 32
    act = (rng.normal(size=(A, R, 2)).astype(np.float32) if continuous
           else rng.integers(0, 5, (A, R)).astype(np.int32))
    flat = {"obs": rng.normal(size=(A, R, 6)).astype(np.float32), "action": act,
            "logp": (rng.normal(size=(A, R)) - 1.5).astype(np.float32),
            "adv": rng.normal(size=(A, R)).astype(np.float32),
            "ret": rng.normal(size=(A, R)).astype(np.float32)}
    keys = jax.random.split(jax.random.PRNGKey(5), A)
    jparams = {"actor": jpop.actor, "critic": jpop.critic}
    jp, jopt, jloss = jax.jit(jax.vmap(jevo._agent_update))(jparams, jpop.opt_state, flat, keys)
    params = f32_tree_from_numpy(_np(jparams), "cpu")
    opt = tree_map(lambda *xs: torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0],
                   *[tevo.tx.init(tree_map(lambda x, _i=i: x[_i], params)) for i in range(A)])
    perm = []
    for k in keys:
        ks = jax.random.split(k, tevo.update_epochs)
        perm.append([np.asarray(jax.random.permutation(e, R)) for e in ks])
    perm = torch.from_numpy(np.swapaxes(np.asarray(perm), 0, 1).astype(np.int64))
    tp, topt, tloss = tevo._agent_update(params, opt, {k: torch.from_numpy(v)
                                                       for k, v in flat.items()}, perm)
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    assert topt[0].count == 4
    for got, want in zip(tree_leaves((tp, topt[0].mu, topt[0].nu)),
                         jax.tree_util.tree_leaves((jp, jopt[0].mu, jopt[0].nu))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=5e-6)


def _iteration_inputs(tevo, P, seed):
    gen = torch.Generator().manual_seed(seed)
    return tevo.init_population(seed, P), tevo.draw_iteration(P, gen)


def _member(tree, p, dim=0):
    return tree_map(lambda x: x.narrow(dim, p, 1) if isinstance(x, torch.Tensor) else x, tree)


@pytest.mark.parametrize("continuous", [False, True])
def test_evoippo_member_slice_equals_the_member_alone(continuous):
    """A member's slice of the batched iteration (rollout past a truncation,
    GAE, the PPO epochs) equals its iteration run alone on its slice of the
    draws: fitness and every leaf atol 1e-5; the population's leaves are
    [P, A, ...] and fitness is finite."""
    _, tevo = _evo_pair(continuous, rollout_len=30)
    pop, draws = _iteration_inputs(tevo, 3, 1)
    assert pop.obs.shape == (3, 2, 4, 6) and pop.actor["head"]["output"]["kernel"].shape[:2] \
        == (3, 2)
    out, fit = tevo.member_iteration(pop, draws)
    assert fit.shape == (3,) and torch.isfinite(fit).all()
    for p in (0, 2):
        d = {"action": draws["action"].narrow(1, p, 1),
             "reset": tree_map(lambda x, _p=p: x.narrow(1, _p, 1), draws["reset"]),
             "perm": draws["perm"].narrow(1, p, 1)}
        out1, fit1 = tevo.member_iteration(_member(pop, p), d)
        torch.testing.assert_close(fit1[0], fit[p], rtol=0, atol=1e-5)
        for a, b in zip(tree_leaves(out1), tree_leaves(_member(out, p))):
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-5)


def test_evoippo_scan_run_snapshot_and_evolve():
    """ScanRun over two generations (finite [2, P] fitness), a bit-exact
    state_dict round trip and resume, evolve zeroing the running returns
    and keeping shapes, and the pod generation raising for slice 6."""
    _, tevo = _evo_pair(rollout_len=16)
    assert tevo.env_steps_per_generation == 64
    run = ScanRun(tevo, pop_size=3, seed=0)
    hist = run.run(2)
    assert hist.shape == (2, 3) and np.isfinite(hist).all()
    assert isinstance(run.pop, IPPOMemberState) and (run.pop.ep_ret == 0).all()
    blob = tevo.state_dict(run.pop)
    restored = tevo.load_state_dict(tevo.init_population(5, 3), blob)
    for a, b in zip(tree_leaves(run.pop), tree_leaves(restored)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    ckpt, rng = run.checkpoint_dict(), run.rng_state()
    expected = run.run(1)
    run2 = ScanRun(tevo, pop_size=3, seed=9)
    run2._restore(ckpt)
    run2.set_rng_state(rng)
    np.testing.assert_array_equal(run2.run(1), expected)
    with pytest.raises(ValueError, match="shape"):
        population_load_state_dict(tevo.init_population(0, 2), blob)
    with pytest.raises(NotImplementedError, match="slice 6"):
        tevo.make_pod_generation()
