"""Parity of the port's off-policy population programs (agilerl_tpu_torch:
``parallel/generation`` rings and ``ScanOffPolicy``, ``parallel/off_policy``)
with the JAX package's on the CPU in f32: every ring helper on the JAX draws
(writes across wraparound, uniform and PER samples, the priority
write-back, n-step folds at stride ``num_envs`` across wraparound and
boundaries), each ``Evo*`` learn against the JAX one on one batch, a member
alone against its slice of the batched program, the scan DQN's and DDPG's
per-tick losses against the per-agent ``learn_from_buffer`` on the same
transitions and draws, evolution, snapshots and ``ScanRun`` over all four."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from agilerl_tpu.envs import CartPole as JCartPole  # noqa: E402
from agilerl_tpu.envs import Pendulum as JPendulum  # noqa: E402
from agilerl_tpu.networks.actors import DeterministicActor as JActor  # noqa: E402
from agilerl_tpu.networks.q_networks import ContinuousQNetwork as JCQ  # noqa: E402
from agilerl_tpu.networks.q_networks import QNetwork as JQ  # noqa: E402
from agilerl_tpu.networks.q_networks import RainbowQNetwork as JRQ  # noqa: E402
from agilerl_tpu.parallel import generation as JG  # noqa: E402
from agilerl_tpu.parallel import off_policy as JO  # noqa: E402
from agilerl_tpu_torch.algorithms.core.optimizer import adam  # noqa: E402
from agilerl_tpu_torch.algorithms.ddpg import DDPG  # noqa: E402
from agilerl_tpu_torch.algorithms.dqn import DQN  # noqa: E402
from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer  # noqa: E402
from agilerl_tpu_torch.envs.classic import CartPole, Pendulum  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.networks.actors import DeterministicActor  # noqa: E402
from agilerl_tpu_torch.networks.q_networks import (  # noqa: E402
    ContinuousQNetwork,
    QNetwork,
    RainbowQNetwork,
)
from agilerl_tpu_torch.parallel import (  # noqa: E402
    EvoDDPG,
    EvoDQN,
    EvoRainbow,
    EvoTD3,
    ScanRun,
    ring_init,
    ring_nstep_gather,
    ring_sample_per,
    ring_sample_uniform,
    ring_update_priorities,
    ring_write,
)
from agilerl_tpu_torch.parallel import off_policy as O  # noqa: E402
from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
CAP, N, P = 24, 4, 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    else:
        out[prefix] = np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)
    return out


def _rows(rng, n=N):
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32),
            "action": rng.integers(0, 3, n).astype(np.int32),
            "reward": rng.normal(size=n).astype(np.float32),
            "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
            "done": (rng.random(n) < 0.2).astype(np.float32),
            "boundary": (rng.random(n) < 0.35).astype(np.float32)}


def _rings(ticks, seed=0):
    """P JAX rings and the port's stacked ring, written with the same
    ``ticks`` [N]-row batches per member."""
    rng = np.random.default_rng(seed)
    example = {k: v[0] for k, v in _rows(rng).items()}
    jrings = [JG.ring_init(example, CAP) for _ in range(P)]
    ring = ring_init(example, CAP, P, "cpu")
    for _ in range(ticks):
        rows = [_rows(rng) for _ in range(P)]
        jrings = [JG.ring_write(r, b) for r, b in zip(jrings, rows)]
        ring = ring_write(ring, {k: torch.from_numpy(np.stack([b[k] for b in rows]))
                                 for k in rows[0]})
    return jrings, ring


def _assert_member(got, want, p, atol=0.0):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k])[p], np.asarray(want[k]), atol=atol,
                                   rtol=0, err_msg=k)


def test_ring_write_and_uniform_sample_match_jax():
    """Eight ticks of four rows into a 24-row ring (it wraps): each member's
    storage, cursor, fill and priorities equal its JAX ring's; a uniform
    sample at the JAX indices gives the JAX rows."""
    jrings, ring = _rings(8)
    for p, jr in enumerate(jrings):
        _assert_member(ring.storage, jr.storage, p)
        assert (ring.pos, ring.size) == (int(jr.pos), int(jr.size))
        np.testing.assert_array_equal(ring.priorities[p].numpy(), np.asarray(jr.priorities))
    idx = []
    for p, jr in enumerate(jrings):
        jbatch, jidx, _ = JG.ring_sample_uniform(jr, jax.random.PRNGKey(p), 16)
        idx.append(np.asarray(jidx))
    batch, _, w = ring_sample_uniform(ring, _t(np.stack(idx)).long())
    for p, jr in enumerate(jrings):
        jbatch, _, _ = JG.ring_sample_uniform(jr, jax.random.PRNGKey(p), 16)
        _assert_member(batch, jbatch, p)
    assert torch.equal(w, torch.ones(P, 16))


@pytest.mark.parametrize("ticks", [3, 8])
def test_ring_per_sample_and_update_match_jax(ticks):
    """The priority write-back (floored, alpha-powered, the running max;
    duplicate indices carry one value) and a PER sample on the JAX uniforms:
    the same indices, importance weights atol 1e-6, priorities rtol 1e-6;
    rows written after the update get the new max."""
    jrings, ring = _rings(ticks)
    rng = np.random.default_rng(1)
    upd_idx = rng.integers(0, ring.size, (P, 10))
    pri = rng.uniform(0, 3, (P, 10)).astype(np.float32)
    pri[:, 0] = 0.0
    upd_idx[:, 1] = upd_idx[:, 2]
    pri[:, 1] = pri[:, 2]
    jrings = [JG.ring_update_priorities(jr, jnp.asarray(upd_idx[p]), jnp.asarray(pri[p]),
                                        jnp.float32(0.6)) for p, jr in enumerate(jrings)]
    ring = ring_update_priorities(ring, _t(upd_idx).long(), _t(pri), 0.6)
    for p, jr in enumerate(jrings):
        np.testing.assert_allclose(ring.priorities[p].numpy(), np.asarray(jr.priorities),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ring.max_priority[p]), float(jr.max_priority), rtol=1e-6)
    u, want = [], []
    for p, jr in enumerate(jrings):
        key = jax.random.PRNGKey(10 + p)
        u.append(np.asarray(jax.random.uniform(key, (32,))))
        want.append(JG.ring_sample_per(jr, key, 32, jnp.float32(0.4)))
    batch, idx, w = ring_sample_per(ring, _t(np.stack(u)), 0.4)
    for p, (jbatch, jidx, jw) in enumerate(want):
        np.testing.assert_array_equal(idx[p].numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w[p].numpy(), np.asarray(jw), atol=1e-6, rtol=0)
        _assert_member(batch, jbatch, p)
    rows = [_rows(rng) for _ in range(P)]
    jrings = [JG.ring_write(r, b) for r, b in zip(jrings, rows)]
    ring = ring_write(ring, {k: _t(np.stack([b[k] for b in rows])) for k in rows[0]})
    for p, jr in enumerate(jrings):
        np.testing.assert_allclose(ring.priorities[p].numpy(), np.asarray(jr.priorities),
                                   rtol=1e-6)


@pytest.mark.parametrize("ticks", [4, 9])
def test_ring_nstep_gather_matches_jax(ticks):
    """The 3-step fold at stride num_envs (4) over a 24-row ring, before
    and after it wraps, with boundaries: every start index, each output
    (reward and steps atol 1e-6, the rest exact) equals the JAX fold's."""
    jrings, ring = _rings(ticks, seed=2)
    idx = np.tile(np.arange(ring.size), (P, 1))
    got = ring_nstep_gather(ring, _t(idx).long(), 3, 0.9, stride=N)
    for p, jr in enumerate(jrings):
        want = JG.ring_nstep_gather(jr, jnp.asarray(idx[p]), 3, 0.9, stride=N)
        for k in want:
            np.testing.assert_allclose(got[k][p].numpy(), np.asarray(want[k]), atol=1e-6,
                                       rtol=0, err_msg=k)
        assert float(jnp.max(want["steps"])) == 3.0 and float(jnp.min(want["steps"])) == 1.0


# --------------------------------------------------------------------------- #
# each Evo* learn against the JAX one
# --------------------------------------------------------------------------- #


def _stacked(tree):
    return tree_map(lambda x: x[None], f32_tree_from_numpy(_np(tree), "cpu"))


def _batch(rng, B, obs_dim, action):
    out = {"obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
           "reward": rng.normal(size=B).astype(np.float32),
           "next_obs": rng.normal(size=(B, obs_dim)).astype(np.float32),
           "done": (rng.random(B) < 0.3).astype(np.float32)}
    out["action"] = action(B)
    return out


def _port(batch):
    return None if batch is None else {k: _t(v)[None] for k, v in batch.items()}


def _assert_tree(got, want, atol=1e-5, skip=()):
    g, w = _flat(got), _flat(_np(want))
    for p, x in w.items():
        if p.rsplit("/", 1)[-1] in skip:
            continue
        np.testing.assert_allclose(g[p][0], x, atol=atol, rtol=0, err_msg=p)


@pytest.mark.parametrize("kind", ["dqn_double_per_nstep", "rainbow", "ddpg", "td3"])
def test_evo_learn_matches_jax(kind):
    """One learn of each program on one batch (PER weights and an n-step
    fold where the program takes them; learn_count 2, so the actor of
    DDPG / TD3 steps and TD3's targets move), from the same weights and
    fresh Adam states: loss rtol 1e-5, per-sample errors atol 1e-5, every
    weight of every network and target atol 1e-5. TD3's smoothing normals
    are the JAX key's; Rainbow runs at noise_std 0 (its noise scales, whose
    gradient is the noise, left out)."""
    rng = np.random.default_rng(3)
    B = 16
    if kind in ("ddpg", "td3"):
        jenv, env = JPendulum(), Pendulum()
        ja = JActor(jenv.observation_space, jenv.action_space, key=jax.random.PRNGKey(0), **NET)
        jc = JCQ(jenv.observation_space, jenv.action_space, key=jax.random.PRNGKey(1), **NET)
        ta = DeterministicActor(env.observation_space, env.action_space, device="cpu", **NET)
        tc = ContinuousQNetwork(env.observation_space, env.action_space, device="cpu", **NET)
        assert dataclasses.asdict(ta.config) == dataclasses.asdict(ja.config)
        assert dataclasses.asdict(tc.config) == dataclasses.asdict(jc.config)
        jcls, tcls = (JO.EvoTD3, EvoTD3) if kind == "td3" else (JO.EvoDDPG, EvoDDPG)
        common = dict(num_envs=N, batch_size=B, gamma=0.9, tau=0.1, policy_freq=2)
        jevo = jcls(jenv, ja.config, jc.config, tx_actor=optax.adam(1e-2),
                    tx_critic=optax.adam(1e-2), **common)
        tevo = tcls(env, ta.config, tc.config, tx_actor=adam(1e-2), tx_critic=adam(1e-2),
                    device="cpu", **common)
        jl = jevo._init_learner(jax.random.PRNGKey(2))
        nets = {f: _stacked(getattr(jl, f)) for f in jl._fields if not f.endswith("_opt")}
        opts = {f: (tevo.tx_actor if f == "actor_opt" else tevo.tx_critic).init(nets[f[:-4]])
                for f in jl._fields if f.endswith("_opt")}
        tl = (O.TD3Learner if kind == "td3" else O.DDPGLearner)(**nets, **opts)
        batch = _batch(rng, B, 3, lambda n: rng.uniform(-2, 2, (n, 1)).astype(np.float32))
        n_batch, weights = None, np.ones(B, np.float32)
        key = jax.random.PRNGKey(5)
        draws = _t(jax.random.normal(key, (B, 1)))[None] if kind == "td3" else None
        skip = ()
    else:
        jenv, env = JCartPole(), CartPole()
        if kind == "rainbow":
            jq = JRQ(jenv.observation_space, jenv.action_space, num_atoms=11, v_min=-5.0,
                     v_max=5.0, noise_std=0.0, key=jax.random.PRNGKey(0), **NET)
            tq = RainbowQNetwork(env.observation_space, env.action_space, num_atoms=11,
                                 v_min=-5.0, v_max=5.0, noise_std=0.0, device="cpu", **NET)
            jevo = JO.EvoRainbow(jenv, jq.config, optax.adam(1e-2), num_envs=N, batch_size=B,
                                 gamma=0.9, tau=0.1)
            tevo = EvoRainbow(env, tq.config, adam(1e-2), num_envs=N, batch_size=B, gamma=0.9,
                              tau=0.1, device="cpu")
            skip = ("kernel_sigma", "bias_sigma")
        else:
            jq = JQ(jenv.observation_space, jenv.action_space, key=jax.random.PRNGKey(0), **NET)
            tq = QNetwork(env.observation_space, env.action_space, device="cpu", **NET)
            kw = dict(num_envs=N, batch_size=B, gamma=0.9, tau=0.1, per=True, n_step=3)
            jevo = JO.EvoDQN(jenv, jq.config, optax.adam(1e-2), double=True, **kw)
            tevo = EvoDQN(env, tq.config, adam(1e-2), double=True, device="cpu", **kw)
            skip = ()
        assert dataclasses.asdict(tq.config) == dataclasses.asdict(jq.config)
        jl = jevo._init_learner(jax.random.PRNGKey(2))
        params = _stacked(jl.params)
        tl = O.DQNLearner(params, _stacked(jl.target), tevo.tx.init(params))
        batch = _batch(rng, B, 4, lambda n: rng.integers(0, 2, n).astype(np.int32))
        n_batch = {"reward": rng.normal(size=B).astype(np.float32),
                   "next_obs": rng.normal(size=(B, 4)).astype(np.float32),
                   "done": (rng.random(B) < 0.3).astype(np.float32),
                   "steps": rng.integers(1, 4, B).astype(np.float32)}
        weights = rng.uniform(0.2, 1.0, B).astype(np.float32)
        key = jax.random.PRNGKey(5)
        draws = torch.zeros(1, 6, tevo.noise_count) if kind == "rainbow" else None
    jnb = None if n_batch is None else {k: jnp.asarray(v) for k, v in n_batch.items()}
    jl2, jloss, jtd = jevo._learn(jl, {k: jnp.asarray(v) for k, v in batch.items()}, jnb,
                                  jnp.asarray(weights), key, jnp.int32(2))
    tl2, tloss, ttd = tevo._learn(tl, _port(batch), _port(n_batch), _t(weights)[None], draws, 2)
    np.testing.assert_allclose(float(tloss[0]), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(ttd[0].numpy(), np.asarray(jtd), atol=1e-5, rtol=0)
    for f in jl2._fields:
        if not f.endswith("opt") and f != "opt_state":
            _assert_tree(getattr(tl2, f), getattr(jl2, f), skip=skip)


# --------------------------------------------------------------------------- #
# the program: a member alone, the per-agent path, evolution, ScanRun
# --------------------------------------------------------------------------- #


def _dqn_engine(**kw):
    env = CartPole()
    q = QNetwork(env.observation_space, env.action_space, device="cpu", **NET)
    args = dict(num_envs=N, steps_per_iter=30, buffer_size=128, batch_size=16, gamma=0.99,
                tau=0.01, device="cpu")
    args.update(kw)
    return EvoDQN(env, q.config, **args)


def _ddpg_engine(cls=EvoDDPG, **kw):
    env = Pendulum()
    a = DeterministicActor(env.observation_space, env.action_space, device="cpu", **NET)
    c = ContinuousQNetwork(env.observation_space, env.action_space, device="cpu", **NET)
    args = dict(num_envs=N, steps_per_iter=30, buffer_size=128, batch_size=16, gamma=0.99,
                tau=0.01, policy_freq=2, device="cpu")
    args.update(kw)
    return cls(env, a.config, c.config, **args)


def _member(tree, p, dim=0):
    return tree_map(lambda x: (x.narrow(dim, p, 1).clone() if isinstance(x, torch.Tensor)
                               else x), tree)


@pytest.mark.parametrize("kind", ["dqn_per_nstep", "ddpg"])
def test_member_alone_equals_its_batched_slice(kind):
    """Three members, one generation (30 ticks, learning from tick 4):
    member 1 run alone on its slice of the draws ends where its slice of the
    batched run ends: fitness, rings and env states exact, networks, targets
    and optimizer moments atol 1e-5 (vmapped against a population of one:
    summation order)."""
    evo = (_dqn_engine(per=True, n_step=3, double=True, target_every=5)
           if kind.startswith("dqn") else _ddpg_engine())
    pop = evo.init_population(0, 3)
    draws = evo.draw_iteration(pop, torch.Generator().manual_seed(1))
    batched, fit = evo.member_iteration(tree_map(
        lambda x: x.clone() if isinstance(x, torch.Tensor) else x, pop), draws)
    alone, fit1 = evo.member_iteration(_member(pop, 1), _member(draws, 1, dim=1))
    assert batched.learn_count == alone.learn_count > 10
    np.testing.assert_array_equal(fit1.numpy(), fit[1:2].numpy())
    for a, b in zip(tree_leaves(alone), tree_leaves(_member(batched, 1))):
        if not isinstance(a, torch.Tensor):
            assert a == b
        elif a.is_floating_point():
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["dqn", "ddpg"])
def test_scan_losses_match_per_agent_learn_from_buffer(kind):
    """The JAX cross-tier gate (tests/test_parallel/test_cross_tier.py): 30
    ticks of one member of the program against a per-agent agent that
    starts from the member's weights and Adam state, shares its transform,
    stores the transitions the member wrote into a ReplayBuffer and runs
    ``learn_from_buffer`` on the member's sample indices at each learning
    tick: every loss rtol 1e-4 (atol 1e-6), and the end weights too."""
    if kind == "dqn":
        agent = DQN(CartPole().observation_space, CartPole().action_space, batch_size=16,
                    lr=1e-3, gamma=0.99, tau=0.01, net_config=NET, seed=0, device="cpu")
        evo = _dqn_engine(tx=agent.optimizer.tx)
        pairs = (("actor", "params"), ("actor_target", "target"))
        opts = (("optimizer", "opt_state"),)
    else:
        env = Pendulum()
        agent = DDPG(env.observation_space, env.action_space, batch_size=16, lr_actor=1e-4,
                     lr_critic=1e-3, gamma=0.99, tau=0.01, policy_freq=2, O_U_noise=False,
                     net_config=NET, seed=0, device="cpu")
        evo = _ddpg_engine(tx_actor=agent.actor_optimizer.tx,
                           tx_critic=agent.critic_optimizer.tx)
        pairs = (("actor", "actor"), ("actor_target", "actor_target"), ("critic", "critic"),
                 ("critic_target", "critic_target"))
        opts = (("actor_optimizer", "actor_opt"), ("critic_optimizer", "critic_opt"))
    pop = evo.init_population(1, 1)
    first = lambda x: x[0].clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    for mine, theirs in pairs:
        getattr(agent, mine).params = tree_map(first, getattr(pop.learner, theirs))
    for mine, theirs in opts:
        getattr(agent, mine).opt_state = tree_map(first, getattr(pop.learner, theirs))
    draws = evo.draw_iteration(pop, torch.Generator().manual_seed(2))
    end, _, record = evo.member_iteration_debug(pop, draws)
    memory = ReplayBuffer(128, device="cpu")
    compared = 0
    for t, rec in enumerate(record):
        memory.add({k: rec["transition"][k][0] for k in ("obs", "action", "reward", "next_obs",
                                                         "done")}, batched=True)
        if rec["do_learn"]:
            loss = agent.learn_from_buffer(memory, draws=rec["sample"][0])
            np.testing.assert_allclose(float(loss), float(rec["loss"][0]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"tick {t}")
            compared += 1
    assert compared >= 15, "the warm-up never cleared: the gate is vacuous"
    for mine, theirs in pairs:
        for a, b in zip(tree_leaves(getattr(agent, mine).params),
                        tree_leaves(getattr(end.learner, theirs))):
            np.testing.assert_allclose(a.numpy(), b[0].numpy(), rtol=1e-4, atol=1e-6)


def test_evolve_mutates_only_the_learners_fields():
    """evolve: the winners' learners (every leaf gathered), the Gaussian
    mutation on ``_mutate_fields`` only, ep_ret zeroed, rings and env states
    left with their slots; the elite (slot 0) unmutated."""
    evo = _ddpg_engine(mutation_prob=1.0)
    pop = evo.init_population(0, 3)
    pop, fit = evo.member_iteration(pop, evo.draw_iteration(pop, torch.Generator().manual_seed(0)))
    new = evo.evolve(pop, fit, torch.Generator().manual_seed(1))
    best = int(torch.argmax(fit))
    for a, b in zip(tree_leaves(new.learner.critic), tree_leaves(pop.learner.critic)):
        assert torch.equal(a[0], b[best])
    for a, b in zip(tree_leaves(new.learner.actor), tree_leaves(pop.learner.actor)):
        assert torch.equal(a[0], b[best])
    assert not all(torch.equal(a[1:], b[1:]) for a, b in zip(tree_leaves(new.learner.actor),
                                                            tree_leaves(pop.learner.actor)))
    assert torch.equal(new.ring.storage["obs"], pop.ring.storage["obs"])
    assert torch.equal(new.obs, pop.obs) and not new.ep_ret.any()


@pytest.mark.parametrize("program", ["dqn", "rainbow", "ddpg", "td3"])
def test_scan_run_over_each_program(program, tmp_path):
    """ScanRun runs two generations of each program (population 2) with
    finite fitness, counts its env steps, and a snapshot restores the
    population bit for bit; the pod generation raises, naming slice 6."""
    if program == "dqn":
        evo = _dqn_engine(steps_per_iter=12, per=True, n_step=3, target_every=4)
    elif program == "rainbow":
        env = CartPole()
        q = RainbowQNetwork(env.observation_space, env.action_space, num_atoms=11, v_min=0.0,
                            v_max=20.0, device="cpu", **NET)
        evo = EvoRainbow(env, q.config, num_envs=N, steps_per_iter=12, buffer_size=64,
                         batch_size=16, device="cpu")
    else:
        evo = _ddpg_engine(EvoTD3 if program == "td3" else EvoDDPG, steps_per_iter=12)
    run = ScanRun(evo, pop_size=2, seed=0)
    hist = run.run(2)
    assert hist.shape == (2, 2) and np.isfinite(hist).all()
    assert evo.env_steps_per_generation == N * 12 and run.pop.tick == 24
    ckpt = run.checkpoint_dict()
    again = ScanRun(evo, pop_size=2, seed=5)
    again._restore(ckpt)
    for a, b in zip(tree_leaves(run.pop), tree_leaves(again.pop)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    with pytest.raises(NotImplementedError, match="slice 6"):
        evo.make_pod_generation()
