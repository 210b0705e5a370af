"""Parity of the port's PPO slice (networks.distributions,
components.rollout_buffer, algorithms.ppo, rollouts.on_policy,
utils.create_population, training.train_on_policy) with the JAX package's,
on the CPU in f32: distributions' log_prob / entropy / mode for the four
action spaces, masked too (atol 1e-5), sampling by distribution, GAE
(atol 1e-6), ``PPO.learn`` on carried weights and an injected buffer
(Discrete and Box, with and without target_kl), clone and population
seeds; then the slice end to end on the CPU."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.ppo import PPO as JPPO  # noqa: E402
from agilerl_tpu.components.rollout_buffer import _compute_gae as j_gae  # noqa: E402
from agilerl_tpu.networks import distributions as JD  # noqa: E402
from agilerl_tpu.utils.utils import create_population as j_create_population  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.ppo import PPO as TPPO  # noqa: E402
from agilerl_tpu_torch.components.rollout_buffer import _compute_gae as t_gae  # noqa: E402
from agilerl_tpu_torch.envs.probe import (  # noqa: E402
    FixedObsPolicyEnv,
    check_policy_on_policy_with_probe_env,
)
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.networks import distributions as TD  # noqa: E402
from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts  # noqa: E402
from agilerl_tpu_torch.training.train_on_policy import train_on_policy  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population, make_vect_envs  # noqa: E402
from agilerl_tpu_torch.envs.core import TorchEnv  # noqa: E402
from agilerl_tpu_torch.utils import tree as TT  # noqa: E402
from agilerl_tpu_torch.utils.spaces import Box, Discrete  # noqa: E402

torch.set_num_threads(1)

SPACES = {
    "discrete": gspaces.Discrete(5),
    "box": gspaces.Box(-1.0, 1.0, (3,), np.float32),
    "multidiscrete": gspaces.MultiDiscrete([3, 4]),
    "multibinary": gspaces.MultiBinary(4),
}
NET = {"latent_dim": 16, "encoder_config": {"hidden_size": (32,)},
       "head_config": {"hidden_size": (32,)}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _case(kind, rng, n=64):
    cfg = JD.dist_config_from_space(SPACES[kind])
    logits = rng.normal(size=(n, cfg.action_dim)).astype(np.float32) * 2
    extra = {"log_std": rng.normal(size=(cfg.action_dim,)).astype(np.float32) * 0.3}
    if kind == "discrete":
        action = rng.integers(0, 5, n)
        mask = rng.random((n, 5)) < 0.6
        mask[np.arange(n), action] = True
    elif kind == "multidiscrete":
        action = np.stack([rng.integers(0, 3, n), rng.integers(0, 4, n)], -1)
        mask = rng.random((n, 7)) < 0.6
        mask[np.arange(n), action[:, 0]] = True
        mask[np.arange(n), 3 + action[:, 1]] = True
    elif kind == "multibinary":
        action = rng.integers(0, 2, (n, 4))
        mask = rng.random((n, 4)) < 0.7
    else:
        action = rng.normal(size=(n, 3)).astype(np.float32)
        mask = None
    return cfg, logits, extra, action, mask


@pytest.mark.parametrize("kind", sorted(SPACES))
@pytest.mark.parametrize("masked", [False, True])
def test_distributions_match_jax(kind, masked):
    rng = np.random.default_rng(0)
    jcfg, logits, extra, action, mask = _case(kind, rng)
    tcfg = TD.dist_config_from_space(SPACES[kind])
    assert (tcfg.kind, tcfg.action_dim, tcfg.nvec) == (jcfg.kind, jcfg.action_dim, jcfg.nvec)
    mask = mask if masked else None
    t = lambda x: None if x is None else torch.from_numpy(np.asarray(x))  # noqa: E731
    textra = {"log_std": t(extra["log_std"])}
    for squash in ((False, True) if kind == "box" else (False,)):
        jc = JD.DistConfig(**{**jcfg.__dict__, "squash": squash})
        tc = TD.DistConfig(**{**tcfg.__dict__, "squash": squash})
        # squashed: actions inside +-0.9 and means inside +-2, since the
        # log(1 - a^2) terms near |a| = 1 turn the two libraries' ulp
        # differences in tanh / atanh into 1e-3
        act = 0.9 * np.tanh(action) if squash else action
        lg = np.clip(logits, -2, 2) if squash else logits
        np.testing.assert_allclose(
            TD.log_prob(tc, t(lg), t(act), textra, t(mask)).numpy(),
            np.asarray(JD.log_prob(jc, lg, act, extra, mask=mask)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            TD.entropy(tc, t(lg), textra, t(mask)).numpy(),
            np.asarray(JD.entropy(jc, lg, extra, mask=mask)), rtol=0, atol=1e-5)
        np.testing.assert_allclose(TD.mode(tc, t(lg), t(mask)).numpy(),
                                   np.asarray(JD.mode(jc, lg, mask)), rtol=0, atol=1e-6)
    want = JD.extra_params(jcfg)
    got = TD.extra_params(tcfg)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("kind", sorted(SPACES))
def test_sampling_matches_by_distribution(kind):
    """20,000 draws from one row: frequencies (or moments) within 0.02 of
    the JAX package's own draws and of the distribution; masked categories
    are never drawn."""
    rng = np.random.default_rng(1)
    jcfg, logits, extra, _, mask = _case(kind, rng, n=1)
    tcfg = TD.dist_config_from_space(SPACES[kind])
    n = 20000
    lg = np.repeat(logits, n, 0)
    mk = None if mask is None else np.repeat(mask, n, 0)
    if kind == "multibinary":
        mk = None  # a masked bernoulli draw is only pushed toward 0
    gen = torch.Generator().manual_seed(0)
    got = TD.sample(tcfg, torch.from_numpy(lg), gen, {"log_std": torch.from_numpy(extra["log_std"])},
                    None if mk is None else torch.from_numpy(mk)).numpy()
    want = np.asarray(JD.sample(jcfg, lg, jax.random.PRNGKey(0), extra, mk))
    assert got.shape == want.shape
    if kind == "box":
        np.testing.assert_allclose(got.mean(0), logits[0], atol=0.03)
        np.testing.assert_allclose(got.std(0), np.exp(extra["log_std"]), rtol=0.03)
        np.testing.assert_allclose(got.mean(0), want.mean(0), atol=0.04)
        return
    cols = [got] if got.ndim == 1 else list(got.T)
    wcols = [want] if want.ndim == 1 else list(want.T)
    for c, (g, w) in enumerate(zip(cols, wcols)):
        k = int(max(g.max(), w.max())) + 1
        fg = np.bincount(g.astype(np.int64), minlength=k) / n
        fw = np.bincount(w.astype(np.int64), minlength=k) / n
        np.testing.assert_allclose(fg, fw, atol=0.02, err_msg=f"column {c}")
    if kind == "discrete":
        assert not (~mask[0])[got].any()


def test_gae_matches_jax():
    rng = np.random.default_rng(2)
    T, N = 37, 6
    r = rng.normal(size=(T, N)).astype(np.float32)
    v = rng.normal(size=(T, N)).astype(np.float32)
    d = (rng.random((T, N)) < 0.15).astype(np.float32)
    lv = rng.normal(size=(N,)).astype(np.float32)
    ja, jr = j_gae(r, v, d, lv, np.zeros(N, np.float32), 0.97, 0.9)
    ta, tr = t_gae(*(torch.from_numpy(x) for x in (r, v, d, lv)), None, 0.97, 0.9)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)


def _ppo_pair(action, **kw):
    obs_space = gspaces.Box(-2.0, 2.0, (4,), np.float32)
    action_space = (gspaces.Discrete(3) if action == "discrete"
                    else gspaces.Box(-1.0, 1.0, (2,), np.float32))
    args = dict(net_config=NET, num_envs=4, learn_step=8, batch_size=32, seed=5, **kw)
    jagent = JPPO(obs_space, action_space, **args)
    tagent = TPPO(obs_space, action_space, device="cpu", **args)
    load_params_from_numpy(tagent, {"actor": _np(jagent.actor.params),
                                    "critic": _np(jagent.critic.params)})
    return jagent, tagent


def _fill(jagent, tagent, rng):
    """The same 8 x 4 transitions into both buffers: random obs and
    actions, behaviour log-probs and values off the current networks by a
    little noise (so ratios clip), random rewards and dones."""
    T, N = jagent.learn_step, jagent.num_envs
    for _ in range(T):
        obs = rng.uniform(-2, 2, (N, 4)).astype(np.float32)
        if isinstance(jagent.action_space, gspaces.Discrete):
            action = rng.integers(0, 3, N)
        else:
            action = rng.normal(size=(N, 2)).astype(np.float32)
        logp, _ = jagent.actor.evaluate_actions(obs, action)
        value = jagent.critic(obs)
        step = dict(obs=obs, action=action,
                    reward=rng.normal(size=N).astype(np.float32),
                    done=(rng.random(N) < 0.2).astype(np.float32),
                    value=np.asarray(value) + rng.normal(size=N).astype(np.float32) * 0.1,
                    log_prob=np.asarray(logp) + rng.normal(size=N).astype(np.float32) * 0.2)
        jagent.rollout_buffer.add(**step)
        tagent.rollout_buffer.add(**step)
    last = rng.uniform(-2, 2, (N, 4)).astype(np.float32)
    jagent._last_obs, tagent._last_obs = last, last
    jagent._last_done = np.zeros(N, np.float32)
    tagent._last_done = torch.zeros(N)


def _leaf_pairs(ttree, jtree):
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jtree)):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), node.detach().numpy(), want


@pytest.mark.parametrize("action", ["discrete", "box"])
@pytest.mark.parametrize("target_kl", [None, 0.05])
def test_learn_matches_jax(action, target_kl):
    """One epoch of one minibatch (batch_size = learn_step x num_envs, so no
    permutation matters): the loss at rtol 1e-5; Adam's first moment (0.1 x
    the clipped gradient) within 1e-5 of each leaf's largest entry; the
    weights at atol 5e-6 wherever |g| >= 1e-6 (below that Adam's first step,
    lr * g / (|g| + 1e-8), turns f32 summation order into steps of up to lr,
    so those entries are held through their gradient alone)."""
    jagent, tagent = _ppo_pair(action, update_epochs=1, target_kl=target_kl)
    _fill(jagent, tagent, np.random.default_rng(3))
    jloss, tloss = jagent.learn(), tagent.learn()
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    tmu = tagent.optimizer.opt_state[1].inner_state[0].mu
    jmu = jagent.optimizer.opt_state[1].inner_state[0].mu
    grads = {}
    for path, got, want in _leaf_pairs(tmu, jmu):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max() + 1e-12,
                                   err_msg=f"first moment {path}")
        grads[path] = np.abs(want) / 0.1
    tparams = {"actor": tagent.actor.params, "critic": tagent.critic.params}
    jparams = {"actor": jagent.actor.params, "critic": jagent.critic.params}
    for path, got, want in _leaf_pairs(tparams, jparams):
        ok = (grads[path] >= 1e-6) | (grads[path] == 0)  # 0: a dead unit, no step in either
        assert ok.mean() > 0.85, path  # the rule exempts few entries
        np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=5e-6, err_msg=path)
    assert tagent.rollout_buffer.state.t == 0


@pytest.mark.parametrize("target_kl,epochs", [(1e-9, 1), (1e9, 3)])
def test_learn_target_kl_stops_both_after_the_same_epoch(target_kl, epochs):
    """Three epochs of one minibatch: a tiny target_kl stops both after the
    first (the behaviour log-probs' noise already exceeds it), a huge one
    after none; the mean loss agrees at rtol 1e-4."""
    jagent, tagent = _ppo_pair("discrete", update_epochs=3, target_kl=target_kl)
    _fill(jagent, tagent, np.random.default_rng(4))
    np.testing.assert_allclose(tagent.learn(), jagent.learn(), rtol=1e-4)
    assert int(tagent.optimizer.opt_state[1].inner_state[0].count) == epochs
    assert int(jagent.optimizer.opt_state[1].inner_state[0].count) == epochs


def test_action_and_value_on_carried_weights():
    jagent, tagent = _ppo_pair("box")
    obs = np.random.default_rng(6).uniform(-2, 2, (5, 4)).astype(np.float32)
    jact = np.asarray(jagent.get_action(obs, training=False))
    tact = tagent.get_action(obs, training=False).numpy()
    np.testing.assert_allclose(tact, jact, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tagent.value_of(obs).numpy(), np.asarray(jagent.value_of(obs)),
                               rtol=0, atol=1e-5)
    a, logp, v, _ = tagent.get_action_and_value(obs)
    want, _ = jagent.actor.evaluate_actions(obs, a.numpy())
    np.testing.assert_allclose(logp.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    single, _, _, _ = tagent.get_action_and_value(obs[0])
    assert single.shape == (2,)


def test_clone_and_population_seeds_match_jax():
    obs_space, action_space = gspaces.Box(-1.0, 1.0, (4,), np.float32), gspaces.Discrete(2)
    hp = {"POP_SIZE": 3, "BATCH_SIZE": 32, "LEARN_STEP": 16, "GAMMA": 0.9, "TAU": 0.1}
    jpop = j_create_population("PPO", obs_space, action_space, NET, hp, num_envs=2, seed=3)
    tpop = create_population("PPO", obs_space, action_space, NET, hp, num_envs=2, seed=3,
                             device="cpu")
    assert [a.rng.random() for a in tpop] == [a.rng.random() for a in jpop]
    for j, t in zip(jpop, tpop):
        assert (t.batch_size, t.learn_step, t.gamma, t.num_envs, t.index) == \
               (j.batch_size, j.learn_step, j.gamma, j.num_envs, j.index)
    agent = tpop[1]
    agent.fitness = [1.0, 2.0]
    agent.actor.apply_mutation("head.add_node", rng=np.random.default_rng(0))
    agent.reinit_optimizers()
    clone = agent.clone(index=9)
    assert clone.index == 9 and clone.fitness == [1.0, 2.0] and clone.dev == agent.dev
    assert clone.actor.config == agent.actor.config
    for (_, a), (_, b) in zip(*(sorted(_flat_t(x.actor.params).items()) for x in (clone, agent))):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    assert clone.rollout_buffer.capacity == agent.learn_step


def _flat_t(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat_t(v, f"{prefix}/{k}") if isinstance(v, dict) else {f"{prefix}/{k}": v})
    return out


def test_slice_end_to_end_on_the_cpu():
    """create_population + make_vect_envs + train_on_policy through two
    generations with every mutation class possible, then the FixedObsPolicy
    probe solved by a fresh agent."""
    env = make_vect_envs("CartPole-v1", 4, device="cpu")
    pop = create_population("PPO", env.single_observation_space, env.single_action_space,
                            NET, {"POP_SIZE": 3, "BATCH_SIZE": 32, "LEARN_STEP": 16},
                            num_envs=4, device="cpu", seed=1)
    mut = Mutations(0.2, 0.3, parameters=0.3, activation=0.0, rl_hp=0.2, rand_seed=2)
    pop, fits = train_on_policy(env, "CartPole-v1", "PPO", pop, max_steps=128, evo_steps=64,
                                eval_steps=30, tournament=TournamentSelection(
                                    2, True, 3, 1, rng=np.random.default_rng(0)),
                                mutation=mut, verbose=False)
    assert len(fits) == 3 and all(len(f) == 2 and np.isfinite(f).all() for f in fits)
    assert all(a.steps[-1] == 128 for a in pop)
    for agent in pop:
        collect_rollouts(agent, env)
        assert np.isfinite(agent.learn())
    probe = FixedObsPolicyEnv()
    check_policy_on_policy_with_probe_env(
        probe, TPPO, dict(observation_space=probe.observation_space,
                          action_space=probe.action_space, num_envs=8, learn_step=16,
                          batch_size=64, update_epochs=4, lr=3e-3, gamma=0.5, ent_coef=0.05,
                          seed=3, net_config={"latent_dim": 16,
                                              "encoder_config": {"hidden_size": (32,)}},
                          device="cpu"),
        train_iters=80, solved_reward=0.9)


class _MaskedCartPole:
    """A device CartPole vec env whose step infos (not its reset info)
    publish an action mask forbidding action 1 on the first env."""

    def __init__(self):
        from agilerl_tpu_torch.envs.classic import CartPole
        from agilerl_tpu_torch.envs.core import TorchVecEnv

        self.inner = TorchVecEnv(CartPole(), 4, device="cpu")
        self.device = self.inner.device
        self.num_envs = 4
        self.single_observation_space = self.inner.single_observation_space
        self.single_action_space = self.inner.single_action_space
        self.actions = []

    def reset(self, seed=None, options=None):
        return self.inner.reset(seed)

    def step(self, actions):
        self.actions.append(actions.clone())
        obs, r, term, trunc, info = self.inner.step(actions)
        mask = torch.ones(4, 2)
        mask[0, 1] = 0
        return obs, r, term, trunc, dict(info, action_mask=mask)


def test_collect_latches_an_action_mask_from_step_infos():
    """The JAX package's latch (rollouts/on_policy.py:39-48): the first step
    info with a mask turns masking on; the buffer's earlier rows backfill
    with ones; masked actions are never taken afterwards; learn scores the
    masked distribution."""
    env = _MaskedCartPole()
    agent = TPPO(env.single_observation_space, env.single_action_space, num_envs=4,
                 learn_step=12, batch_size=48, net_config=NET, seed=0, device="cpu")
    collect_rollouts(agent, env)
    assert agent._masked_env and agent._mask_shape == (2,)
    masks = agent.rollout_buffer.state.data["action_mask"]
    assert masks.shape == (12, 4, 2)
    assert (masks[0] == 1).all() and (masks[1:, 0, 1] == 0).all()
    assert all(int(a[0]) == 0 for a in env.actions[1:])
    flat = agent.rollout_buffer.get_all_flat()
    assert flat["obs"].shape == (48, 4) and flat["action_mask"].shape == (48, 2)
    assert np.isfinite(agent.learn())


def test_train_on_policy_refuses_unported_hooks(tmp_path):
    """wb= runs (wandb does not import here: the loop logs to its sink only,
    as the JAX loop does); resilience= runs (a cadence snapshot);
    checkpoint=, resume and save_elite are ported (Queue 1's item 2) and
    run."""
    env = make_vect_envs("CartPole-v1", 2, device="cpu")
    pop = create_population("PPO", env.single_observation_space, env.single_action_space,
                            NET, {"POP_SIZE": 2, "LEARN_STEP": 8, "BATCH_SIZE": 16},
                            num_envs=2, device="cpu", seed=0)
    from agilerl_tpu_torch.resilience import Resilience

    for hook in (dict(resilience=Resilience(tmp_path / "snap", save_every=1,
                                            handle_signals=False)), dict(wb=True)):
        name = next(iter(hook))
        fresh = create_population("PPO", env.single_observation_space,
                                  env.single_action_space, NET,
                                  {"POP_SIZE": 2, "LEARN_STEP": 8, "BATCH_SIZE": 16},
                                  num_envs=2, device="cpu", seed=1)
        _, fits = train_on_policy(env, "CartPole-v1", "PPO", fresh, max_steps=16,
                                  evo_steps=16, eval_steps=5, verbose=False, **hook)
        assert [len(f) for f in fits] == [1, 1]
        if name == "resilience":
            assert [s.kind for s in hook[name].manager.snapshots()] == ["cadence"]
    path = tmp_path / "ppo.ckpt"
    pop, _ = train_on_policy(env, "CartPole-v1", "PPO", pop, max_steps=16, evo_steps=16,
                             eval_steps=5, checkpoint=16, checkpoint_path=str(path),
                             overwrite_checkpoints=True, save_elite=True,
                             elite_path=str(tmp_path),
                             tournament=TournamentSelection(2, True, 2, 1,
                                                            rng=np.random.default_rng(0)),
                             mutation=Mutations(1.0, 0, 0, 0, 0, 0, rand_seed=0),
                             verbose=False)
    assert (tmp_path / "PPO_elite.ckpt").exists()
    # one file per member, by its index (the tournament's clone has a new one)
    assert {f.name for f in tmp_path.glob("ppo_*.ckpt")} == {f"ppo_{a.index}.ckpt" for a in pop}
    fresh = create_population("PPO", env.single_observation_space, env.single_action_space,
                              NET, {"POP_SIZE": 2, "LEARN_STEP": 8, "BATCH_SIZE": 16},
                              num_envs=2, device="cpu", seed=9)
    fresh, _ = train_on_policy(env, "CartPole-v1", "PPO", fresh, max_steps=0, resume=True,
                               checkpoint_path=str(path), verbose=False)
    saved = {a.index: a for a in pop}
    for b in fresh:  # a member without a file keeps its fresh weights
        same = torch.equal(b.actor.params["head"]["output"]["kernel"],
                           saved[b.index].actor.params["head"]["output"]["kernel"]
                           if b.index in saved else torch.zeros(()))
        assert same == (b.index in saved)
    # recurrent PPO is ported (Queue 1's slice 5b): an LSTM encoder, no refusal
    agent = TPPO(env.single_observation_space, env.single_action_space, recurrent=True,
                 device="cpu")
    assert agent.recurrent and agent.actor.config.encoder_kind == "lstm"


def test_multi_tensor_adam_equals_the_per_leaf_formula():
    """algorithms/core/optimizer.py runs Adam, the lr scale and the update as
    torch._foreach ops and selects the global-norm clip on the device: on
    the CPU both equal the per-leaf formula with the host branch (optax's
    order of operations) bit for bit, clipped or not."""
    from agilerl_tpu_torch.algorithms.core import optimizer as O
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    def reference(params, grads, state, lr, max_norm, b1=0.9, b2=0.999, eps=1e-8):
        g_norm = O.global_norm(grads)
        if not bool(g_norm < max_norm):
            grads = tree_map(lambda t: (t / g_norm) * max_norm, grads)
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state.nu)
        count = state.count + 1
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        out = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu)
        new = tree_map(lambda p, u: p + u * (-lr), params, out)
        return new, O.AdamState(count, mu, nu)

    gen = torch.Generator().manual_seed(0)
    params = {"a": torch.randn(5, 7, generator=gen), "b": {"c": torch.randn(3, generator=gen)}}
    wrapper = O.OptimizerWrapper("adam", lr=3e-4, max_grad_norm=0.5)
    wrapper.init(params)
    ref_params, ref_state = params, O.AdamState(0, *(tree_map(torch.zeros_like, params),) * 2)
    for scale in (1e-3, 10.0, 1e-6, 3.0):  # below and above the clip
        grads = tree_map(lambda p: torch.randn(p.shape, generator=gen) * scale, params)
        params = wrapper.update(grads, params)
        ref_params, ref_state = reference(ref_params, grads, ref_state, 3e-4, 0.5)
        for got, want in zip(tree_leaves(params), tree_leaves(ref_params)):
            assert torch.equal(got, want)
    for got, want in zip(tree_leaves(wrapper.opt_state[1].inner_state[0].nu),
                         tree_leaves(ref_state.nu)):
        assert torch.equal(got, want)


class _LimitState(NamedTuple):
    t: torch.Tensor
    ends: torch.Tensor  # the env terminates on its last allowed step


class _EndsAtItsLimit(TorchEnv):
    """Episodes of 3 steps, reward 1 per step, obs [t / 3]: on even envs the
    3rd step terminates, and being the time limit it truncates too; odd
    envs are cut by the time limit alone."""

    max_episode_steps = 3
    observation_space = Box(0.0, 1.0, (1,), np.float32)
    action_space = Discrete(2)

    def reset_fn(self, n, gen):
        dev = gen.device
        state = _LimitState(torch.zeros(n, dtype=torch.int32, device=dev),
                            torch.arange(n, device=dev) % 2 == 0)
        return state, torch.zeros(n, 1, device=dev)

    def step_fn(self, state, action, gen):
        t = state.t + 1
        term = state.ends & (t >= 3)
        return (_LimitState(t, state.ends), (t.float() / 3)[:, None], torch.ones_like(t.float()),
                term, torch.zeros_like(term))


@pytest.mark.parametrize("collect", ["per_agent", "evo_ppo"])
def test_terminal_step_at_the_time_limit_gets_no_bootstrap(collect):
    """Queue 3's repair: a step that both terminates and truncates keeps its
    reward (no gamma * V(final_obs)); a step cut by the time limit alone gets
    the bootstrap; every other step keeps its reward. In the per-agent
    collect and in EvoPPO's rollout."""
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.envs.core import TorchVecEnv
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks.base import EvolvableNetwork, NetworkConfig
    from agilerl_tpu_torch.networks.base import default_encoder_config
    from agilerl_tpu_torch.parallel import EvoPPO

    env = _EndsAtItsLimit()
    final = torch.ones(1, 1)  # the obs a 3-step episode ends on
    if collect == "per_agent":
        agent = TPPO(env.observation_space, env.action_space, num_envs=4, learn_step=7,
                     net_config=NET, seed=0, device="cpu")
        collect_rollouts(agent, TorchVecEnv(env, 4, device="cpu"))
        reward = agent.rollout_buffer.state.data["reward"]  # [T, N]
        gamma, v_final = agent.gamma, float(agent.value_of(final)[0])
    else:
        kind, enc = default_encoder_config(env.observation_space, 8)
        cfgs = [NetworkConfig(kind, enc, MLPConfig(num_inputs=8, num_outputs=n,
                                                   hidden_size=(8,)), latent_dim=8)
                for n in (2, 1)]
        evo = EvoPPO(env, *cfgs, TD.dist_config_from_space(env.action_space), adam(1e-3),
                     num_envs=4, rollout_len=7, device="cpu")
        pop = evo.init_population(0, 1)
        gen = torch.Generator().manual_seed(0)
        traj = evo._rollout(pop, evo.draw_iteration(1, gen), gen)[0]
        reward = traj["reward"][:, 0]
        critic = {k: TT.tree_map(lambda x: x[0], v) for k, v in pop.critic.items()}
        gamma = evo.gamma
        v_final = float(EvolvableNetwork.apply(cfgs[1], critic, final)[0, 0])
    assert abs(v_final) > 1e-4
    ends = torch.tensor([2, 5])  # the steps on which the episodes end
    want = torch.ones(7, 4)
    want[ends[:, None], torch.tensor([1, 3])] = 1.0 + gamma * v_final  # cut, not terminated
    np.testing.assert_allclose(reward.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
