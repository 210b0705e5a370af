"""Parity of the port's population program (agilerl_tpu_torch.parallel) with
the JAX package's ``parallel/population.py`` and ``parallel/generation.py``,
on the CPU in f32: the stacked apply, the rollout with its truncation
bootstrap and fitness (both branches), GAE, one PPO update on the JAX
package's permutations, evolution on the JAX package's draws (bit-equal),
the tournament's invariants, the per-member clip against a vmapped optax
chain, population snapshots, ScanRun and a member's slice against the
member alone."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from agilerl_tpu.envs import CartPole as JCartPole  # noqa: E402
from agilerl_tpu.modules.mlp import MLPConfig as JMLPConfig  # noqa: E402
from agilerl_tpu.networks import distributions as JD  # noqa: E402
from agilerl_tpu.networks.base import EvolvableNetwork as JNet  # noqa: E402
from agilerl_tpu.networks.base import NetworkConfig as JNetworkConfig  # noqa: E402
from agilerl_tpu.networks.base import default_encoder_config as j_default_encoder  # noqa: E402
from agilerl_tpu.parallel import generation as JG  # noqa: E402
from agilerl_tpu.parallel.population import EvoPPO as JEvoPPO  # noqa: E402
from agilerl_tpu_torch.algorithms.core import optimizer as O  # noqa: E402
from agilerl_tpu_torch.envs.classic import CartPole, CartPoleState  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules.mlp import MLPConfig  # noqa: E402
from agilerl_tpu_torch.networks import distributions as D  # noqa: E402
from agilerl_tpu_torch.networks.base import EvolvableNetwork, NetworkConfig  # noqa: E402
from agilerl_tpu_torch.parallel import (  # noqa: E402
    DeviceReplayRing,
    EvoDQN,
    EvoPPO,
    MemberState,
    ScanOffPolicy,
    ScanRun,
    apply_evolution,
    make_pod_generation,
    population_load_state_dict,
    population_state_dict,
    tournament_select,
)
from agilerl_tpu_torch.utils.tree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

LATENT, HIDDEN = 8, 16


def _configs(pkg):
    mlp, net = (JMLPConfig, JNetworkConfig) if pkg == "jax" else (MLPConfig, NetworkConfig)
    enc = mlp(num_inputs=4, num_outputs=LATENT, hidden_size=(HIDDEN,), output_vanish=False)
    return [net(encoder_kind="mlp", encoder=enc, latent_dim=LATENT,
                head=mlp(num_inputs=LATENT, num_outputs=n, hidden_size=(HIDDEN,)))
            for n in (2, 1)]


def _pair(tx="adam", **kw):
    kw = dict(dict(num_envs=4, rollout_len=8, update_epochs=2, num_minibatches=2), **kw)
    ja, jc = _configs("jax")
    ta, tc = _configs("torch")
    assert dataclasses.asdict(ja) == dataclasses.asdict(ta)
    # the JAX package's own default encoder for CartPole has these configs
    assert j_default_encoder(JCartPole().observation_space, LATENT,
                             encoder_config={"hidden_size": (HIDDEN,)})[1] == ja.encoder
    jtx, ttx = ((optax.adam(1e-2), O.adam(1e-2)) if tx == "adam" else
                (optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2)),
                 O.chain(O.clip_by_member_global_norm(0.5), O.adam(1e-2))))
    jevo = JEvoPPO(JCartPole(), ja, jc, JD.dist_config_from_space(JCartPole().action_space), jtx,
                   **kw)
    tevo = EvoPPO(CartPole(), ta, tc, D.dist_config_from_space(CartPole().action_space), ttx,
                  device="cpu", **kw)
    return jevo, tevo


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init(jevo, seed, P):
    """The JAX package's population, its init under one jit (bit-equal to
    the eager vmap, and much quicker to compile)."""
    return jax.jit(jevo.init_population, static_argnums=1)(jax.random.PRNGKey(seed), P)


def _t(tree):
    return f32_tree_from_numpy(_np(tree), "cpu")


def _leaf_pairs(ttree, jtree):
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jtree)):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), node.detach().numpy(), want


def _port_state(jevo, tevo, jpop):
    """The JAX population (its leaves stacked [P, ...]) as the port's."""
    es = jpop.env_state.env_state
    actor, critic = _t(jpop.actor), _t(jpop.critic)
    return MemberState(actor, critic, tevo.tx.init({"actor": actor, "critic": critic}),
                       CartPoleState(*(torch.from_numpy(np.array(x)) for x in es)),
                       torch.from_numpy(np.array(jpop.env_state.step_count)),
                       torch.from_numpy(np.array(jpop.obs)),
                       torch.from_numpy(np.array(jpop.ep_ret)))


def test_stacked_apply_matches_jax_per_member():
    jevo, tevo = _pair()
    jpop = _init(jevo, 0, 3)
    obs = np.random.default_rng(0).normal(size=(3, 5, 4)).astype(np.float32)
    for cfg_j, cfg_t, params in ((jevo.actor_config, tevo.actor_config, jpop.actor),
                                 (jevo.critic_config, tevo.critic_config, jpop.critic)):
        want = np.asarray(jax.jit(jax.vmap(lambda p, o: JNet.apply(cfg_j, p, o)))(params, obs))
        got = torch.func.vmap(lambda p, o: EvolvableNetwork.apply(cfg_t, p, o))(
            _t(params), torch.from_numpy(obs)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _jax_resets(env, key, T, N):
    """The resets the JAX vector step draws at each of T steps (its key
    splits replayed): leaves [T, N, ...]."""
    states, obs = [], []
    for _ in range(T):
        key, sub = jax.random.split(key)
        ks = jax.vmap(jax.random.split)(jax.random.split(sub, N))
        s, o = jax.vmap(env.reset_fn)(ks[:, 1])
        states.append(s)
        obs.append(o)
    return (jax.tree_util.tree_map(lambda *x: np.stack(x), *states), np.stack(obs))


@pytest.mark.parametrize("T,finishes", [(6, False), (40, True)])
def test_rollout_and_fitness_match_jax(T, finishes):
    """The port's rollout on draws that replay the JAX package's (its
    actions forced through the Gumbel uniforms, its resets injected) gives
    its trajectory, ep_ret and fitness: without a finished episode the
    fallback mean(reward) * max_episode_steps, with them the mean return."""
    jevo, tevo = _pair(rollout_len=T)
    jpop = _init(jevo, 1, 1)
    jm = jax.tree_util.tree_map(lambda x: x[0], jpop)
    jtraj, _, _, jep, jfit, _ = jax.jit(jevo._rollout)(jm)
    N = jevo.num_envs
    actions = np.asarray(jtraj["action"])
    u = np.where(np.eye(2, dtype=bool)[actions], np.float32(1 - 1e-7), np.float32(1e-30))
    rs, ro = _jax_resets(jevo.env, jm.env_state.key, T, N)
    draws = {"action": torch.from_numpy(u.astype(np.float32))[:, None],
             "reset": (CartPoleState(*(torch.from_numpy(x)[:, None] for x in rs)),
                       torch.from_numpy(ro)[:, None])}
    state = _port_state(jevo, tevo, jpop)
    steps = []  # (terminated & truncated, V(final_obs)) of each step, seen by the port
    vec_step = tevo._vec_step

    def recording_step(*args, **kw):
        out = vec_step(*args, **kw)
        both = torch.logical_and(out[3], out[4])
        steps.append((both, tevo._value(jax.tree_util.tree_map(lambda x: x[0], state.critic),
                                        out[5])))
        return out

    tevo._vec_step = recording_step
    traj, _, _, _, ep_ret, fitness = tevo._rollout(state, draws)
    assert bool(np.asarray(jtraj["done"]).any()) == finishes
    np.testing.assert_array_equal(traj["action"][:, 0].numpy(), actions)
    np.testing.assert_array_equal(traj["done"][:, 0].numpy(), np.asarray(jtraj["done"]))
    # the JAX package bootstraps every truncated step; the port not one that
    # also terminates (Queue 3's repair): its reward is the JAX one minus
    # gamma * V(final_obs) there, and the JAX one everywhere else
    both = torch.stack([b for b, _ in steps]).numpy()
    v_final = torch.stack([v for _, v in steps]).numpy()
    want = dict(jtraj, reward=np.asarray(jtraj["reward"]) - tevo.gamma * v_final * both)
    for k in ("obs", "logp", "value", "reward"):
        np.testing.assert_allclose(traj[k][:, 0].numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(ep_ret[0].numpy(), np.asarray(jep), rtol=1e-6)
    np.testing.assert_allclose(fitness[0].item(), float(jfit), rtol=1e-5)
    if not finishes:
        np.testing.assert_allclose(
            fitness[0].item(), float(np.mean(want["reward"])) * 500, rtol=1e-5)


def _random_traj(rng, P, T, N):
    return {"obs": rng.normal(size=(P, T, N, 4)).astype(np.float32),
            "action": rng.integers(0, 2, (P, T, N)),
            "logp": (np.log(0.5) + 0.2 * rng.normal(size=(P, T, N))).astype(np.float32),
            "value": rng.normal(size=(P, T, N)).astype(np.float32),
            "reward": rng.normal(size=(P, T, N)).astype(np.float32),
            "done": (rng.random((P, T, N)) < 0.2).astype(np.float32)}


def _time_major(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))


def test_gae_matches_jax():
    jevo, tevo = _pair()
    rng = np.random.default_rng(2)
    traj = _random_traj(rng, 2, 8, 4)
    last = rng.normal(size=(2, 4)).astype(np.float32)
    jadv, jret = jax.jit(jax.vmap(jevo._gae))(traj, last)
    adv, ret = tevo._gae({k: _time_major(v) for k, v in traj.items()}, torch.from_numpy(last))
    np.testing.assert_allclose(adv.numpy(), np.swapaxes(np.asarray(jadv), 0, 1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ret.numpy(), np.swapaxes(np.asarray(jret), 0, 1), rtol=0, atol=1e-6)


def _jax_perms(jevo, keys, total):
    """The permutations the JAX update draws from each member's key."""
    mb = total // jevo.num_minibatches
    out = []
    for k in keys:
        ks = jax.random.split(k, jevo.update_epochs)
        out.append([np.asarray(jax.random.permutation(e, total))[: mb * jevo.num_minibatches]
                    for e in ks])
    return torch.from_numpy(np.swapaxes(np.asarray(out), 0, 1).astype(np.int64))


@pytest.mark.parametrize("tx", ["adam", "clip_adam"])
def test_ppo_update_matches_jax(tx):
    """Two epochs of two minibatches on each of two members, the rows in the
    JAX package's permutations: the loss, weights and Adam moments at rtol
    1e-5, atol 1e-6 (ddof-0 advantage normalisation; per-member clip). No
    weight here needs the small-gradient rule of ROADMAP Queue 3's AdamW
    note: every entry holds at these tolerances."""
    jevo, tevo = _pair(tx=tx)
    jpop = _init(jevo, 3, 2)
    rng = np.random.default_rng(4)
    traj = _random_traj(rng, 2, 8, 4)
    adv = rng.normal(size=(2, 8, 4)).astype(np.float32)
    ret = rng.normal(size=(2, 8, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    ja, jc, jopt, jloss = jax.jit(jax.vmap(jevo._ppo_update))(
        jpop.actor, jpop.critic, jpop.opt_state, traj, adv, ret, keys)
    actor, critic = _t(jpop.actor), _t(jpop.critic)
    opt = tevo.tx.init({"actor": actor, "critic": critic})
    ta, tcr, topt, tloss = tevo._ppo_update(
        actor, critic, opt, {k: _time_major(v) for k, v in traj.items()}, _time_major(adv),
        _time_major(ret), _jax_perms(jevo, keys, 32))
    np.testing.assert_allclose(tloss.numpy(), np.asarray(jloss), rtol=1e-5)
    jadam = jopt[-1][0] if tx == "clip_adam" else jopt[0]
    tadam = topt[-1][0] if tx == "clip_adam" else topt[0]
    assert tadam.count == 4 and (np.asarray(jadam.count) == 4).all()
    for path, got, want in _leaf_pairs(tadam.mu, jadam.mu):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"mu {path}")
    for path, got, want in _leaf_pairs(tadam.nu, jadam.nu):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=f"nu {path}")
    for path, got, want in _leaf_pairs({"actor": ta, "critic": tcr}, {"actor": ja, "critic": jc}):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=path)


def test_member_clip_matches_vmapped_optax_chain():
    """One norm per member, over every dimension but the first; the plain
    clip on the stacked tree would take one for the whole population."""
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(size=(3, 4, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(3, 7)).astype(np.float32)}}
    scale = np.array([0.01, 1, 5], np.float32)  # member 0's norm is below 0.5
    grads = {"a": rng.normal(size=(3, 4, 5)).astype(np.float32) * scale[:, None, None],
             "b": {"c": rng.normal(size=(3, 7)).astype(np.float32) * scale[:, None]}}
    jtx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-3))
    ttx = O.chain(O.clip_by_member_global_norm(0.5), O.adam(1e-3))
    jstate = jax.vmap(jtx.init)(params)
    tstate = ttx.init(_t(params))
    for _ in range(2):
        jup, jstate = jax.jit(jax.vmap(jtx.update))(grads, jstate, params)
        tup, tstate = ttx.update(_t(grads), tstate, _t(params))
        for path, got, want in _leaf_pairs(tup, jup):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9, err_msg=path)
    whole, _ = O.clip_by_global_norm(0.5).update(_t(grads), (), None)
    member, _ = O.clip_by_member_global_norm(0.5).update(_t(grads), (), None)
    assert not torch.allclose(whole["a"][0], member["a"][0])
    torch.testing.assert_close(member["a"][0], _t(grads)["a"][0])  # norm below 0.5: unclipped


def test_apply_evolution_bit_equal_to_jax_on_its_draws():
    """The JAX package's winners, do_mut and per-member, per-leaf noise fed to
    apply_evolution give its evolve_actor_critic bit for bit: actor, critic
    and every optimizer-state leaf gathered, the actor alone mutated."""
    jevo, tevo = _pair()
    jpop = _init(jevo, 7, 4)
    rng = np.random.default_rng(7)
    moments = [jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32), m)
               for m in (jpop.opt_state[0].mu, jpop.opt_state[0].nu)]
    jpop = jpop._replace(opt_state=(jpop.opt_state[0]._replace(
        count=jnp.full(4, 4, jnp.int32), mu=moments[0], nu=moments[1]),) + jpop.opt_state[1:])
    fitness = jnp.array([3.0, 9.0, 1.0, 4.0])
    key = jax.random.PRNGKey(8)
    kw = dict(tournament_size=2, elitism=True, mutation_prob=0.5, mutation_sd=0.1)
    ja, jc, jopt = JG.evolve_actor_critic((jpop.actor, jpop.critic, jpop.opt_state), fitness,
                                          key, **kw)
    winners, do_mut, mkeys = JG.tournament_select(fitness, key, 2, True, 0.5)

    @jax.jit
    @jax.vmap
    def member_noise(actor, k):  # gaussian_mutate's draws: one key per leaf
        leaves, treedef = jax.tree_util.tree_flatten(actor)
        ks = jax.random.split(k, len(leaves))
        return jax.tree_util.tree_unflatten(
            treedef, [jax.random.normal(kk, leaf.shape) for leaf, kk in zip(leaves, ks)])

    noise = member_noise(jpop.actor, mkeys)
    actor, critic = _t(jpop.actor), _t(jpop.critic)
    adam = O.AdamState(4, {"actor": actor, "critic": critic}, {"actor": actor, "critic": critic})
    adam = adam._replace(mu=_t(jpop.opt_state[0].mu), nu=_t(jpop.opt_state[0].nu))
    ta, tcr, topt = apply_evolution(
        (actor, critic, (adam, ())), torch.from_numpy(np.array(winners)),
        torch.from_numpy(np.array(do_mut)), _t(noise), 0.1)
    for tree_t, tree_j in ((ta, ja), (tcr, jc), (topt[0].mu, jopt[0].mu), (topt[0].nu, jopt[0].nu)):
        for path, got, want in _leaf_pairs(tree_t, tree_j):
            np.testing.assert_array_equal(got, want, err_msg=path)
    assert topt[0].count == 4 and np.asarray(jopt[0].count).tolist() == [4] * 4
    assert int(winners[0]) == 1 and float(do_mut[0]) == 0.0


def test_tournament_select_invariants():
    fitness = torch.tensor([2.0, 7.0, 1.0, 5.0, 3.0, 0.5])
    runs = [tournament_select(fitness, torch.Generator().manual_seed(s), 3, True, 0.5)
            for s in (0, 0, 1)]
    (w0, d0), (w1, d1), _ = runs
    assert torch.equal(w0, w1) and torch.equal(d0, d1)  # one seed, one outcome
    gen = torch.Generator().manual_seed(0)
    entrants = torch.randint(0, 6, (6, 3), generator=gen)
    for w, d in runs:
        assert int(w[0]) == 1 and float(d[0]) == 0.0  # the elite, never mutated
    want = entrants[torch.arange(6), fitness[entrants].argmax(dim=1)]
    assert torch.equal(w0[1:], want[1:])
    assert set(d0.tolist()) <= {0.0, 1.0} and w0.dtype == torch.int64
    w, d = tournament_select(fitness, torch.Generator().manual_seed(2), 2, False, 1.0)
    assert d.tolist() == [1.0] * 6  # without elitism every slot mutates at prob 1


def test_population_state_dict_round_trip_and_rejections():
    _, tevo = _pair()
    pop = tevo.member_iteration(*_iteration_inputs(tevo, 2, 0))[0]
    blob = population_state_dict(pop)
    assert all(isinstance(x, np.ndarray) for x in blob["leaves"])
    fresh = tevo.init_population(99, 2)
    restored = population_load_state_dict(fresh, blob)
    for a, b in zip(tree_leaves(pop), tree_leaves(restored)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)
        else:
            assert a == b and type(a) is type(b)
    with pytest.raises(ValueError, match="shape"):
        population_load_state_dict(tevo.init_population(0, 3), blob)
    with pytest.raises(ValueError, match="leaves"):
        population_load_state_dict(fresh, {"leaves": blob["leaves"][:-1]})


def _iteration_inputs(tevo, P, seed):
    gen = torch.Generator().manual_seed(seed)
    return tevo.init_population(seed, P), tevo.draw_iteration(P, gen)


def test_member_slice_equals_the_member_alone():
    """A member's slice of the batched iteration equals its iteration run
    alone (a population of one) on the same draws."""
    _, tevo = _pair()
    pop, draws = _iteration_inputs(tevo, 3, 1)
    out, fit = tevo.member_iteration(pop, draws)
    for p in (0, 2):
        def one(x, _p=p):
            return x[_p:_p + 1] if isinstance(x, torch.Tensor) else x
        from agilerl_tpu_torch.utils.tree import tree_map

        alone = tree_map(one, pop)
        d = {"action": draws["action"][:, p:p + 1],
             "reset": tree_map(lambda x, _p=p: x[:, _p:_p + 1], draws["reset"]),
             "perm": draws["perm"][:, p:p + 1]}
        out1, fit1 = tevo.member_iteration(alone, d)
        torch.testing.assert_close(fit1[0], fit[p], rtol=0, atol=1e-5)
        for a, b in zip(tree_leaves(out1), tree_leaves(tree_map(one, out))):
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=1e-5)


def test_scan_run_timeline_history_and_bit_exact_resume():
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry

    _, tevo = _pair()
    reg = MetricsRegistry()
    run = ScanRun(tevo, pop_size=2, seed=0,
                  telemetry=RunTelemetry(registry=reg, lineage=False, name="anakin"))
    hist = run.run(2)
    assert hist.shape == (2, 2) and np.isfinite(hist).all()
    assert run.generation == 2 and run.fitness_history == hist.tolist()
    assert reg.gauge("anakin/env_steps_per_sec").value > 0
    ckpt, rng = run.checkpoint_dict(), run.rng_state()
    assert rng["key"].dtype == np.uint8
    expected = run.run(2)
    run2 = ScanRun(tevo, pop_size=2, seed=1234)
    run2._restore(ckpt)
    run2.set_rng_state(rng)
    assert run2.generation == 2 and run2.fitness_history == run.fitness_history[:2]
    np.testing.assert_array_equal(run2.run(2), expected)
    for a, b in zip(tree_leaves(run.pop), tree_leaves(run2.pop)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    with pytest.raises(ValueError, match="pop_size"):
        ScanRun(tevo, pop_size=4, seed=0)._restore(ckpt)


def test_two_generation_pop4_smoke_and_unported_tiers_raise():
    _, tevo = _pair(num_envs=8, rollout_len=16, update_epochs=1)
    run = ScanRun(tevo, pop_size=4, seed=3)
    hist = run.run(2)
    assert hist.shape == (2, 4) and np.isfinite(hist).all() and (hist > 0).all()
    assert tevo.env_steps_per_generation == 128
    # the pod tier: without a mesh or a plan it raises; on a one-rank
    # population axis it is the vmapped generation, bit for bit
    from agilerl_tpu_torch.parallel.plan import make_population_plan
    from tests.torch_dist_harness import single_rank

    with pytest.raises(ValueError, match="needs a mesh or a plan"):
        make_pod_generation(None, None, None, None, None, None)
    with pytest.raises(ValueError, match="needs a mesh or a plan"):
        tevo.make_pod_generation()
    with single_rank():
        mesh = make_population_plan(1).build_mesh("cpu")
        pod = ScanRun(tevo, pop_size=4, seed=3, mesh=mesh)
        np.testing.assert_array_equal(pod.run(2), hist)
        for a, b in zip(tree_leaves(pod.pop), tree_leaves(run.pop)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        assert callable(ScanOffPolicy(CartPole(), None, device="cpu").make_pod_generation(mesh))
    assert isinstance(ScanRun(EvoDQN(CartPole(), _configs("torch")[0], num_envs=2,
                                     steps_per_iter=2, buffer_size=8, device="cpu"),
                              pop_size=2).pop.ring, DeviceReplayRing)
