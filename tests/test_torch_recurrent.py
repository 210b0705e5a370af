"""Parity of the port's recurrent PPO (agilerl_tpu_torch.algorithms.ppo with
``recurrent=True``, ``RolloutBuffer.get_sequences``, the recurrent branch of
``collect_rollouts``, ``envs/probe.py:MemoryEnv``) with the JAX package's,
on the CPU in f32: the BPTT sequences, MemoryEnv's steps, one BPTT
minibatch step on identical sequences, acting with a hidden state, and a
collect + learn that survives an architecture mutation."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms.ppo import PPO as JPPO  # noqa: E402
from agilerl_tpu.components.rollout_buffer import RolloutBuffer as JBuffer  # noqa: E402
from agilerl_tpu.envs.probe import MemoryEnv as JMemoryEnv  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.ppo import PPO as TPPO  # noqa: E402
from agilerl_tpu_torch.components.rollout_buffer import RolloutBuffer as TBuffer  # noqa: E402
from agilerl_tpu_torch.envs.core import TorchVecEnv  # noqa: E402
from agilerl_tpu_torch.envs.probe import MemoryEnv, _ScalarState  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy  # noqa: E402
from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts  # noqa: E402

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": 12, "num_layers": 2}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _steps(rng, T, N, L=2, H=12):
    for _ in range(T):
        yield dict(obs=rng.normal(size=(N, 2)).astype(np.float32),
                   action=rng.integers(0, 2, N),
                   reward=rng.normal(size=N).astype(np.float32),
                   done=(rng.random(N) < 0.3).astype(np.float32),
                   value=rng.normal(size=N).astype(np.float32),
                   log_prob=(np.log(0.5) + 0.1 * rng.normal(size=N)).astype(np.float32),
                   hidden_state={net: {k: rng.normal(size=(L, N, H)).astype(np.float32)
                                       for k in ("h", "c")} for net in ("actor", "critic")})


def _filled(T=12, N=3, seed=0):
    jb = JBuffer(capacity=T, num_envs=N, recurrent=True)
    tb = TBuffer(capacity=T, num_envs=N, device="cpu")
    for step in _steps(np.random.default_rng(seed), T, N):
        jb.add(**step)
        tb.add(**step)
    last = np.random.default_rng(seed + 1).normal(size=N).astype(np.float32)
    jb.compute_returns_and_advantages(last, np.zeros(N, np.float32))
    tb.compute_returns_and_advantages(torch.from_numpy(last))
    return jb, tb


def test_get_sequences_match_jax():
    """Chunk-major then env, time-major inside a sequence; the hidden state
    at each sequence's first step."""
    jb, tb = _filled()
    jseq, tseq = _np(jb.get_sequences(4)), tb.get_sequences(4)
    assert jseq.keys() == tseq.keys()
    for path, want in jax.tree_util.tree_leaves_with_path(jseq):
        node = tseq
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == want.shape, path
        np.testing.assert_allclose(node.numpy(), want, rtol=0, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    assert tseq["obs"].shape == (9, 4, 2) and tseq["hidden_state"]["actor"]["h"].shape == (9, 2, 12)
    # a capacity that seq_len does not divide (a learn_step mutation): whole chunks only
    assert tb.get_sequences(5)["obs"].shape == (6, 5, 2)


def test_memory_env_steps_match_jax():
    jenv, tenv = JMemoryEnv(), MemoryEnv()
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    jstate, jobs = jax.vmap(jenv.reset_fn)(keys)
    state = _ScalarState(torch.from_numpy(np.array(jstate.obs)),
                         torch.from_numpy(np.array(jstate.t)))
    rng = np.random.default_rng(1)
    for _ in range(3):
        action = rng.integers(0, 2, 16)
        jstate, jobs, jrew, jterm, jtrunc = jax.vmap(jenv.step_fn)(
            jstate, jnp.asarray(action), keys)
        state, obs, rew, term, trunc = tenv.step_fn(state, torch.from_numpy(action), None)
        np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))
        np.testing.assert_array_equal(rew.numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(term.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(trunc.numpy(), np.asarray(jtrunc))
        np.testing.assert_array_equal(state.obs.numpy(), np.asarray(jstate.obs))
    assert set(np.asarray(jrew).tolist()) <= {-1.0, 1.0} and term.all()
    _, obs = tenv.reset_fn(64, torch.Generator().manual_seed(0))
    assert set(obs[:, 0].tolist()) == {0.0, 1.0} and (obs[:, 1] == 1).all()
    assert tenv.max_episode_steps == jenv.max_episode_steps == 3


def _pair(**kw):
    args = dict(num_envs=3, learn_step=12, seq_len=4, batch_size=24, recurrent=True, seed=2,
                net_config=NET, **kw)
    env = JMemoryEnv()
    jagent = JPPO(env.observation_space, env.action_space, **args)
    tagent = TPPO(env.observation_space, env.action_space, device="cpu", **args)
    load_params_from_numpy(tagent, {"actor": _np(jagent.actor.params),
                                    "critic": _np(jagent.critic.params)})
    return jagent, tagent


def _leaf_pairs(ttree, jtree):
    for path, want in jax.tree_util.tree_leaves_with_path(_np(jtree)):
        node = ttree
        for p in path:
            node = node[p.key]
        yield jax.tree_util.keystr(path), node.detach().numpy(), want


def test_bptt_update_matches_jax():
    """One BPTT minibatch step of the JAX package's ``_update_bptt_fn`` and
    the port's on the same sequences (hidden states from the JAX buffer):
    loss, Adam's first moment and the weights at rtol 1e-5."""
    jagent, tagent = _pair()
    jb, _ = _filled(N=3)
    batch = _np(jb.get_sequences(4))
    params = {"actor": jagent.actor.params, "critic": jagent.critic.params}
    jp, jopt, jloss, _ = jagent._update_bptt_fn()(
        params, jagent.optimizer.opt_state, batch, jnp.float32(0.2), jnp.float32(0.01),
        jnp.float32(0.5))
    tparams = {"actor": tagent.actor.params, "critic": tagent.critic.params}
    tp, tloss, _ = tagent._update_bptt_fn()(tparams, f32_tree_from_numpy(batch, "cpu"))
    np.testing.assert_allclose(tloss.item(), float(jloss), rtol=1e-5)
    jmu = jopt[1].inner_state[0].mu
    tmu = tagent.optimizer.opt_state[1].inner_state[0].mu
    for path, got, want in _leaf_pairs(tmu, jmu):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7, err_msg=f"mu {path}")
    for path, got, want in _leaf_pairs(tp, jp):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=path)


def test_recurrent_acting_matches_jax_and_threads_the_hidden_state():
    jagent, tagent = _pair()
    obs = np.random.default_rng(3).normal(size=(3, 2)).astype(np.float32)
    for step in range(3):
        jv, tv = jagent.value_of(obs), tagent.value_of(torch.from_numpy(obs))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        ja = jagent.get_action(obs, training=False)
        ta = tagent.get_action(torch.from_numpy(obs), training=False)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for net in ("actor",):
            for k in ("h", "c"):
                np.testing.assert_allclose(tagent._hidden[net][k].numpy(),
                                           np.asarray(jagent._hidden[net][k]), rtol=1e-5,
                                           atol=1e-6)
    a, logp, value, hidden = tagent.get_action_and_value(torch.from_numpy(obs[0]))
    assert a.shape == () and hidden["critic"]["h"].shape == (2, 1, 12)
    init = tagent.get_initial_hidden_state()
    assert init["actor"]["h"].shape == (2, 3, 12) and not init["critic"]["c"].any()


def test_recurrent_collect_and_learn_survive_an_architecture_mutation():
    _, tagent = _pair()
    env = TorchVecEnv(MemoryEnv(), num_envs=3, seed=0, device="cpu")
    r = collect_rollouts(tagent, env)
    hs = tagent.rollout_buffer.state.data["hidden_state"]["actor"]["h"]
    assert hs.shape == (12, 2, 3, 12) and not hs[0].any()  # zeros at the start
    assert np.isfinite(r) and np.isfinite(tagent.learn())
    for net in (tagent.actor, tagent.critic):
        net.apply_mutation("encoder.add_node", rng=np.random.default_rng(0))
    tagent.reinit_optimizers()  # as the mutation engine does after an architecture mutation
    collect_rollouts(tagent, env)
    assert tagent.rollout_buffer.state.data["hidden_state"]["critic"]["c"].shape[-1] == \
        tagent.critic.config.encoder.hidden_size
    assert np.isfinite(tagent.learn())
    assert np.isfinite(tagent.test(env, loop=1))


def test_memory_env_terminal_steps_get_no_bootstrap():
    """MemoryEnv ends every episode on its last allowed step, so the
    autoreset flags that step truncated as well as terminated. The collect
    stores its reward as it is (Queue 3's repair: the JAX package adds
    gamma * V(final_obs) there): every stored reward is -1, 0 or +1."""
    _, tagent = _pair()
    env = TorchVecEnv(MemoryEnv(), num_envs=3, seed=0, device="cpu")
    collect_rollouts(tagent, env)
    reward = tagent.rollout_buffer.state.data["reward"]
    assert set(reward.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert bool((reward != 0).any())
