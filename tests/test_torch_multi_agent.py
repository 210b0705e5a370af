"""Parity of the port's multi-agent base, env, buffer and off-policy family
(agilerl_tpu_torch: ``algorithms/core/base.MultiAgentRLAlgorithm``,
``envs/multi_agent``, ``vector/pz_vec_env.sanitize_ma_transition``,
``components/multi_agent_replay_buffer``, ``modules/custom_components
.gumbel_softmax``, the multi-agent helpers of ``utils/utils``,
``algorithms/maddpg``, ``algorithms/matd3``,
``training/train_multi_agent_off_policy``, ``envs/probe_ma``) with the JAX
package's on the CPU in f32: grouping and net configs on homogeneous and
mixed spaces, SimpleSpread's step and autoreset on identical states and
actions (the stacked step on the JAX package's resets), the buffer's rows,
the Gumbel pick on the JAX uniforms, three MADDPG and MATD3 learns on
identical batches (MATD3 on and off its policy cadence, on the JAX
smoothing draws), an architecture mutation against the JAX engine, one
generation of the loop, the probes and a checkpoint round trip."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.algorithms.core.base import MultiAgentRLAlgorithm as JMABase  # noqa: E402
from agilerl_tpu.algorithms.maddpg import MADDPG as JMADDPG  # noqa: E402
from agilerl_tpu.algorithms.maddpg import gumbel_softmax as j_gumbel  # noqa: E402
from agilerl_tpu.algorithms.matd3 import MATD3 as JMATD3  # noqa: E402
from agilerl_tpu.components.multi_agent_replay_buffer import (  # noqa: E402
    MultiAgentReplayBuffer as JMABuffer,
)
from agilerl_tpu.envs.core import VecState as JVecState  # noqa: E402
from agilerl_tpu.envs.multi_agent import MAState as JMAState  # noqa: E402
from agilerl_tpu.envs.multi_agent import MultiAgentJaxVecEnv  # noqa: E402
from agilerl_tpu.envs.multi_agent import SimpleSpreadJax  # noqa: E402
from agilerl_tpu.envs.multi_agent import make_ma_autoreset_step as j_ma_step  # noqa: E402
from agilerl_tpu.hpo import Mutations as JMutations  # noqa: E402
from agilerl_tpu.hpo import TournamentSelection as JTournament  # noqa: E402
from agilerl_tpu.training.train_multi_agent_off_policy import (  # noqa: E402
    train_multi_agent_off_policy as j_train,
)
from agilerl_tpu.utils import utils as JU  # noqa: E402
from agilerl_tpu.vector.pz_vec_env import sanitize_ma_transition as j_sanitize  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import (  # noqa: E402
    MultiAgentRLAlgorithm,
    MultiAgentSetup,
    load_params_from_numpy,
)
from agilerl_tpu_torch.algorithms.maddpg import MADDPG  # noqa: E402
from agilerl_tpu_torch.algorithms.matd3 import MATD3  # noqa: E402
from agilerl_tpu_torch.components.multi_agent_replay_buffer import (  # noqa: E402
    MultiAgentReplayBuffer,
)
from agilerl_tpu_torch.envs import probe_ma as PM  # noqa: E402
from agilerl_tpu_torch.envs.core import VecState  # noqa: E402
from agilerl_tpu_torch.envs.multi_agent import (  # noqa: E402
    MAState,
    MultiAgentTorchVecEnv,
    SimpleSpreadTorch,
    make_ma_autoreset_step,
)
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.modules.custom_components import GumbelSoftmax  # noqa: E402
from agilerl_tpu_torch.training.train_multi_agent_off_policy import (  # noqa: E402
    train_multi_agent_off_policy,
)
from agilerl_tpu_torch.utils import utils as TU  # noqa: E402
from agilerl_tpu_torch.vector import sanitize_ma_transition  # noqa: E402

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
IDS = ["agent_0", "agent_1"]
B = 16


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


def _spaces(continuous):
    obs = {a: gspaces.Box(-np.inf, np.inf, (6,), np.float32) for a in IDS}
    act = ({a: gspaces.Box(-1.0, 1.0, (2,), np.float32) for a in IDS} if continuous
           else {a: gspaces.Discrete(5) for a in IDS})
    return obs, act


def _pair(cls_pair, continuous, **kw):
    """A JAX agent and a port agent carrying its weights (every network of
    every agent)."""
    jcls, tcls = cls_pair
    obs, act = _spaces(continuous)
    args = dict(agent_ids=IDS, net_config=NET, lr_actor=1e-2, lr_critic=1e-2, gamma=0.9,
                tau=0.1, batch_size=B, seed=0, **kw)
    jagent = jcls(obs, act, **args)
    tagent = tcls(obs, act, device="cpu", **args)
    for name in _nets(tagent):
        for aid in IDS:
            assert dataclasses.asdict(getattr(tagent, name)[aid].config) == \
                dataclasses.asdict(getattr(jagent, name)[aid].config), (name, aid)
    load_params_from_numpy(tagent, {n: {a: _np(net.params) for a, net in
                                        getattr(jagent, n).items()} for n in _nets(tagent)})
    return jagent, tagent


def _batch(rng, continuous):
    def act():
        return (rng.uniform(-1, 1, (B, 2)).astype(np.float32) if continuous
                else rng.integers(0, 5, B).astype(np.int32))

    return {"obs": {a: rng.normal(size=(B, 6)).astype(np.float32) for a in IDS},
            "action": {a: act() for a in IDS},
            "reward": {a: rng.normal(size=B).astype(np.float32) for a in IDS},
            "next_obs": {a: rng.normal(size=(B, 6)).astype(np.float32) for a in IDS},
            "done": {a: (rng.random(B) < 0.3).astype(np.float32) for a in IDS}}


def _assert_weights(tagent, jagent, atol=1e-5):
    for name in _nets(tagent):
        for aid in IDS:
            got = _flat(getattr(tagent, name)[aid].params)
            want = _flat(_np(getattr(jagent, name)[aid].params))
            assert set(got) == set(want)
            for p, w in want.items():
                np.testing.assert_allclose(got[p], w, atol=atol, rtol=0,
                                           err_msg=f"{name}[{aid}]{p}")


# --------------------------------------------------------------------------- #
# The base: grouping, setups, net configs
# --------------------------------------------------------------------------- #

_IMG = gspaces.Box(0.0, 1.0, (8, 8, 3), np.float32)
_VEC = gspaces.Box(-1.0, 1.0, (4,), np.float32)
_SETUPS = {
    "homogeneous": ({"agent_0": _VEC, "agent_1": _VEC}, None),
    "mixed": ({"speaker_0": _VEC, "speaker_1": _VEC, "listener_0": _IMG}, None),
    "heterogeneous": ({"a": _VEC, "b": _IMG, "c": gspaces.Box(-1.0, 1.0, (3,), np.float32)},
                      None),
    "keyed": ({"speaker_0": _VEC, "listener_0": _IMG},
              {"speaker": {"latent_dim": 12}, "listener_0": {"encoder_config": {
                  "channel_size": (4,), "kernel_size": (3,), "stride_size": (1,)}}}),
}


@pytest.mark.parametrize("name", list(_SETUPS))
def test_grouping_setup_and_net_configs_match_jax(name):
    """Groups, the setup class, the unique spaces, and the per-agent and
    centralised-critic net configs (a flat encoder_config filtered per
    space, keyed overrides over the flat defaults) equal the JAX base's."""
    obs, net = _SETUPS[name]
    net = net or {"latent_dim": 16, "encoder_config": {"hidden_size": (32,),
                                                       "channel_size": (8,)}}
    act = {a: gspaces.Discrete(3) for a in obs}
    j = JMABase(obs, act, seed=0)
    t = MultiAgentRLAlgorithm(obs, act, seed=0, device="cpu")
    assert t.grouped_agents == j.grouped_agents
    assert t.get_setup() == MultiAgentSetup(j.get_setup().value)
    assert list(t.unique_observation_spaces) == list(j.unique_observation_spaces)
    assert t.build_net_config(net) == j.build_net_config(net)
    critic_space = gspaces.Box(-np.inf, np.inf, (20,), np.float32)
    assert t.build_critic_config(critic_space, net) == j.build_critic_config(critic_space, net)
    rewards = {a: np.arange(3, dtype=np.float32) * (i + 1) for i, a in enumerate(obs)}
    for a, v in t.sum_shared_rewards(rewards).items():
        np.testing.assert_array_equal(v, j.sum_shared_rewards(rewards)[a])
    with pytest.raises(AssertionError, match="must share"):
        MultiAgentRLAlgorithm({"x_0": _VEC, "x_1": _IMG}, {"x_0": act[next(iter(act))],
                                                             "x_1": act[next(iter(act))]},
                              device="cpu")


# --------------------------------------------------------------------------- #
# SimpleSpread, its vector envs and the stacked step
# --------------------------------------------------------------------------- #


def _states(rng, n, A=2, t=None):
    pos = rng.uniform(-1.6, 1.6, (n, A, 2)).astype(np.float32)
    lm = rng.uniform(-1, 1, (n, A, 2)).astype(np.float32)
    t = rng.integers(0, 25, n).astype(np.int32) if t is None else t
    return pos, lm, t


def _actions(rng, n, continuous, A=2):
    return [rng.uniform(-1.5, 1.5, (n, 2)).astype(np.float32) if continuous
            else rng.integers(0, 5, n).astype(np.int32) for _ in range(A)]


@pytest.mark.parametrize("continuous", [False, True])
def test_simple_spread_step_matches_jax(continuous):
    """The batched step against the JAX env's step vmapped over 32 envs on
    identical states (positions past the clip, steps at the time limit) and
    actions (continuous ones past +-1): obs, positions, shared reward
    (atol 1e-6) and truncation equal; the reset's observation layout too."""
    rng = np.random.default_rng(0)
    jenv, tenv = SimpleSpreadJax(2, continuous), SimpleSpreadTorch(2, continuous)
    assert tenv.agent_ids == jenv.agent_ids
    for a in IDS:
        assert tenv.observation_spaces[a].shape == jenv.observation_spaces[a].shape
        assert repr(tenv.action_spaces[a]).split("(")[0] == \
            type(jenv.action_spaces[a]).__name__
    pos, lm, t = _states(rng, 32)
    acts = _actions(rng, 32, continuous)
    jout = jax.vmap(jenv.step_fn, in_axes=(0, 0, None))(
        JMAState(pos, lm, t), {a: x for a, x in zip(IDS, acts)}, jax.random.PRNGKey(0))
    tout = tenv.step_fn(MAState(torch.from_numpy(pos), torch.from_numpy(lm),
                                torch.from_numpy(t)),
                        {a: torch.from_numpy(x) for a, x in zip(IDS, acts)})
    np.testing.assert_allclose(tout[0].pos.numpy(), np.asarray(jout[0].pos), atol=1e-7)
    np.testing.assert_array_equal(tout[0].t.numpy(), np.asarray(jout[0].t))
    for a in IDS:
        np.testing.assert_allclose(tout[1][a].numpy(), np.asarray(jout[1][a]), atol=1e-6)
        np.testing.assert_allclose(tout[2][a].numpy(), np.asarray(jout[2][a]), atol=1e-6)
        np.testing.assert_array_equal(tout[3][a].numpy(), np.asarray(jout[3][a]))
        np.testing.assert_array_equal(tout[4][a].numpy(), np.asarray(jout[4][a]))
    assert tout[4][IDS[0]].any() and not tout[4][IDS[0]].all()
    state, obs = tenv.reset_fn(5, torch.Generator().manual_seed(0))
    assert state.pos.shape == (5, 2, 2) and (state.t == 0).all()
    assert (state.pos.abs() <= 1).all() and (state.landmarks.abs() <= 1).all()
    jobs = jenv._obs(JMAState(state.pos[0].numpy(), state.landmarks[0].numpy(), 0))
    for a in IDS:
        np.testing.assert_allclose(obs[a][0].numpy(), np.asarray(jobs[a]), atol=1e-7)


@pytest.mark.parametrize("continuous", [False, True])
def test_vec_env_steps_and_autoreset_match_jax(continuous):
    """``MultiAgentTorchVecEnv`` from the JAX vector env's state: 30 steps on
    identical actions through a truncation at 25: rewards, flags and
    ``final_obs`` equal the JAX env's (atol 1e-6) while no env has reset,
    and on the reset step the port's obs is its own fresh episode (t = 0,
    positions in [-1, 1], obs of its state) where the JAX env's is its own."""
    rng = np.random.default_rng(1)
    jvec = MultiAgentJaxVecEnv(SimpleSpreadJax(2, continuous), num_envs=4, seed=0)
    tvec = MultiAgentTorchVecEnv(SimpleSpreadTorch(2, continuous), num_envs=4, seed=0,
                                 device="cpu")
    jobs, _ = jvec.reset()
    tobs, info = tvec.reset()
    assert info == {} and set(tobs) == set(IDS) and tobs[IDS[0]].shape == (4, 6)
    js = jvec._state
    tvec._state = MAState(torch.from_numpy(np.array(js.pos)),
                          torch.from_numpy(np.array(js.landmarks)),
                          torch.from_numpy(np.array(js.t)).int())
    for step in range(30):
        acts = _actions(rng, 4, continuous)
        jo, jr, jt, jtr, ji = jvec.step({a: x for a, x in zip(IDS, acts)})
        to, tr, tt, ttr, ti = tvec.step({a: torch.from_numpy(x) for a, x in zip(IDS, acts)})
        if step <= 24:
            for a in IDS:
                np.testing.assert_allclose(tr[a].numpy(), jr[a], atol=1e-6)
                np.testing.assert_array_equal(ttr[a].numpy(), jtr[a])
                np.testing.assert_array_equal(tt[a].numpy(), jt[a])
                np.testing.assert_allclose(ti["final_obs"][a].numpy(), ji["final_obs"][a],
                                           atol=1e-6)
        if step < 24:
            for a in IDS:
                np.testing.assert_allclose(to[a].numpy(), jo[a], atol=1e-6)
        if step == 24:
            assert ttr[IDS[0]].all() and (tvec._state.t == 0).all()
            assert (tvec._state.pos.abs() <= 1).all()
            want = tvec.env._obs(tvec._state)
            for a in IDS:
                torch.testing.assert_close(to[a], want[a], rtol=0, atol=0)


def test_ma_autoreset_step_matches_jax_with_its_resets_fed():
    """The stacked step ([A, N] actions) against the JAX one over 4 steps
    from step counts near the limit, the JAX step's own reset draws fed in
    as ``reset=``: state, obs, shared reward, flags and final obs equal
    (atol 1e-6)."""
    rng = np.random.default_rng(2)
    jenv, tenv = SimpleSpreadJax(2, max_steps=25), SimpleSpreadTorch(2, max_steps=25)
    n = 6
    pos, lm, t = _states(rng, n, t=np.array([20, 23, 24, 3, 24, 0], np.int32))
    count = t.copy()
    jstep, tstep = j_ma_step(jenv), make_ma_autoreset_step(tenv)
    jv = JVecState(JMAState(pos, lm, t), count, jax.random.PRNGKey(7))
    tv = VecState(MAState(torch.from_numpy(pos), torch.from_numpy(lm), torch.from_numpy(t)),
                  torch.from_numpy(count), None)
    for _ in range(4):
        acts = np.stack(_actions(rng, n, False))
        # the resets the JAX step draws: split(key) -> per-env split -> k_reset
        _, sub = jax.random.split(jv.key)
        k_reset = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(sub, n))
        rs, robs = jax.vmap(jenv.reset_fn)(k_reset)
        reset = (MAState(*(torch.from_numpy(np.array(x)) for x in rs)),
                 {a: torch.from_numpy(np.array(v)) for a, v in robs.items()})
        jv, jo, jr, jt, jtr, jf = jstep(jv, jnp.asarray(acts))
        tv, to, tr, tt, ttr, tf = tstep(tv, torch.from_numpy(acts), reset=reset)
        for got, want in ((to, jo), (tr, jr), (tf, jf), (tv.env_state.pos, jv.env_state.pos),
                          (tv.env_state.landmarks, jv.env_state.landmarks)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        for got, want in ((tt, jt), (ttr, jtr), (tv.step_count, jv.step_count),
                          (tv.env_state.t, jv.env_state.t)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------- #
# Sanitising, the info helpers, the buffer, the Gumbel pick
# --------------------------------------------------------------------------- #


def test_sanitize_ma_transition_matches_jax():
    """Host arrays equal the JAX function's output exactly (dicts, tuples,
    ints untouched); a tensor gets zeros at its NaNs with no host read and
    keeps +-inf (the documented difference: nan_to_num clamps them)."""
    obs = {"a": np.array([1.0, np.nan, 3.0], np.float32),
           "b": {"x": np.array([np.nan, 2.0]), "y": (np.array([1, 2]), np.array([np.nan]))},
           "c": np.array([1.0, 2.0], np.float32)}
    rew = {"a": np.array([np.nan, 1.0]), "b": np.array([0.5, 1.0])}
    tobs, trew = sanitize_ma_transition(obs, rew)
    jobs, jrew = j_sanitize(obs, rew)
    for got, want in zip(jax.tree_util.tree_leaves((tobs, trew)),
                         jax.tree_util.tree_leaves((jobs, jrew))):
        np.testing.assert_array_equal(got, want)
    assert tobs["c"] is obs["c"]
    x = torch.tensor([1.0, float("nan"), float("inf"), -2.0])
    tx, ti = sanitize_ma_transition({"a": x}, {"a": torch.tensor([1, 2])})
    assert torch.equal(tx["a"], torch.tensor([1.0, 0.0, float("inf"), -2.0]))
    assert torch.equal(ti["a"], torch.tensor([1, 2]))


def test_info_helpers_match_jax():
    """get_env_defined_actions, extract_action_masks, process_ma_infos,
    apply_env_defined_actions (masked array, NaN rows, full override; on
    numpy and on a tensor) and forced_action_arrays (with and without the
    spaces, a [B, 1] column) equal the JAX helpers; an empty info costs
    nothing."""
    masked = np.ma.masked_array([1, 0, 2, 0], mask=[False, True, False, True])
    info = {"agent_0": {"action_mask": [1, 0, 1], "env_defined_action": masked},
            "agent_1": {"env_defined_action": np.array([np.nan, 1.0, np.nan, 0.5],
                                                       np.float32)[:, None]}}
    spaces_ = {"agent_0": gspaces.Discrete(3), "agent_1": gspaces.Box(-1, 1, (1,))}
    assert TU.get_env_defined_actions(info, IDS).keys() == \
        JU.get_env_defined_actions(info, IDS).keys()
    assert TU.extract_action_masks(info, IDS) == JU.extract_action_masks(info, IDS)
    assert TU.process_ma_infos({}, IDS) == (None, None) == JU.process_ma_infos({}, IDS)
    tm, teda = TU.process_ma_infos(info, IDS)
    jm, jeda = JU.process_ma_infos(info, IDS)
    np.testing.assert_array_equal(tm["agent_0"].numpy(), np.asarray(jm["agent_0"]))
    assert tm["agent_1"] is None and jm["agent_1"] is None
    out = {"agent_0": np.array([2, 2, 1, 1]), "agent_1": np.zeros((4, 1), np.float32)}
    want = JU.apply_env_defined_actions(jeda, dict(out))
    for a in IDS:
        np.testing.assert_array_equal(TU.apply_env_defined_actions(teda, dict(out))[a], want[a])
        got = TU.apply_env_defined_actions(teda, {k: torch.from_numpy(v) for k, v in out.items()})
        np.testing.assert_array_equal(got[a].numpy(), want[a])
    full = {"agent_0": 1, "agent_1": None}
    np.testing.assert_array_equal(TU.apply_env_defined_actions(full, dict(out))["agent_0"],
                                  JU.apply_env_defined_actions(full, dict(out))["agent_0"])
    for sp in (spaces_, None):
        tf = TU.forced_action_arrays(teda, IDS, 4, sp)
        jf = JU.forced_action_arrays(jeda, IDS, 4, sp)
        assert tf.keys() == jf.keys()
        for a in tf:
            for g, w in zip(tf[a], jf[a]):
                np.testing.assert_array_equal(g, w)
                assert g.dtype == w.dtype
    assert TU.forced_action_arrays(None, IDS, 4) is None


def test_replay_buffer_rows_match_jax():
    """Vectorised saves and staged transitions (flush_every 3) of a 2-agent
    dict tree, past the ring's end: the fill and the rows at every index
    equal the JAX buffer's; sampling gives [B] rows per agent on the
    buffer's device."""
    rng = np.random.default_rng(3)
    jbuf = JMABuffer(40, IDS, flush_every=3)
    tbuf = MultiAgentReplayBuffer(40, IDS, device="cpu", flush_every=3, seed=0)
    for i in range(12):
        tr = _batch(rng, continuous=i % 2 == 0)
        tr = {k: {a: v[a][:4] for a in IDS} for k, v in tr.items()}
        tr["action"] = {a: rng.integers(0, 5, 4) for a in IDS}
        for buf in (jbuf, tbuf):
            (buf.stage_to_memory if i % 3 else buf.save_to_memory)(
                tr["obs"], tr["action"], tr["reward"], tr["next_obs"], tr["done"],
                is_vectorised=True)
    for buf in (jbuf, tbuf):
        buf.flush()
    assert len(tbuf) == len(jbuf) == 40
    idx = np.arange(40)
    got, want = tbuf.sample_from_indices(idx), _np(jbuf.sample_from_indices(idx))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert g.numpy().dtype == np.asarray(w).dtype, path
        np.testing.assert_array_equal(g.numpy(), w, err_msg=jax.tree_util.keystr(path))
    sample = tbuf.sample(8)
    assert sample["obs"]["agent_1"].shape == (8, 6) and sample["action"]["agent_0"].shape == (8,)


def test_gumbel_softmax_on_the_jax_uniforms():
    """The hard Gumbel-softmax on the JAX package's uniforms: the same
    one-hot picks, and the straight-through gradient of a weighted sum
    (atol 1e-6); the soft sample (tau 0.5) too."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(64, 5)).astype(np.float32)
    w = rng.normal(size=(64, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, logits.shape, minval=1e-10))
    for hard, tau in ((True, 1.0), (False, 0.5)):
        jy, jg = jax.value_and_grad(
            lambda lg: jnp.sum(j_gumbel(lg, key, tau=tau, hard=hard) * w))(jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_(True)
        y = GumbelSoftmax(lt, torch.from_numpy(u), tau=tau, hard=hard)
        (y * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(float((y.detach() * torch.from_numpy(w)).sum()), float(jy),
                                   atol=1e-4)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(jg), atol=1e-6)
        if hard:
            np.testing.assert_array_equal(
                y.detach().argmax(-1).numpy(),
                np.asarray(j_gumbel(jnp.asarray(logits), key)).argmax(-1))


# --------------------------------------------------------------------------- #
# MADDPG and MATD3
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("continuous", [False, True])
def test_maddpg_learn_matches_jax(continuous):
    """Three learns on identical batches (every critic's TD step, then every
    actor's step against the updated critics, the discrete actor's
    expected-Q loss, soft targets): mean critic loss rtol 1e-5, every weight
    of the eight networks atol 1e-5; then greedy actions and critic values
    on the carried weights (atol 1e-5)."""
    jagent, tagent = _pair((JMADDPG, MADDPG), continuous)
    rng = np.random.default_rng(5)
    for _ in range(3):
        batch = _batch(rng, continuous)
        np.testing.assert_allclose(tagent.learn(batch), jagent.learn(batch), rtol=1e-5)
        _assert_weights(tagent, jagent)
    obs = {a: rng.normal(size=(9, 6)).astype(np.float32) for a in IDS}
    tact, jact = tagent.get_action(obs, training=False), jagent.get_action(obs, training=False)
    tq, jq = tagent.critic_values(obs), jagent.critic_values(obs)
    for a in IDS:
        np.testing.assert_allclose(tact[a].numpy(), jact[a], atol=1e-5)
        np.testing.assert_allclose(tq[a], jq[a], atol=1e-5)


@pytest.mark.parametrize("continuous", [False, True])
def test_matd3_learn_matches_jax(continuous):
    """Three MATD3 learns at policy_freq 2 (learn 2 on the cadence: the actor
    step and every target; learns 1 and 3 off it: critics only) on identical
    batches and the JAX smoothing normals: summed twin-critic loss rtol
    1e-5, every weight of the twelve networks atol 1e-5."""
    jagent, tagent = _pair((JMATD3, MATD3), continuous, policy_noise=0.3, noise_clip=0.4)
    rng = np.random.default_rng(6)
    for i in range(3):
        batch = _batch(rng, continuous)
        key = jax.random.PRNGKey(20 + i)
        jagent.next_key = lambda key=key: key
        jl = jagent.learn(batch)
        keys = jax.random.split(key, len(IDS) + 1)
        normals = {a: torch.from_numpy(np.array(jax.random.normal(keys[j], (B, 2))))
                   for j, a in enumerate(IDS)} if continuous else {}
        tagent._learn_counter += 1
        on = tagent._learn_counter % tagent.policy_freq == 0
        assert on == (i == 1)
        tl = float(tagent.twin_train_step(tagent._prepare(batch), normals, on))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _assert_weights(tagent, jagent)
    # learn() draws its own normals and keeps the cadence
    assert np.isfinite(tagent.learn(_batch(rng, continuous))) and tagent._learn_counter == 4


def test_maddpg_get_action_masks_forced_actions_and_exploration():
    """Sampling stays on the device: exploration moves continuous actions
    inside the box and Gumbel picks cover the discrete actions; an
    action_mask from the info is never violated, an env-defined action
    overrides the policy's, an unbatched observation gives unbatched
    actions."""
    obs = {a: torch.randn(64, 6) for a in IDS}
    _, tagent = _pair((JMADDPG, MADDPG), False)
    info = {"agent_0": {"action_mask": [0, 1, 0, 1, 0]},
            "agent_1": {"env_defined_action": np.full(64, 3)}}
    acts = tagent.get_action(obs, training=True, infos=info)
    assert set(acts["agent_0"].unique().tolist()) <= {1, 3}
    assert (acts["agent_1"] == 3).all()
    assert len(tagent.get_action(obs, training=True)["agent_0"].unique()) > 1
    one = tagent.get_action({a: obs[a][0] for a in IDS}, training=False)
    assert one["agent_0"].dim() == 0
    _, cagent = _pair((JMADDPG, MADDPG), True)
    greedy = cagent.get_action(obs, training=False)["agent_0"]
    noisy = cagent.get_action(obs, training=True)["agent_0"]
    assert not torch.equal(greedy, noisy) and noisy.abs().max() <= 1.0


@pytest.mark.parametrize("pair", [(JMADDPG, MADDPG), (JMATD3, MATD3)],
                         ids=["MADDPG", "MATD3"])
def test_architecture_mutation_matches_jax(pair):
    """One architecture mutation per seed through both engines (the method
    drawn on the first actor, applied to every actor and centralised critic
    with one seed, the targets rebuilt, both optimizer states re-initialised
    over all agents): the same method, configs and preserved weights (atol 0
    on the slabs both keep) on every network of every agent; a learn follows
    on the new shapes."""
    for seed in range(3):
        jagent, tagent = _pair(pair, continuous=seed == 1)
        before = {(n, a): _flat(getattr(tagent, n)[a].params) for n in _nets(tagent)
                  for a in IDS}
        kw = dict(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                  new_layer_prob=0.5, rand_seed=seed)
        jagent = JMutations(**kw).mutation([jagent])[0]
        tagent = Mutations(**kw).mutation([tagent])[0]
        assert tagent.mut == jagent.mut
        for (name, aid), old_params in before.items():
            tnet, jnet = getattr(tagent, name)[aid], getattr(jagent, name)[aid]
            assert dataclasses.asdict(tnet.config) == dataclasses.asdict(jnet.config), name
            got, want = _flat(tnet.params), _flat(_np(jnet.params))
            assert {p: v.shape for p, v in got.items()} == {p: v.shape for p, v in want.items()}
            for p, old in old_params.items():
                if p in got:
                    slab = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, got[p].shape))
                    np.testing.assert_array_equal(got[p][slab], want[p][slab],
                                                  err_msg=f"{seed}: {name}[{aid}]{p}")
        assert np.isfinite(tagent.learn(_batch(np.random.default_rng(seed), seed == 1)))


# --------------------------------------------------------------------------- #
# The loop, the probes, checkpoints, populations
# --------------------------------------------------------------------------- #


def _loop_run(pkg, algo, sink=None):
    """Population 2 on SimpleSpread (2 agents, 4 envs), one generation of 32
    env steps, tournament and mutation, through either package's loop."""
    from agilerl_tpu.utils.utils import create_population as j_create
    from agilerl_tpu_torch.observability.facade import RunTelemetry
    from agilerl_tpu_torch.observability.registry import MetricsRegistry
    from agilerl_tpu_torch.utils.utils import create_population

    hp = {"POP_SIZE": 2, "BATCH_SIZE": 8, "LEARN_STEP": 2, "AGENT_IDS": IDS}
    if pkg == "jax":
        env = MultiAgentJaxVecEnv(SimpleSpreadJax(2), num_envs=4, seed=0)
        pop = j_create(algo, env.observation_spaces, env.action_spaces, NET, hp, seed=0)
        mem = JMABuffer(200, IDS)
        tourn, mut, train, kw = (JTournament(2, True, 2, 1), JMutations(1.0, 0, 0, 0, 0, 0),
                                 j_train, {})
    else:
        env = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=4, seed=0, device="cpu")
        pop = create_population(algo, env.observation_spaces, env.action_spaces, NET, hp,
                                seed=0, device="cpu")
        assert all(a.agent_ids == IDS and a.index == i for i, a in enumerate(pop))
        mem = MultiAgentReplayBuffer(200, IDS, device="cpu")
        tourn = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
        mut, train = Mutations(1.0, 0, 0, 0, 0, 0, rand_seed=0), train_multi_agent_off_policy
        kw = dict(telemetry=RunTelemetry(registry=MetricsRegistry(sink=sink), lineage=False))
    pop, fits = train(env, "simple_spread", algo, pop, mem, max_steps=32, evo_steps=32,
                      eval_steps=5, tournament=tourn, mutation=mut, verbose=False, seed=0, **kw)
    return dict(pop=len(pop), fits=[len(f) for f in fits],
                finite=bool(np.isfinite(np.asarray(fits)).all()), steps=[a.steps for a in pop],
                rows=len(mem), algo=[type(a).__name__ for a in pop]), env, pop, mem


@pytest.mark.parametrize("algo", ["MADDPG", "MATD3"])
def test_train_multi_agent_off_policy_returns_the_jax_loops_shapes(algo):
    """The port's loop returns what the JAX loop returns (population size,
    one finite fitness per generation per agent, steps) and fills its buffer
    as far: MADDPG against the JAX loop itself, MATD3 against the counters
    the same loop gives (its rows, steps and learns are the JAX loop's,
    whatever the algorithm); the generation events count the learns."""
    from agilerl_tpu_torch.observability.events import MemorySink

    sink = MemorySink()
    got, env, pop, mem = _loop_run("torch", algo, sink)
    want = (_loop_run("jax", algo)[0] if algo == "MADDPG" else
            dict(pop=2, fits=[1, 1], finite=True, steps=[[32, 32]] * 2, rows=64,
                 algo=[algo] * 2))
    assert got == want
    assert got["fits"] == [1, 1] and got["rows"] == 64
    gens = [e for e in sink.events if e["kind"] == "generation"]
    # 8 vector steps of 4 envs per agent, learn_step 2 < 4 envs: a learn at
    # every step once the buffer holds a batch of 8 (from the first agent's 2nd)
    assert [g["learn_calls"] for g in gens] == [15]
    assert np.isfinite(gens[0]["last_losses"]).all() and len(gens[0]["last_losses"]) == 2
    # wb=True runs: wandb does not import here, so the loop logs to its sink
    # only, as the JAX loop does
    _, fits = train_multi_agent_off_policy(env, "s", algo, pop, mem, max_steps=64,
                                           evo_steps=32, eval_steps=5, verbose=False,
                                           wb=True)
    assert [len(f) for f in fits] == [1, 1] and np.isfinite(np.asarray(fits)).all()
    with pytest.raises(NotImplementedError, match="port's replay buffers"):
        train_multi_agent_off_policy(env, "s", algo, pop, object(), max_steps=1)


_PROBE_NET = {"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}}
_PROBES = {
    "MADDPG/ConstantReward": (PM.ConstantRewardEnvMA, MADDPG,
                              dict(lr_critic=5e-3, gamma=0.9, tau=0.5), 200, {}),
    "MADDPG/ObsDependentRewardImage": (PM.ObsDependentRewardImageEnvMA, MADDPG,
                                       dict(lr_critic=5e-3, gamma=0.9, tau=0.5), 200, {}),
    "MADDPG/FixedObsPolicyContActions": (
        PM.FixedObsPolicyContActionsEnvMA, MADDPG,
        dict(lr_actor=3e-3, lr_critic=5e-3, gamma=0.9, tau=0.3, expl_noise=0.2), 250, {}),
    "MATD3/DiscountedReward": (PM.DiscountedRewardEnvMA, MATD3,
                               dict(lr_actor=1e-3, lr_critic=5e-3, gamma=0.9, tau=0.3,
                                    policy_freq=1), 250, dict(atol=0.3)),
}


@pytest.mark.parametrize("name", list(_PROBES))
def test_probe(name):
    """The JAX package's probe settings (tests/test_envs/test_probe_ma.py) at
    200-250 learns (each passes on seeds 0-3 at these budgets): the critics
    reach the value tables (the image variant through the CNN), the
    continuous policy its target, MATD3 the discounting chain."""
    env_cls, cls, kw, steps, extra = _PROBES[name]
    env = env_cls()
    PM.check_ma_q_learning_with_probe_env(
        env, cls, dict(observation_spaces=env.observation_spaces,
                       action_spaces=env.action_spaces, agent_ids=env.agent_ids,
                       net_config=_PROBE_NET, seed=0, device="cpu", **kw),
        learn_steps=steps, **extra)


def test_probe_grid_classes_step():
    """All 22 probe variants construct and step through the vector env with
    finite rewards and their tables, as the JAX grid does."""
    names = [n for n in dir(PM) if n.endswith("EnvMA") and not n.startswith("_")]
    assert len(names) == 22
    rng = np.random.default_rng(0)
    for n in names:
        env = getattr(PM, n)()
        vec = MultiAgentTorchVecEnv(env, num_envs=2, seed=0, device="cpu")
        obs, _ = vec.reset(seed=0)
        assert obs["agent_0"].shape == (2,) + env.observation_spaces["agent_0"].shape
        actions = {a: (rng.uniform(0, 1, (2, 1)).astype(np.float32) if env.continuous
                       else rng.integers(0, 2, 2)) for a in env.agent_ids}
        _, rew, term, _, _ = vec.step(actions)
        assert all(torch.isfinite(rew[a]).all() for a in env.agent_ids), n
        assert env.sample_obs, n


def test_maddpg_checkpoint_round_trip(tmp_path):
    """A port MADDPG carrying a JAX agent's weights, saved and loaded (and
    through load_population_checkpoint): every weight equals the JAX
    agent's, both optimizer states come back, and the loaded agent acts as
    the saved one."""
    jagent, tagent = _pair((JMADDPG, MADDPG), True)
    tagent.learn(_batch(np.random.default_rng(0), True))
    path = tmp_path / "maddpg.ckpt"
    tagent.save_checkpoint(path)
    TU.save_population_checkpoint([tagent], str(tmp_path / "pop.ckpt"))
    for loaded in (MADDPG.load(path, device="cpu"),
                   TU.load_population_checkpoint("MADDPG", str(tmp_path / "pop.ckpt"), [0],
                                                 device="cpu")[0]):
        assert loaded.dev == torch.device("cpu") and loaded.agent_ids == IDS
        for name in _nets(tagent):
            for aid in IDS:
                for p, x in _flat(getattr(tagent, name)[aid].params).items():
                    np.testing.assert_array_equal(_flat(getattr(loaded, name)[aid].params)[p], x)
        for opt in ("actor_optimizers", "critic_optimizers"):
            for a, b in zip(jax.tree_util.tree_leaves(_np(getattr(loaded, opt).opt_state)),
                            jax.tree_util.tree_leaves(_np(getattr(tagent, opt).opt_state))):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        obs = {a: torch.randn(8, 6) for a in IDS}
        for a in IDS:
            assert torch.equal(loaded.get_action(obs, training=False)[a],
                               tagent.get_action(obs, training=False)[a])
