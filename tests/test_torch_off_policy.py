"""Parity of the port's off-policy loop (agilerl_tpu_torch.training
.train_off_policy) and checkpoints with the JAX package's on the CPU: a
short evolutionary Rainbow run (PER + 3-step) returns the JAX loop's shapes,
``merge_final_obs`` on object and dense arrays, the NEXT_STEP-autoreset
rows stored as the JAX loop stores them, checkpoint save -> resume for DQN
and PPO (weights held against the JAX agent carrying the same weights),
``save_elite`` and the hooks that still raise."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from gymnasium import spaces as gspaces  # noqa: E402

from agilerl_tpu.components import replay_buffer as JRB  # noqa: E402
from agilerl_tpu.hpo import Mutations as JMutations  # noqa: E402
from agilerl_tpu.hpo import TournamentSelection as JTournament  # noqa: E402
from agilerl_tpu.training.train_off_policy import merge_final_obs as j_merge  # noqa: E402
from agilerl_tpu.training.train_off_policy import train_off_policy as j_train  # noqa: E402
from agilerl_tpu.utils.utils import create_population as j_create  # noqa: E402
from agilerl_tpu.utils.utils import make_vect_envs as j_make_envs  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.dqn import DQN  # noqa: E402
from agilerl_tpu_torch.components import replay_buffer as RB  # noqa: E402
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.training.train_off_policy import merge_final_obs, train_off_policy  # noqa: E402
from agilerl_tpu_torch.training.train_on_policy import train_on_policy  # noqa: E402
from agilerl_tpu_torch.utils.utils import (  # noqa: E402
    create_population,
    load_population_checkpoint,
    make_vect_envs,
    save_population_checkpoint,
    tournament_selection_and_mutation,
)

torch.set_num_threads(1)

NET = {"latent_dim": 8, "encoder_config": {"hidden_size": (16,)},
       "head_config": {"hidden_size": (16,)}}
HP = {"POP_SIZE": 2, "BATCH_SIZE": 8, "LEARN_STEP": 2, "LR": 1e-3, "GAMMA": 0.99,
      "TAU": 0.01, "N_STEP": 3, "NUM_ATOMS": 11, "V_MIN": 0.0, "V_MAX": 50.0}


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


def test_train_off_policy_returns_the_jax_loops_shapes():
    """Population 2, 4 envs, Rainbow with PER and a paired 3-step buffer, 2
    generations, tournament and mutation: the port's loop returns what the
    JAX loop returns (population size, one finite fitness per generation per
    agent, steps, scores) and fills its rings as far."""
    out = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            env = j_make_envs("CartPole-v1", 4)
            pop = j_create("RainbowDQN", env.single_observation_space, env.single_action_space,
                           NET, HP, seed=0)
            mem = JRB.PrioritizedReplayBuffer(500, alpha=0.6)
            nmem = JRB.MultiStepReplayBuffer(500, n_step=3, gamma=0.99)
            tourn, mut, train = JTournament(2, True, 2, 1), JMutations(1.0, 0, 0, 0, 0, 0), j_train
        else:
            env = make_vect_envs("CartPole-v1", 4, device="cpu")
            pop = create_population("RainbowDQN", env.single_observation_space,
                                    env.single_action_space, NET, HP, seed=0, device="cpu")
            mem = RB.PrioritizedReplayBuffer(500, alpha=0.6, device="cpu")
            nmem = RB.MultiStepReplayBuffer(500, n_step=3, gamma=0.99, device="cpu")
            tourn = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
            mut = Mutations(1.0, 0, 0, 0, 0, 0, rand_seed=0)
            train = train_off_policy
        pop, fits = train(env, "CartPole-v1", "RainbowDQN", pop, mem, max_steps=64,
                          evo_steps=32, eval_steps=20, n_step=True, per=True,
                          n_step_memory=nmem, tournament=tourn, mutation=mut, verbose=False,
                          seed=0)
        out[pkg] = dict(pop=len(pop), fits=[len(f) for f in fits],
                        finite=bool(np.isfinite(np.asarray(fits)).all()),
                        steps=[a.steps for a in pop], scores=[len(a.scores) for a in pop],
                        rows=(len(mem), len(nmem)), algo=[type(a).__name__ for a in pop])
    assert out["torch"] == out["jax"]
    assert out["torch"]["fits"] == [2, 2] and out["torch"]["finite"]


def test_merge_final_obs_matches_jax():
    """gymnasium's object arrays (None where not done; flat and Dict obs)
    and dense arrays merge as in the JAX loop; device tensors merge to the
    same values by torch.where."""
    rng = np.random.default_rng(0)
    nxt = rng.normal(size=(4, 3)).astype(np.float32)
    fin = rng.normal(size=(4, 3)).astype(np.float32)
    done = np.array([True, False, True, False])
    objs = np.empty(4, dtype=object)
    objs[0], objs[2] = fin[0], fin[2]
    np.testing.assert_array_equal(merge_final_obs(nxt, objs, done), j_merge(nxt, objs, done))
    dnxt = {"a": nxt, "b": nxt[:, :1]}
    dobjs = np.empty(4, dtype=object)
    dobjs[2] = {"a": fin[2], "b": fin[2, :1]}
    got, want = merge_final_obs(dnxt, dobjs, done), j_merge(dnxt, dobjs, done)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    np.testing.assert_array_equal(merge_final_obs(nxt, fin, done), j_merge(nxt, fin, done))
    got = merge_final_obs({"a": nxt, "b": nxt[:, 0]}, {"a": fin, "b": fin[:, 0]}, done)
    want = j_merge({"a": nxt, "b": nxt[:, 0]}, {"a": fin, "b": fin[:, 0]}, done)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    t = merge_final_obs(torch.from_numpy(nxt), torch.from_numpy(fin), torch.from_numpy(done))
    np.testing.assert_array_equal(t.numpy(), j_merge(nxt, fin, done))
    assert merge_final_obs(nxt, None, done) is nxt


class _NextStepEnv:
    """A host vector env that autoresets on the NEXT step, as gymnasium >= 1.0
    does: the step after a done ignores its action and returns the reset
    obs, reward 0, not done. Env i ends its episodes after i + 2 steps;
    obs = [step in the episode, env id, 0.5]; actions are ignored."""

    autoreset_mode = "NEXT_STEP"

    def __init__(self, n=3):
        self.num_envs = n
        self.single_observation_space = gspaces.Box(0.0, 10.0, (3,), np.float32)
        self.single_action_space = gspaces.Discrete(2)
        self.limit = np.arange(n) + 2

    def _obs(self):
        return np.stack([self.t, np.arange(self.num_envs), np.full(self.num_envs, 0.5)],
                        -1).astype(np.float32)

    def reset(self, seed=None, options=None):
        self.t = np.zeros(self.num_envs)
        self.pending = np.zeros(self.num_envs, bool)
        return self._obs(), {}

    def step(self, action):
        reward = np.where(self.pending, 0.0, self.t + 1.0).astype(np.float32)
        self.t = np.where(self.pending, 0.0, self.t + 1.0)
        term = ~self.pending & (self.t >= self.limit)
        self.pending = term
        return self._obs(), reward, term, np.zeros(self.num_envs, bool), {}


@pytest.mark.parametrize("n_step", [False, True])
def test_next_step_autoreset_rows_match_jax(n_step):
    """On a NEXT_STEP-autoreset host env the port stores the rows the JAX
    loop stores: filler rows after a done are dropped, or, with the paired
    n-step buffer, replaced by the env's previous row (both rings)."""
    rings = {}
    for pkg in ("jax", "torch"):
        env = _NextStepEnv()
        obs_space, act_space = env.single_observation_space, env.single_action_space
        if pkg == "jax":
            pop = j_create("DQN", obs_space, act_space, NET, {"POP_SIZE": 1}, seed=0)
            mem, nmem = JRB.ReplayBuffer(256), JRB.MultiStepReplayBuffer(256, n_step=3)
            train = j_train
        else:
            pop = create_population("DQN", obs_space, act_space, NET, {"POP_SIZE": 1}, seed=0,
                                    device="cpu")
            mem = RB.ReplayBuffer(256, device="cpu")
            nmem = RB.MultiStepReplayBuffer(256, n_step=3, device="cpu")
            train = train_off_policy
        train(env, "stub", "DQN", pop, mem, max_steps=30, evo_steps=30, eval_steps=5,
              learning_delay=10 ** 9, n_step=n_step, n_step_memory=nmem if n_step else None,
              verbose=False)
        rings[pkg] = [mem.state] + ([nmem.state] if n_step else [])
    for tstate, jstate in zip(rings["torch"], rings["jax"]):
        assert tstate.size == int(jstate.size) and tstate.pos == int(jstate.pos)
        for k in ("obs", "reward", "next_obs", "done"):
            np.testing.assert_array_equal(tstate.storage[k].numpy(),
                                          np.asarray(jstate.storage[k]), err_msg=k)
    if not n_step:
        assert rings["torch"][0].size < 30  # the filler rows were dropped


@pytest.mark.parametrize("algo", ["DQN", "PPO"])
def test_checkpoint_save_resume_round_trip(algo, tmp_path):
    """A port population carrying a JAX agent's weights is checkpointed by
    the training loop's checkpoint= hook, resumed into a fresh population by
    resume=, and loaded by load_population_checkpoint: every restored weight
    equals the JAX agent's, and the restored agent acts as the saved one."""
    from agilerl_tpu.utils.utils import create_population as jcp

    env = make_vect_envs("CartPole-v1", 2, device="cpu")
    obs_space = gspaces.Box(-np.inf, np.inf, (4,), np.float32)
    act_space = gspaces.Discrete(2)
    hp = {"POP_SIZE": 1, "BATCH_SIZE": 8, "LEARN_STEP": 4 if algo == "DQN" else 8}
    jagent = jcp(algo, obs_space, act_space, NET, hp, num_envs=2, seed=5)[0]
    pop = create_population(algo, obs_space, act_space, NET, hp, num_envs=2, seed=1,
                            device="cpu")
    trees = {n: _np(getattr(jagent, n).params) for n in pop[0].registry.all_network_names()}
    load_params_from_numpy(pop[0], trees)
    path = tmp_path / "ckpt" / "pop.ckpt"
    save_population_checkpoint(pop, str(path))
    assert (tmp_path / "ckpt" / "pop_0.ckpt").exists()
    fresh = create_population(algo, obs_space, act_space, NET, hp, num_envs=2, seed=2,
                              device="cpu")
    if algo == "DQN":
        out, _ = train_off_policy(env, "CartPole-v1", algo, fresh, RB.ReplayBuffer(
            64, device="cpu"), max_steps=0, resume=True, checkpoint_path=str(path),
            verbose=False)
    else:
        out, _ = train_on_policy(env, "CartPole-v1", algo, fresh, max_steps=0, resume=True,
                                 checkpoint_path=str(path), verbose=False)
    loaded = load_population_checkpoint(algo, str(path), [0], device="cpu")[0]
    for agent in (out[0], loaded):
        for name, tree in trees.items():
            got = _flat(getattr(agent, name).params)
            for p, want in _flat(tree).items():
                np.testing.assert_array_equal(got[p], want, err_msg=f"{name}{p}")
        assert agent.actor.config == pop[0].actor.config
    obs = torch.from_numpy(np.random.default_rng(0).normal(size=(16, 4)).astype(np.float32))
    assert torch.equal(loaded.get_action(obs, training=False),
                       pop[0].get_action(obs, training=False))
    # the loop's checkpoint= hook writes each member with its step count
    run, _ = (train_off_policy(env, "CartPole-v1", algo, out, RB.ReplayBuffer(64, device="cpu"),
                               max_steps=8, evo_steps=8, eval_steps=5, checkpoint=8,
                               checkpoint_path=str(path), verbose=False)
              if algo == "DQN" else
              train_on_policy(env, "CartPole-v1", algo, out, max_steps=16, evo_steps=16,
                              eval_steps=5, checkpoint=16, checkpoint_path=str(path),
                              verbose=False))
    assert (tmp_path / "ckpt" / f"pop_0_step{run[0].steps[-1]}.ckpt").exists()


def test_save_elite_writes_a_file_and_unported_hooks_raise(tmp_path):
    """save_elite checkpoints the tournament's elite as {algo}_elite.ckpt;
    resilience= runs (a cadence snapshot), wb= runs (wandb does not import
    here: the loop logs to its sink only, as the JAX loop does), and a
    buffer that is not one of the port's is refused."""
    env = make_vect_envs("CartPole-v1", 2, device="cpu")
    pop = create_population("DQN", env.single_observation_space, env.single_action_space,
                            NET, {"POP_SIZE": 2}, seed=0, device="cpu")
    for a, f in zip(pop, (1.0, 5.0)):
        a.fitness.append(f)
    tournament_selection_and_mutation(
        pop, TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0)),
        Mutations(1.0, 0, 0, 0, 0, 0, rand_seed=0), algo="DQN", elite_path=str(tmp_path),
        save_elite=True)
    elite = DQN.load(tmp_path / "DQN_elite.ckpt", device="cpu")
    assert elite.fitness == [5.0] and elite.dev == torch.device("cpu")
    for name in ("actor", "actor_target"):
        for p, x in _flat(getattr(pop[1], name).params).items():
            np.testing.assert_array_equal(_flat(getattr(elite, name).params)[p], x)
    from agilerl_tpu_torch.resilience import Resilience

    for hook in (dict(resilience=Resilience(tmp_path / "snap", save_every=1,
                                            handle_signals=False)), dict(wb=True)):
        # one more generation of 8 steps on the population each time
        _, fits = train_off_policy(env, "CartPole-v1", "DQN", pop,
                                   RB.ReplayBuffer(64, device="cpu"),
                                   max_steps=pop[0].steps[-1] + 8, evo_steps=8, eval_steps=5,
                                   verbose=False, **hook)
        assert [len(f) for f in fits] == [1, 1]
        if "resilience" in hook:
            assert [s.kind for s in hook["resilience"].manager.snapshots()] == ["cadence"]
    with pytest.raises(NotImplementedError, match="port's replay buffers"):
        train_off_policy(env, "CartPole-v1", "DQN", pop, object(), per=True, max_steps=1)
