"""Kill-and-resume in every classic loop of the port
(agilerl_tpu_torch.resilience.Resilience), on the CPU: a seeded run whose
second snapshot is torn by the ``FaultInjector``, resumed by a fresh
population from the first complete snapshot, ends as the port's own
uninterrupted run ends, bit for bit: the fitness streams, every weight and
every Adam moment. ``ScanRun`` resumes into a run of another seed with the
same generations (and refuses another population size); a preemption under
``on_preempt="finish_generation"`` lands on the boundary and resumes the
same run."""

import random

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.components.multi_agent_replay_buffer import MultiAgentReplayBuffer
from agilerl_tpu_torch.components.replay_buffer import ReplayBuffer
from agilerl_tpu_torch.envs.classic import CartPole
from agilerl_tpu_torch.envs.core import TorchVecEnv
from agilerl_tpu_torch.envs.multi_agent import MultiAgentTorchVecEnv, SimpleSpreadTorch
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection
from agilerl_tpu_torch.resilience import FaultInjector, InjectedCrash, Resilience
from agilerl_tpu_torch.training.train_bandits import train_bandits
from agilerl_tpu_torch.training.train_multi_agent_off_policy import train_multi_agent_off_policy
from agilerl_tpu_torch.training.train_multi_agent_on_policy import train_multi_agent_on_policy
from agilerl_tpu_torch.training.train_off_policy import train_off_policy
from agilerl_tpu_torch.training.train_on_policy import train_on_policy
from agilerl_tpu_torch.utils.tree import tree_leaves
from agilerl_tpu_torch.utils.utils import create_population
from agilerl_tpu_torch.wrappers.learning import BanditEnv

torch.set_num_threads(1)

NET = {"latent_dim": 16, "encoder_config": {"hidden_size": (32,)}}
IDS = ["agent_0", "agent_1"]


def _seed_globals():
    np.random.seed(1234)
    random.seed(1234)


def _evolution():
    # RL-HP mutations exercise the evolution streams; architecture mutations
    # stay off, as in the JAX acceptance test
    return (TournamentSelection(2, True, 2, eval_loop=1, rng=np.random.default_rng(0)),
            Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                      rl_hp=0.5, rand_seed=0))


def _dqn(res, resume):
    """The JAX acceptance test's recipe (tests/test_resilience/test_kill_resume.py)."""
    _seed_globals()
    env = TorchVecEnv(CartPole(), num_envs=4, seed=0, device="cpu")
    pop = create_population("DQN", env.single_observation_space, env.single_action_space, NET,
                            {"BATCH_SIZE": 16, "LR": 1e-3, "LEARN_STEP": 8, "POP_SIZE": 2},
                            seed=0, device="cpu")
    tournament, mutation = _evolution()
    return train_off_policy(env, "CartPole-v1", "DQN", pop, ReplayBuffer(1024, seed=0, device="cpu"),
                            max_steps=400, evo_steps=100, eval_steps=20, tournament=tournament,
                            mutation=mutation, verbose=False, resilience=res, resume=resume)


def _ppo(res, resume):
    _seed_globals()
    env = TorchVecEnv(CartPole(), num_envs=4, seed=0, device="cpu")
    pop = create_population("PPO", env.single_observation_space, env.single_action_space, NET,
                            {"POP_SIZE": 2, "LEARN_STEP": 16, "BATCH_SIZE": 32}, num_envs=4,
                            seed=0, device="cpu")
    tournament, mutation = _evolution()
    return train_on_policy(env, "CartPole-v1", "PPO", pop, max_steps=512, evo_steps=64,
                           eval_steps=20, tournament=tournament, mutation=mutation,
                           verbose=False, resilience=res, resume=resume)


def _maddpg(res, resume):
    _seed_globals()
    env = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=4, seed=0, device="cpu")
    pop = create_population("MADDPG", env.observation_spaces, env.action_spaces, NET,
                            {"POP_SIZE": 2, "BATCH_SIZE": 8, "LEARN_STEP": 4, "AGENT_IDS": IDS},
                            seed=0, device="cpu")
    tournament, mutation = _evolution()
    return train_multi_agent_off_policy(
        env, "simple_spread", "MADDPG", pop, MultiAgentReplayBuffer(256, IDS, device="cpu"),
        max_steps=96, evo_steps=24, eval_steps=5, tournament=tournament, mutation=mutation,
        verbose=False, seed=0, resilience=res, resume=resume)


def _ippo(res, resume):
    _seed_globals()
    env = MultiAgentTorchVecEnv(SimpleSpreadTorch(2), num_envs=4, seed=0, device="cpu")
    pop = create_population("IPPO", env.observation_spaces, env.action_spaces, NET,
                            {"POP_SIZE": 2, "BATCH_SIZE": 16, "LEARN_STEP": 8, "NUM_ENVS": 4,
                             "AGENT_IDS": IDS}, seed=0, device="cpu")
    tournament, mutation = _evolution()
    return train_multi_agent_on_policy(env, "simple_spread", "IPPO", pop, max_steps=128,
                                       evo_steps=32, eval_steps=5, tournament=tournament,
                                       mutation=mutation, verbose=False, resilience=res,
                                       resume=resume)


def _bandit_data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 3, n)
    centers = rng.normal(size=(3, 4)) * 2.0
    return centers[labels] + rng.normal(size=(n, 4)) * 0.5, labels


def _bandits(res, resume):
    _seed_globals()
    env = BanditEnv(*_bandit_data())
    pop = create_population("NeuralUCB", env.observation_space, env.action_space, NET,
                            {"POP_SIZE": 2, "BATCH_SIZE": 8, "LR": 1e-3, "LAMBDA": 1.0,
                             "REG": 0.000625, "LEARN_STEP": 2}, seed=0, device="cpu")
    tournament, mutation = _evolution()
    return train_bandits(env, "bandit", "NeuralUCB", pop, ReplayBuffer(512, seed=0, device="cpu"),
                         max_steps=80, evo_steps=20, eval_steps=10, tournament=tournament,
                         mutation=mutation, verbose=False, resilience=res, resume=resume)


# (run, save_every): each generation adds pop x evo_steps to total_steps, so
# a snapshot lands on every generation boundary
CASES = {"train_off_policy[DQN]": (_dqn, 200), "train_on_policy[PPO]": (_ppo, 128),
         "train_multi_agent_off_policy[MADDPG]": (_maddpg, 48),
         "train_multi_agent_on_policy[IPPO]": (_ippo, 64),
         "train_bandits[NeuralUCB]": (_bandits, 40)}


def _state(pop):
    """Every weight and optimizer leaf of a population, in order."""
    out = []
    for agent in pop:
        for net in agent.evolvable_attributes().values():
            for sub in (net.values() if isinstance(net, dict) else [net]):
                out += tree_leaves(sub.params)
        for cfg in agent.registry.optimizer_configs:
            out += [x for x in tree_leaves(getattr(agent, cfg.name).opt_state)
                    if isinstance(x, torch.Tensor)]
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_kill_and_resume_is_the_same_run(tmp_path, case):
    run, save_every = CASES[case]
    pop_a, fit_a = run(Resilience(tmp_path / "a", save_every=save_every,
                                  handle_signals=False), False)
    assert all(len(f) >= 3 for f in fit_a)
    with FaultInjector(kill_at_op=1, match=("commit",)):
        with pytest.raises(InjectedCrash):
            run(Resilience(tmp_path / "b", save_every=save_every, handle_signals=False), False)
    # the torn second snapshot is invisible: only the first commit survives
    res = Resilience(tmp_path / "b", save_every=save_every, handle_signals=False)
    assert len(res.manager.snapshots()) == 1
    pop_b, fit_b = run(res, True)
    assert fit_b == fit_a
    got, want = _state(pop_b), _state(pop_a)
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        assert torch.equal(x, y)


class _PreemptAfter:
    """Env proxy that requests a preemption after N steps."""

    def __init__(self, env, guard, after_steps):
        self.env, self._guard, self._after, self._n = env, guard, after_steps, 0

    def step(self, *a, **kw):
        self._n += 1
        if self._n == self._after:
            self._guard.request()
        return self.env.step(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.env, name)


def test_preempt_finish_generation_resumes_identically(tmp_path):
    """As the JAX package's test: a preemption mid-generation under
    on_preempt="finish_generation" snapshots on the boundary, and the
    resumed run continues the uninterrupted run's fitness stream; under
    "now" the run stops at once with one preempt snapshot."""
    _, fit_ref = _dqn(Resilience(tmp_path / "ref", handle_signals=False), False)
    for mode in ("finish_generation", "now"):
        res = Resilience(tmp_path / mode, handle_signals=False, on_preempt=mode)
        _seed_globals()
        env = TorchVecEnv(CartPole(), num_envs=4, seed=0, device="cpu")
        pop = create_population("DQN", env.single_observation_space, env.single_action_space,
                                NET, {"BATCH_SIZE": 16, "LR": 1e-3, "LEARN_STEP": 8,
                                      "POP_SIZE": 2}, seed=0, device="cpu")
        tournament, mutation = _evolution()
        _, fit = train_off_policy(_PreemptAfter(env, res.guard, 30), "CartPole-v1", "DQN", pop,
                                  ReplayBuffer(1024, seed=0, device="cpu"), max_steps=400,
                                  evo_steps=100, eval_steps=20, tournament=tournament,
                                  mutation=mutation, verbose=False, resilience=res)
        snaps = res.manager.snapshots()
        assert [s.kind for s in snaps] == ["preempt"]
        assert res.registry.counter("resilience/preemptions_total").value >= 1
        if mode == "now":
            assert fit == [[], []] and snaps[0].step == 30 * 4
    _, fit2 = _dqn(Resilience(tmp_path / "finish_generation", handle_signals=False), True)
    assert fit2 == fit_ref


def _evo_dqn():
    from agilerl_tpu_torch.algorithms.core.optimizer import adam
    from agilerl_tpu_torch.modules.mlp import MLPConfig
    from agilerl_tpu_torch.networks.base import NetworkConfig, default_encoder_config
    from agilerl_tpu_torch.parallel import EvoDQN

    env = CartPole()
    kind, enc = default_encoder_config(env.observation_space, latent_dim=16,
                                       encoder_config={"hidden_size": (32,)})
    cfg = NetworkConfig(encoder_kind=kind, encoder=enc, latent_dim=16,
                        head=MLPConfig(num_inputs=16, num_outputs=2, hidden_size=(32,)))
    return EvoDQN(env, cfg, adam(1e-3), num_envs=4, steps_per_iter=8, buffer_size=64,
                  batch_size=8, device="cpu")


def test_scan_run_resumes_bit_for_bit_and_refuses_another_pop_size(tmp_path):
    """tests/test_resilience/test_scan_snapshot.py's recipe: a pop-2 EvoDQN
    ScanRun snapshotted through Resilience after 2 generations, resumed into
    a run of another seed, gives the same 3 generations and the same leaves;
    a snapshot of pop 2 does not restore into pop 4."""
    from agilerl_tpu_torch.parallel import ScanRun

    engine = _evo_dqn()
    run = ScanRun(engine, pop_size=2, seed=0)
    run.run(2)
    res = Resilience(tmp_path, handle_signals=False)
    res.attach(pop=[run])
    res.snapshot(step=2)
    expected = run.run(3)

    run2 = ScanRun(engine, pop_size=2, seed=1234)
    res2 = Resilience(tmp_path, handle_signals=False)
    res2.attach(pop=[run2])
    res2.resume()
    assert run2.generation == 2 and run2.fitness_history == run.fitness_history[:2]
    np.testing.assert_array_equal(run2.run(3), expected)
    for a, b in zip(tree_leaves(run.pop), tree_leaves(run2.pop)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    other = ScanRun(engine, pop_size=4, seed=0)
    res3 = Resilience(tmp_path, handle_signals=False)
    res3.attach(pop=[other])
    with pytest.raises(ValueError, match="pop_size"):
        res3.resume()
