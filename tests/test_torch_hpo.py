"""Parity of the port's evolution (agilerl_tpu_torch.hpo, utils, training)
with the JAX package's, on the CPU: tournament selection and hyperparameter
mutation make the same picks and draw the same values from the same numpy
seeds, and finetune_llm_reasoning trains and evolves a population of two
tiny GRPO agents end to end; over PPO populations on carried weights every
mutation class gives the JAX package's choices, configs and preserved
weights, and a learn_step mutation resizes the rollout buffer."""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms.core.registry import (  # noqa: E402
    HyperparameterConfig as JHyperparameterConfig,
    RLParameter as JRLParameter,
)
from agilerl_tpu.algorithms.grpo import GRPO as JGRPO  # noqa: E402
from agilerl_tpu.algorithms.ppo import PPO as JPPO  # noqa: E402
from agilerl_tpu.hpo import Mutations as JMutations  # noqa: E402
from agilerl_tpu.hpo import TournamentSelection as JTournament  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.utils.llm_utils import CharTokenizer as JCharTokenizer  # noqa: E402
from agilerl_tpu.utils.llm_utils import ReasoningGym as JReasoningGym  # noqa: E402
from agilerl_tpu.utils.rng import derive_rng as j_derive_rng  # noqa: E402
from agilerl_tpu_torch.algorithms.core.base import load_params_from_numpy  # noqa: E402
from agilerl_tpu_torch.algorithms.grpo import GRPO as TGRPO  # noqa: E402
from agilerl_tpu_torch.algorithms.ppo import PPO as TPPO  # noqa: E402
from agilerl_tpu_torch.data.language_environment import (  # noqa: E402
    TokenPolicyAdapter,
    interact_environment,
)
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.training.train_llm import finetune_llm_reasoning  # noqa: E402
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, ReasoningGym  # noqa: E402
from agilerl_tpu_torch.utils.rng import derive_rng  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population  # noqa: E402

torch.set_num_threads(1)

TOK = CharTokenizer()
KW = dict(vocab_size=TOK.vocab_size, n_layer=1, n_head=2, d_model=32, max_seq_len=64)
JCFG = JM.GPTConfig(dtype=jnp.float32, **KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **KW)
FITNESS = ([0.1, 0.5], [0.9], [0.3, 0.2], [0.7], [0.4])


def _populations():
    """The same 5 agents in each package (fitness histories differ, so
    every clone names its parent), with the global numpy stream at the same
    point for both: a clone draws its seed from it in both packages."""
    np.random.seed(123)
    jpop = [JGRPO(config=JCFG, index=i, seed=i, bucketed_decode=False, lora_rank=2)
            for i in range(len(FITNESS))]
    for a in jpop[1:]:
        a.base_params = jpop[0].base_params
    tpop = [TGRPO(config=TCFG, index=i, seed=i, device="cpu", lora_rank=2)
            for i in range(len(FITNESS))]
    for a in tpop[1:]:
        a.base_params = tpop[0].base_params
    for pop in (jpop, tpop):
        for a, f in zip(pop, FITNESS):
            a.fitness = list(f)
    return jpop, tpop


def _summary(pop):
    return [(a.index, tuple(a.fitness), a.mut, a.lr, a.beta, a.group_size,
             float(np.asarray(a.optimizer.lr))) for a in pop]


@pytest.mark.parametrize("elitism,eval_loop,target", [(True, 1, None), (False, 2, 7)])
def test_tournament_and_mutation_match_jax(elitism, eval_loop, target):
    jpop, tpop = _populations()
    jt = JTournament(3, elitism, 5, eval_loop, rng=np.random.default_rng(7))
    tt = TournamentSelection(3, elitism, 5, eval_loop, rng=np.random.default_rng(7))
    np.random.seed(99)
    jelite, jnext = jt.select(jpop, target_size=target)
    np.random.seed(99)
    telite, tnext = tt.select(tpop, target_size=target)
    assert jelite.index == telite.index
    assert [(a.index, a.fitness) for a in jnext] == [(a.index, a.fitness) for a in tnext]

    # activation is drawn too: a no-op for GRPO in both packages
    kw = dict(no_mutation=0.3, architecture=0.0, parameters=0.0, activation=0.2, rl_hp=0.5,
              mutate_elite=elitism, rand_seed=11)
    jm, tm = JMutations(**kw), Mutations(**kw)
    for _ in range(3):
        jnext = jm.mutation(jnext)
        tnext = tm.mutation(tnext)
        assert _summary(tnext) == _summary(jnext)
    muts = {a.mut for a in tnext}
    assert muts & {"lr", "beta", "group_size"}, muts
    # the mutated lr reached the optimizer's state
    for a in tnext:
        assert a.optimizer.opt_state[1].hyperparams["learning_rate"] == a.lr


def test_unseeded_engines_draw_from_the_global_stream_as_jax():
    np.random.seed(5)
    want = [JTournament().rng.random(), JMutations().rng.random(), j_derive_rng().random()]
    np.random.seed(5)
    got = [TournamentSelection().rng.random(), Mutations().rng.random(), derive_rng().random()]
    assert got == want


def test_non_llm_mutations_raise_when_drawn():
    _, tpop = _populations()
    with pytest.raises(NotImplementedError):
        Mutations(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                  rand_seed=0).mutation(tpop[:1])


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    return [{"question": f"{a}+{b}=", "answer": str(a + b)} for a, b in rng.integers(0, 9, (n, 2))]


def _reward(c, a, p):
    return 0.1 * len(c) + float(c.startswith(str(a)))


def test_reasoning_gym_matches_jax():
    kw = dict(reward_fn=_reward, data_batch_size=3, seed=4)
    jenv = JReasoningGym(_rows(8, 0), _rows(4, 1), JCharTokenizer(), **kw)
    tenv = ReasoningGym(_rows(8, 0), _rows(4, 1), TOK, **kw)
    comp = np.random.default_rng(2).integers(0, TOK.vocab_size, (6, 5)).astype(np.int32)
    cmask = np.ones_like(comp)
    cmask[1, 3:] = 0
    for _ in range(4):  # crosses an epoch boundary: the reshuffle draws too
        jp, tp = jenv.reset(), tenv.reset()
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k])
        for a, b in zip(tenv.assemble_learn_batch(comp, cmask),
                        jenv.assemble_learn_batch(comp, cmask)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tenv.step(comp, cmask)[1], jenv.step(comp, cmask)[1])
    assert tenv.num_epochs == jenv.num_epochs >= 1


def test_finetune_llm_reasoning_evolves_a_population():
    """2 steps of a population of 2 on the arithmetic recipe; the eval at
    step 2 runs one tournament and one mutation round."""
    env = ReasoningGym(_rows(16, 0), _rows(4, 1), TOK, reward_fn=_reward, data_batch_size=2)
    pop = create_population("GRPO", population_size=2, seed=3, device="cpu", config=TCFG,
                            pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id,
                            group_size=2, batch_size=4, max_output_tokens=4, lora_rank=2,
                            INIT_HP={"LR": 1e-3})
    pop[1].base_params = pop[0].base_params
    before = [a.actor.params["blocks"]["0"]["wq"]["B"].clone() for a in pop]
    tournament = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
    mutation = Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                         rl_hp=0.5, rand_seed=0)
    assert [a.lr for a in pop] == [1e-3, 1e-3]
    new_pop, fitnesses = finetune_llm_reasoning(pop, env, max_steps=2, evaluation_interval=2,
                                                verbose=False, tournament=tournament,
                                                mutation=mutation)
    assert len(new_pop) == 2 and all(len(f) == 1 for f in fitnesses)
    assert all(np.isfinite(f[0]) for f in fitnesses)
    assert all(a.mut in ("None", "lr", "beta", "group_size") for a in new_pop)
    assert all(a.steps[-1] == 2 * 2 * 2 for a in pop)  # 2 steps x 2 prompts x group 2
    assert any(not torch.equal(a.actor.params["blocks"]["0"]["wq"]["B"], b)
               for a, b in zip(pop, before))
    with pytest.raises(AssertionError):
        finetune_llm_reasoning(pop, env, max_steps=1, verbose=False, tournament=tournament,
                               mutation=Mutations(architecture=0.5, parameters=0.0,
                                                  activation=0.0, rand_seed=0))


def test_language_environment_bridge():
    class Echo:
        def act(self, ids, mask):
            return np.concatenate([ids, ids[:, -1:]], axis=1), np.ones((1, ids.shape[1] + 1))

    class Env:
        def __init__(self):
            self.n = 0

        def reset(self):
            self.n = 0
            return "1+1="

        def step(self, action):
            self.n += 1
            return "1+1=" + action, float(action == "="), self.n >= 2

        def is_terminal(self):
            return self.n >= 2

    obs, seq = interact_environment(Env(), TokenPolicyAdapter(Echo(), TOK))
    assert [s[1] for s in seq] == ["=", "=", None] and seq[0][2] == 1.0


# --------------------- PPO populations (Queue 1's slice 5a) -------------------- #

PPO_NET = {"latent_dim": 16,
           "encoder_config": {"hidden_size": (32,), "min_mlp_nodes": 16, "max_mlp_nodes": 96},
           "head_config": {"hidden_size": (24,), "min_mlp_nodes": 16, "max_mlp_nodes": 96}}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    return out


def _sync(jagent, tagent):
    """Carry the JAX agent's network weights into the port's agent."""
    load_params_from_numpy(tagent, {n: _np(getattr(jagent, n).params)
                                    for n in ("actor", "critic")})


def _ppo_populations(n=4):
    """The same n PPO agents in each package, with the global numpy stream at
    the same point for both (clones draw their seeds from it)."""
    from gymnasium import spaces as gspaces

    obs_space, action_space = gspaces.Box(-1.0, 1.0, (4,), np.float32), gspaces.Discrete(2)
    kw = dict(net_config=PPO_NET, num_envs=2, learn_step=16, batch_size=32)
    np.random.seed(5)
    jpop = [JPPO(obs_space, action_space, index=i, seed=i, **kw) for i in range(n)]
    np.random.seed(5)
    tpop = [TPPO(obs_space, action_space, index=i, seed=i, device="cpu", **kw) for i in range(n)]
    for j, t in zip(jpop, tpop):
        _sync(j, t)
    fitness = np.random.default_rng(8).normal(size=(n, 2)).tolist()
    for pop in (jpop, tpop):
        for a, f in zip(pop, fitness):
            a.fitness = list(f)
    return jpop, tpop


def _ppo_summary(pop):
    return [(a.index, tuple(a.fitness), a.mut, a.lr, a.batch_size, a.learn_step, a.ent_coef,
             a.rollout_buffer.capacity, dataclasses.asdict(a.actor.config),
             dataclasses.asdict(a.critic.config)) for a in pop]


def test_ppo_tournament_and_mutation_match_jax():
    """Tournament, then two rounds of mutation drawing every class: the
    same elite, children, mut strings, configs and hyperparameters as the
    JAX package; after an architecture mutation every preserved slab equals
    the JAX package's bit for bit (grown slabs by shape); parameter noise
    touches ~10 % of the policy's entries with sd 0.1 and nothing else; the
    other mutations leave the weights as they were."""
    jpop, tpop = _ppo_populations()
    jt = JTournament(2, True, 4, 1, rng=np.random.default_rng(3))
    tt = TournamentSelection(2, True, 4, 1, rng=np.random.default_rng(3))
    np.random.seed(99)
    jelite, jnext = jt.select(jpop)
    np.random.seed(99)
    telite, tnext = tt.select(tpop)
    assert jelite.index == telite.index
    assert [(a.index, a.fitness) for a in jnext] == [(a.index, a.fitness) for a in tnext]
    kw = dict(no_mutation=0.1, architecture=0.4, new_layer_prob=0.3, parameters=0.25,
              activation=0.1, rl_hp=0.15, mutation_sd=0.1, rand_seed=5)
    jm, tm = JMutations(**kw), Mutations(**kw)
    seen = set()
    for _ in range(2):
        for j, t in zip(jnext, tnext):
            _sync(j, t)
        old = [{n: _np(getattr(j, n).params) for n in ("actor", "critic")} for j in jnext]
        jnext = jm.mutation(jnext)
        tnext = tm.mutation(tnext)
        assert _ppo_summary(tnext) == _ppo_summary(jnext)
        for before, j, t in zip(old, jnext, tnext):
            kind = ("param" if t.mut == "param" else
                    "arch" if "." in t.mut or "latent" in t.mut else "same")
            seen.add(kind)
            for name in ("actor", "critic"):
                b, jp, tp = before[name], _flat(getattr(j, name).params), \
                    _flat(getattr(t, name).params)
                b = _flat(b)
                assert jp.keys() == tp.keys()
                if kind == "param" and name == "actor":
                    diff = np.concatenate([(tp[p] - b[p]).ravel() for p in b])
                    frac = np.mean(diff != 0)
                    assert 0.06 < frac < 0.14, frac
                    assert 0.07 < diff[diff != 0].std() < 0.13
                    continue
                for p in jp:
                    assert jp[p].shape == tp[p].shape, p
                    if p in b and b[p].ndim == jp[p].ndim:
                        sl = tuple(slice(0, min(o, q)) for o, q in zip(b[p].shape, jp[p].shape))
                        np.testing.assert_array_equal(tp[p][sl], b[p][sl], err_msg=str(p))
                        np.testing.assert_array_equal(tp[p][sl], jp[p][sl], err_msg=str(p))
                    else:
                        assert kind == "arch", p
            # the optimizer follows the new shapes
            mu = t.optimizer.opt_state[1].inner_state[0].mu
            assert mu["actor"]["head"]["output"]["kernel"].shape == \
                t.actor.params["head"]["output"]["kernel"].shape
    assert seen == {"param", "arch", "same"}


def test_architecture_mutation_rolls_back_on_failure():
    _, tpop = _ppo_populations(1)
    agent = tpop[0]
    before = {n: _flat(getattr(agent, n).params) for n in ("actor", "critic")}
    opt = agent.optimizer.opt_state
    cfg = agent.actor.config

    def boom(*a, **k):
        raise RuntimeError("injected")

    agent.critic.apply_mutation = boom
    with pytest.warns(RuntimeWarning, match="rolled back"):
        Mutations(no_mutation=0, architecture=1, parameters=0, activation=0, rl_hp=0,
                  rand_seed=0).mutation([agent])
    assert agent.mut == "None" and agent.actor.config == cfg
    assert agent.optimizer.opt_state is opt
    for n in ("actor", "critic"):
        after = _flat(getattr(agent, n).params)
        assert after.keys() == before[n].keys()
        for p in after:
            np.testing.assert_array_equal(after[p], before[n][p])


def test_learn_step_mutation_resizes_the_rollout_buffer():
    """The port's repair of the JAX package's hpo/mutation.py:303-305 branch:
    a learn_step mutation gives the buffer the new horizon, reallocated at
    the next collect, in both packages."""
    from agilerl_tpu_torch.algorithms.core.registry import HyperparameterConfig, RLParameter
    from agilerl_tpu_torch.envs.classic import CartPole
    from agilerl_tpu_torch.envs.core import TorchVecEnv
    from agilerl_tpu_torch.rollouts.on_policy import collect_rollouts

    jpop, tpop = _ppo_populations(1)
    env = TorchVecEnv(CartPole(), 2, device="cpu")
    tagent = tpop[0]
    collect_rollouts(tagent, env)
    tagent.learn()
    assert tagent.rollout_buffer.state.data["obs"].shape[:2] == (16, 2)
    for agent, hp, M in ((jpop[0], JHyperparameterConfig, JMutations),
                         (tagent, HyperparameterConfig, Mutations)):
        agent.registry.hp_config = hp(learn_step=(JRLParameter if M is JMutations
                                                  else RLParameter)(min=8, max=64, dtype=int))
        M(no_mutation=0, architecture=0, parameters=0, activation=0, rl_hp=1,
          rand_seed=1).mutation([agent])
        assert agent.mut == "learn_step" and agent.learn_step != 16
        assert agent.rollout_buffer.capacity == agent.learn_step
        assert agent.rollout_buffer.state is None
    assert tagent.learn_step == jpop[0].learn_step
    collect_rollouts(tagent, env)
    assert np.isfinite(tagent.learn())
    assert tagent.rollout_buffer.state.data["obs"].shape[:2] == (tagent.learn_step, 2)
