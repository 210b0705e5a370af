"""Parity of the port's evolution (agilerl_tpu_torch.hpo, utils, training)
with the JAX package's, on the CPU: tournament selection and hyperparameter
mutation make the same picks and draw the same values from the same numpy
seeds, and finetune_llm_reasoning trains and evolves a population of two
tiny GRPO agents end to end."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms.grpo import GRPO as JGRPO  # noqa: E402
from agilerl_tpu.hpo import Mutations as JMutations  # noqa: E402
from agilerl_tpu.hpo import TournamentSelection as JTournament  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.utils.llm_utils import CharTokenizer as JCharTokenizer  # noqa: E402
from agilerl_tpu.utils.llm_utils import ReasoningGym as JReasoningGym  # noqa: E402
from agilerl_tpu.utils.rng import derive_rng as j_derive_rng  # noqa: E402
from agilerl_tpu_torch.algorithms.grpo import GRPO as TGRPO  # noqa: E402
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
