"""Parity of the port's DPO path (agilerl_tpu_torch: PreferenceGym, DPO and
finetune_llm_preference) with the JAX package's, on the CPU in f32. On CPU
tensors the port's update runs the plain versions of its flash and fused
kernels, forward and backward; the JAX package's CPU update takes its dense
attention and chunked log-softmax, so the two agree to f32 summation order."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms.dpo import DPO as JDPO  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.utils.llm_utils import CharTokenizer as JCharTokenizer  # noqa: E402
from agilerl_tpu.utils.llm_utils import PreferenceGym as JPreferenceGym  # noqa: E402
from agilerl_tpu_torch.algorithms.dpo import DPO  # noqa: E402
from agilerl_tpu_torch.hpo import Mutations, TournamentSelection  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.training.train_llm import finetune_llm_preference  # noqa: E402
from agilerl_tpu_torch.utils.llm_utils import CharTokenizer, PreferenceGym  # noqa: E402
from agilerl_tpu_torch.utils.utils import create_population  # noqa: E402

torch.set_num_threads(1)

TOK = CharTokenizer()
KW = dict(vocab_size=TOK.vocab_size, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
          max_seq_len=64)
JCFG = JM.GPTConfig(dtype=jnp.float32, **KW)
TCFG = TM.GPTConfig(dtype=torch.float32, **KW)


def _rows(n, seed):
    """Preference rows of ragged prompt and completion lengths."""
    rng = np.random.default_rng(seed)
    rows = []
    for a, b in rng.integers(0, 30, (n, 2)):
        rows.append({"prompt": f"{a}+{b}=", "chosen": str(a + b), "rejected": str(a * b % 97)})
    return rows


def _gyms(max_completion_length=None, batch=3):
    kw = dict(data_batch_size=batch, seed=4, max_completion_length=max_completion_length)
    return (JPreferenceGym(_rows(8, 0), _rows(5, 1), JCharTokenizer(), **kw),
            PreferenceGym(_rows(8, 0), _rows(5, 1), TOK, **kw))


@pytest.mark.parametrize("max_completion_length", [None, 2])
def test_preference_gym_matches_jax(max_completion_length):
    """reset() across an epoch boundary (the reshuffle draws too) and the
    whole eval split: every array equal, dtypes included."""
    jenv, tenv = _gyms(max_completion_length)
    for _ in range(4):
        jb, tb = jenv.reset(), tenv.reset()
        assert list(tb) == list(jb)
        for k in jb:
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k])
    assert tenv.num_epochs == jenv.num_epochs >= 1
    jev, tev = list(jenv.eval_batches()), list(tenv.eval_batches())
    assert len(tev) == len(jev) == 2
    for jb, tb in zip(jev, tev):
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
    lm = tev[0]["chosen_loss_mask"]
    assert lm.shape[1] == tev[0]["chosen_ids"].shape[1] - 1 and lm.sum() > 0


def _agents(label_smoothing):
    kw = dict(pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id, lr=1e-3, beta=0.5,
              label_smoothing=label_smoothing, lora_rank=4, lora_scale=1.5)
    jagent = JDPO(config=JCFG, seed=0, bucketed_decode=False, **kw)
    rng = np.random.default_rng(1)
    actor = jax.tree_util.tree_map(np.asarray, jagent.actor.params)
    reference = jax.tree_util.tree_map(np.asarray, jagent.reference.params)
    for tree, sd in ((actor, 0.2), (reference, 0.2)):  # non-zero B: both adapters matter
        for layer in tree["blocks"].values():
            for ab in layer.values():
                ab["B"] = rng.normal(0, sd, ab["B"].shape).astype(np.float32)
    jagent.actor.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.reference.params = jax.tree_util.tree_map(jnp.asarray, reference)
    jagent.optimizer.init(jagent.actor.params)
    base = params_from_numpy(jax.tree_util.tree_map(np.asarray, jagent.base_params), TCFG,
                             device="cpu")
    tagent = DPO(config=TCFG, seed=0, device="cpu", base_params=base, **kw)
    tagent.actor.params = lora_from_numpy(actor, device="cpu")
    tagent.reference.params = lora_from_numpy(reference, device="cpu")
    tagent.optimizer.init(tagent.actor.params)
    return jagent, tagent, actor


@pytest.mark.parametrize("label_smoothing", [0.0, 0.2])
def test_dpo_learn_and_test_match_jax(label_smoothing):
    """One learn on the same weights, adapters and batch: loss and accuracy
    at rtol 1e-5, the adapter after the step at atol 5e-6 (AdamW's first step
    is ~lr per entry, as in test_torch_grpo's learn test); then test()'s
    fitness over the eval split, exactly. Training leaves lora_scale at 2.0
    and test() uses the agent's 1.5, in both packages."""
    jagent, tagent, actor = _agents(label_smoothing)
    _, tenv = _gyms(batch=8)
    batch = tenv.reset()
    jloss, jacc = jagent.learn(batch)
    tloss, tacc = tagent.learn(batch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(tacc, jacc, rtol=1e-5)
    assert 0.0 < jacc < 1.0  # both outcomes occur in the batch
    after = jax.tree_util.tree_map(np.asarray, jagent.actor.params)
    moved = 0.0
    for i, layer in after["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                got = tagent.actor.params["blocks"][i][t][name].numpy()
                np.testing.assert_allclose(got, ab[name], rtol=0, atol=5e-6)
                moved = max(moved, np.abs(ab[name] - actor["blocks"][i][t][name]).max())
    assert moved > 5e-4
    jenv, tenv = _gyms(batch=8)  # the 5 eval rows in one batch
    assert tagent.test(tenv) == jagent.test(jenv)
    assert tagent.fitness == jagent.fitness


def test_dpo_init_dict_and_clone():
    _, tagent, _ = _agents(0.1)
    assert tagent.init_dict["label_smoothing"] == 0.1
    assert tagent.hp_config.names() == ["lr", "beta"]
    clone = tagent.clone(index=3)
    assert isinstance(clone, DPO) and clone.label_smoothing == 0.1 and clone.index == 3
    assert torch.equal(clone.reference.params["blocks"]["0"]["wq"]["B"],
                       tagent.reference.params["blocks"]["0"]["wq"]["B"])


def test_dpo_non_finite_loss_raises():
    _, tagent, _ = _agents(0.0)
    _, tenv = _gyms()
    tagent.beta = float("nan")
    before = tagent.actor.params["blocks"]["0"]["wq"]["B"].clone()
    with pytest.raises(RuntimeError, match="Non-finite DPO loss"):
        tagent.learn(tenv.reset())
    assert torch.equal(tagent.actor.params["blocks"]["0"]["wq"]["B"], before)


def test_finetune_llm_preference_evolves_a_population(tmp_path):
    """2 steps of a population of 2 (data batch 3 over 5 rows, so step 2
    starts a new epoch and refreshes the reference); the eval at step 2 runs
    one tournament and one mutation round. Then each hook of the loop runs
    (telemetry=, resilience=, wb=True, resume, save_elite): wandb does not
    import here, so wb=True logs to the sink only, as the JAX loop does."""
    env = PreferenceGym(_rows(5, 0), _rows(5, 1), TOK, data_batch_size=3)
    cfg = TM.GPTConfig(dtype=torch.float32, **dict(KW, n_layer=1, d_model=32, n_head=2))
    pop = create_population("DPO", population_size=2, seed=3, device="cpu", config=cfg,
                            pad_token_id=TOK.pad_token_id, eos_token_id=TOK.eos_token_id,
                            lora_rank=2, INIT_HP={"LR": 1e-3})
    pop[1].base_params = pop[0].base_params
    assert all(isinstance(a, DPO) for a in pop) and [a.lr for a in pop] == [1e-3, 1e-3]
    before = [a.actor.params["blocks"]["0"]["wq"]["B"].clone() for a in pop]
    tournament = TournamentSelection(2, True, 2, 1, rng=np.random.default_rng(0))
    mutation = Mutations(no_mutation=0.5, architecture=0.0, parameters=0.0, activation=0.0,
                         rl_hp=0.5, rand_seed=0)
    new_pop, fitnesses = finetune_llm_preference(pop, env, max_steps=2, evaluation_interval=2,
                                                 verbose=False, tournament=tournament,
                                                 mutation=mutation)
    assert len(new_pop) == 2 and all(len(f) == 1 for f in fitnesses)
    assert all(0.0 <= f[0] <= 1.0 for f in fitnesses)
    assert [a.fitness[-1] for a in pop] == [f[0] for f in fitnesses]
    assert max(a.index for a in new_pop) == 2  # the tournament winner was cloned
    assert all(a.mut in ("None", "lr", "beta", "group_size") for a in new_pop)
    assert all(a.steps[-1] == 2 * 3 for a in pop)  # 2 steps x 3 pairs
    assert all(a._reference_epoch == env.num_epochs == 1 for a in pop)
    assert all(not torch.equal(a.actor.params["blocks"]["0"]["wq"]["B"], b)
               for a, b in zip(pop, before))
    from agilerl_tpu_torch.observability import RunTelemetry
    from agilerl_tpu_torch.resilience import Resilience

    values = {"telemetry": RunTelemetry(),
              "resilience": Resilience(tmp_path / "snap", save_every=1, handle_signals=False),
              "wb": True, "resume": True, "save_elite": True}
    for hook in ("telemetry", "resilience", "wb", "resume", "save_elite"):
        _, fit = finetune_llm_preference(pop, env, max_steps=1, verbose=False,
                                         **{hook: values[hook]})
        assert fit == [[], []]
    assert [s.step for s in values["resilience"].manager.snapshots()] == [1]
