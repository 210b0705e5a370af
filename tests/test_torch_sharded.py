"""The port's sharding plans at work, on 4 gloo ranks on the CPU
(``tests/torch_dist_harness.py``; one pool of ranks for the module): the
placed GRPO learn against the port's unplaced learn and the JAX package's
sharded learn (``tests/test_parallel/test_mesh.py:27``,
``test_plan.py:268``), the plan-compiled flywheel step (``:303``), the
sharding mutation (``:435``), pod generation against the port's vmapped
generation and the JAX member layout (``:499``), and a plan-placed
``BucketedGenerator`` (``:593``). On CPU tensors the flash and fused calls
inside ``local_map`` run their plain versions."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.algorithms import grpo as JG  # noqa: E402
from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.parallel import plan as JPL  # noqa: E402
from agilerl_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from agilerl_tpu_torch.algorithms import grpo as TG  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.parallel import plan as TPL  # noqa: E402
from tests.torch_dist_harness import RankPool  # noqa: E402

torch.set_num_threads(1)

CFG_KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=64)
KW = dict(pad_token_id=0, eos_token_id=1, batch_size=8, beta=0.05, lr=1e-3, group_size=2,
          max_output_tokens=5, lora_rank=4)
AXES = {"fsdp2xtp2": dict(fsdp=2, tp=2), "fsdp4": dict(fsdp=4)}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_agent():
    """The JAX agent of the comparison: non-zero B in both adapters."""
    jcfg = JM.GPTConfig(dtype=jnp.float32, **CFG_KW)
    jagent = JG.GRPO(config=jcfg, seed=0, bucketed_decode=False, **KW)
    rng = np.random.default_rng(1)
    actor, reference = _np_tree(jagent.actor.params), _np_tree(jagent.reference.params)
    for tree, sd in ((actor, 0.05), (reference, 0.03)):
        for layer in tree["blocks"].values():
            for ab in layer.values():
                ab["B"] = rng.normal(0, sd, ab["B"].shape).astype(np.float32)
    jagent.actor.params = jax.tree_util.tree_map(jnp.asarray, actor)
    jagent.reference.params = jax.tree_util.tree_map(jnp.asarray, reference)
    jagent.optimizer.init(jagent.actor.params)
    return jagent, _np_tree(jagent.base_params), actor, reference


def _learn_batch(seed=2, B=8, T=24):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 127, size=(B, T)).astype(np.int64)
    ids[3, T - 4:] = 0  # a right-padded row
    lm = np.zeros((B, T - 1), np.float32)
    lm[:, T // 2:] = (ids[:, T // 2 + 1:] != 0)
    rewards = rng.normal(size=(B // 2, 2)).astype(np.float32)
    return ids, lm, rewards


def _port_agent(base, actor, reference):
    cfg = TM.GPTConfig(dtype=torch.float32, **CFG_KW)
    agent = TG.GRPO(config=cfg, seed=0, device="cpu",
                    base_params=params_from_numpy(base, cfg, device="cpu"), **KW)
    agent.actor.params = lora_from_numpy(actor, device="cpu")
    agent.reference.params = lora_from_numpy(reference, device="cpu")
    agent.optimizer.init(agent.actor.params)
    return agent


def _adapters_close(got, want, atol):
    for i, layer in want["blocks"].items():
        for t, ab in layer.items():
            for name in ("A", "B"):
                np.testing.assert_allclose(got["blocks"][i][t][name], np.asarray(ab[name]),
                                           rtol=0, atol=atol)


@pytest.mark.parametrize("layout", sorted(AXES))
def test_to_mesh_learn_matches_unplaced_and_jax_sharded_learn(pool, layout):
    """Two learns after ``to_mesh``: losses at rtol 1e-5 and adapters at atol
    5e-6 (the port-vs-JAX bounds of ``test_torch_grpo.py``) against the
    port's unplaced learns and the JAX learns after its ``to_mesh`` on the
    8-device fsdp4 x tp2 mesh; adapters and Adam moments bit-identical
    across the ranks; the plan's placements on the trees."""
    jagent, base, actor, reference = _jax_agent()
    batch = _learn_batch()
    jagent.to_mesh(j_make_mesh(dp=1, fsdp=4, tp=2))
    with jagent.mesh:
        jlosses = [jagent.learn(tuple(jnp.asarray(x) for x in batch)) for _ in range(2)]
    tagent = _port_agent(base, actor, reference)
    tlosses = [tagent.learn(batch) for _ in range(2)]
    res = pool.run("grpo_learn", cfg_kw=CFG_KW, base=base, actor=actor, reference=reference,
                   batch=batch, kw=KW, axes=AXES[layout], learns=2)
    for r in res:
        np.testing.assert_allclose(np.asarray(r["losses"]), np.asarray(tlosses),
                                   rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(np.asarray(r["losses"]), np.asarray(jlosses),
                                   rtol=1e-5, atol=1e-8)
        _adapters_close(r["actor"], TG.tree_to_numpy(tagent.actor.params), 5e-6)
        _adapters_close(r["actor"], _np_tree(jagent.actor.params), 5e-6)
    for r in res[1:]:
        for a, b in zip(jax.tree_util.tree_leaves(r["actor"]),
                        jax.tree_util.tree_leaves(res[0]["actor"])):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(jax.tree_util.tree_leaves(r["adam"]),
                        jax.tree_util.tree_leaves(res[0]["adam"])):
            np.testing.assert_array_equal(a, b)
    pl = res[0]["placements"]["blocks/0/wq/A"]
    bpl = res[0]["base_placements"]["blocks/0/wq"]
    if layout == "fsdp2xtp2":  # mesh dims (fsdp, tp)
        assert pl == "(Shard(dim=0), Replicate())"
        assert bpl == "(Shard(dim=0), Shard(dim=1))"
        assert res[0]["placements"]["blocks/0/wq/B"] == "(Replicate(), Shard(dim=1))"
    else:
        assert pl == "(Shard(dim=0),)" and bpl == "(Shard(dim=0),)"


def test_plan_step_matches_jax_update(pool):
    """``compile_step_with_plan`` (eager, placing each argument by its group)
    on a fixed batch against the JAX ``make_update_fn`` on the same
    weights: loss and KL at rtol 1e-5, adapters at atol 5e-6; ``lower``
    raises, ``abstract_args`` carries the placements."""
    from agilerl_tpu.algorithms.core.optimizer import OptimizerWrapper as JOpt

    jagent, base, actor, reference = _jax_agent()
    rng = np.random.default_rng(0)
    B, T = 8, 24
    lm = np.zeros((B, T - 1), np.float32)
    lm[:, T // 2:] = 1.0
    batch = {"tokens": rng.integers(2, 127, size=(B, T)).astype(np.int64),
             "mask": np.ones((B, T), np.int32), "loss_mask": lm,
             "old_lp": np.full((B, T - 1), -4.0, np.float32),
             "ref_lp": np.full((B, T - 1), -4.2, np.float32),
             "advantage": rng.normal(size=(B,)).astype(np.float32)}
    jopt = JOpt(optimizer="adamw", lr=5e-6, max_grad_norm=0.1)
    jopt.init(jagent.actor.params)
    update = JG.make_update_fn(jagent.model_config, jopt.tx, lora_scale=2.0, use_flash=False)
    j_lora, _, j_loss, j_kl = update(jagent.base_params, jagent.actor.params, jopt.opt_state,
                                     {k: jnp.asarray(v) for k, v in batch.items()},
                                     jnp.float32(0.2), jnp.float32(0.04))
    res = pool.run("plan_step", cfg_kw=CFG_KW, base=base, lora=actor, batch=batch,
                   axes=dict(fsdp=2, tp=2))
    for r in res:
        np.testing.assert_allclose(r["loss"], float(j_loss), rtol=1e-5)
        np.testing.assert_allclose(r["kl"], float(j_kl), rtol=1e-5)
        _adapters_close(r["lora"], _np_tree(j_lora), 5e-6)
        assert r["placements"]["blocks/0/wq/A"] == "(Shard(dim=0), Replicate())"
        assert r["abstract_wq"] == "(Shard(dim=0), Shard(dim=1))"
    plan = TPL.make_grpo_plan(fsdp=2, tp=2)
    step = TPL.PlanCompiledStep(lambda x: x, plan, None, ("batch",))
    with pytest.raises(NotImplementedError):
        step.lower({})
    with pytest.raises(NotImplementedError):
        TPL.compile_step_with_plan(lambda x: x, plan, ("batch",), mesh=object(), cache="dir")


def test_flywheel_step_anchor_and_single_correction(pool):
    """At staleness 0 the flywheel step equals the sharded GRPO step with
    the on-policy anchor; a record uniformly 0.5 nats behind scales the
    beta=0 loss by exactly exp(0.5) (the JAX test's check); an agent
    already placed keeps its learn functions."""
    jagent, base, actor, reference = _jax_agent()
    rng = np.random.default_rng(0)
    B, T = 8, 24
    lm = np.zeros((B, T - 1), np.float32)
    lm[:, T // 2:] = 1.0
    batch = {"tokens": rng.integers(2, 127, size=(B, T)).astype(np.int64),
             "mask": np.ones((B, T), np.int32), "loss_mask": lm,
             "old_lp": np.zeros((B, T - 1), np.float32),
             "ref_lp": np.zeros((B, T - 1), np.float32),
             "advantage": rng.normal(size=(B,)).astype(np.float32)}
    res = pool.run("flywheel_step", cfg_kw=CFG_KW, base=base, actor=actor,
                   reference=reference, batch=batch, kw=KW, axes=dict(fsdp=2, tp=2))
    for r in res:
        np.testing.assert_allclose(r["f"][0], r["r"][0], rtol=1e-6)
        np.testing.assert_allclose(r["f"][1], r["r"][1], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(r["s"], float(np.exp(0.5)) * r["r"][0], rtol=1e-5)
        assert r["kept"]


def test_sharding_mutation_swaps_plans_without_fitness_change(pool):
    """A pop of two agents on ``grpo-fsdp4`` mutated to ``grpo-fsdp2xtp2``
    (the registry's default plans for 4 ranks, isolated per case): the
    same batch gives the same loss across layouts."""
    jagent, base, actor, reference = _jax_agent()
    batch = _learn_batch()
    res = pool.run("sharding_mutation", cfg_kw=CFG_KW, base=base, actor=actor,
                   reference=reference, batch=batch, kw=KW,
                   plans=["grpo-fsdp4", "grpo-fsdp2xtp2"])
    for r in res:
        assert r["muts"] == ["sharding:grpo-fsdp2xtp2"] * 2
        assert r["plans"] == ["grpo-fsdp2xtp2"] * 2
        assert {"grpo-fsdp4", "grpo-fsdp2xtp2", "grpo-tp4"} <= set(r["registered"])
        np.testing.assert_allclose(r["after"][0], r["after"][1], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(r["before"][0], r["before"][1], rtol=1e-4, atol=1e-6)
    assert TPL.registered_plans() == []  # the parent's registry is untouched


def test_pod_generation_matches_vmap_generation_and_jax_layout(pool):
    """EvoPPO at pop 8 over 4 ranks (2 members each) through
    ``ScanRun(plan=make_population_plan(4))`` for two generations: the
    fitness and every member's leaves equal the port's vmapped
    ``ScanRun`` (rtol 1e-6: a member's batched products run at another row
    count); the member layout resolves as the JAX plan's on the JAX
    population."""
    from agilerl_tpu_torch.parallel.generation import ScanRun, population_state_dict
    from tests.torch_dist_cases import evoppo

    res = pool.run("pod_generation", axis_size=4, pop=8, generations=2)
    ref = ScanRun(evoppo(), 8, seed=0)
    fit = ref.run(2)
    leaves = population_state_dict(ref.pop)["leaves"]
    for r in res:
        np.testing.assert_allclose(r["fitness"], fit, rtol=1e-6, atol=1e-6)
    for i, want in enumerate(leaves):
        if np.ndim(want) == 0:
            continue
        got = np.concatenate([r["pop"][i] for r in res])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    tree = {"actor": {"w": np.zeros((8, 3))}, "step": np.zeros((8,))}
    jspecs = JPL.make_population_plan(pop=8).resolve("member", tree)
    tspecs = TPL.make_population_plan(pop=8).resolve("member", tree)
    assert tuple(tspecs["actor"]["w"]) == tuple(jspecs["actor"]["w"]) == ("pop",)


def test_bucketed_generator_with_plan_matches_unsharded(pool):
    """Weights placed by the plan's ``params`` rules (gathered whole where
    the decode uses them) give the greedy tokens of the unsharded port
    generator and of the JAX one; the plan's ``kv`` rules resolve the JAX
    layout of the generator's cache."""
    from agilerl_tpu.llm.serving import BucketedGenerator as JBG
    from agilerl_tpu_torch.llm.serving import BucketedGenerator

    kw = dict(CFG_KW, d_model=64, max_seq_len=128)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **kw)
    params = _np_tree(JM.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    seqs = [rng.integers(2, 127, size=rng.integers(4, 16)).astype(np.int64) for _ in range(5)]
    gkw = dict(max_new_tokens=8, pad_id=0, eos_id=None, prompt_buckets=(16,), row_buckets=(8,),
               decode_chunk=8)
    jout, jmask, _ = JBG(jcfg, **gkw).generate([s.astype(np.int32) for s in seqs],
                                               jax.random.PRNGKey(1),
                                               jax.tree_util.tree_map(jnp.asarray, params),
                                               greedy=True)
    tcfg = TM.GPTConfig(dtype=torch.float32, **kw)
    tout, tmask, _ = BucketedGenerator(tcfg, device="cpu", **gkw).generate(
        seqs, 1, params_from_numpy(params, tcfg, device="cpu"), greedy=True)
    np.testing.assert_array_equal(np.asarray(tout), np.asarray(jout))
    res = pool.run("bucketed_generate", cfg_kw=kw, params=params, seqs=seqs,
                   axes=dict(fsdp=2, tp=2))
    for r in res:
        np.testing.assert_array_equal(r["out"], np.asarray(tout))
        np.testing.assert_array_equal(r["mask"], np.asarray(tmask))
        assert r["wq"] == "(Shard(dim=0), Shard(dim=1))"
        assert r["kv_k"] == (None, ("fsdp",), None, "tp", None)
