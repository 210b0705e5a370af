"""The port's layout search (``agilerl_tpu_torch/parallel/layout_search.py``)
on a one-rank gloo group in the test process (``single_rank``; the four-rank
sweep over the default plans runs on the gloo ranks that
``tests/test_torch_sharded.py`` already spawns): the default candidates
come from ``register_default_plans(n)``, warm-up calls go untimed, args are
rebuilt per call under ``donate``, a failing candidate is recorded and
excluded, the telemetry (a ``StepTimeline`` per candidate, the events, the
best-time gauge), ``cache=`` raises, and the result classes against the JAX
module's on the same data."""

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.algorithms import grpo as TG
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.observability import MemorySink, MetricsRegistry
from agilerl_tpu_torch.parallel import plan as PL
from agilerl_tpu_torch.parallel.layout_search import (
    LayoutCandidate,
    LayoutSearchResult,
    search_layouts,
    sync_outputs,
)
from tests.torch_dist_harness import single_rank

torch.set_num_threads(1)

CFG = TM.GPTConfig(vocab_size=64, n_layer=1, n_head=2, n_kv_head=1, d_model=16,
                   max_seq_len=32, dtype=torch.float32)
KW = dict(pad_token_id=0, eos_token_id=1, batch_size=4, beta=0.05, lr=1e-3, group_size=2,
          max_output_tokens=4, lora_rank=2)


@pytest.fixture
def registry_restored():
    saved = dict(PL._REGISTRY)
    PL.clear_registry()
    yield
    PL._REGISTRY.clear()
    PL._REGISTRY.update(saved)


def _batch(seed=3, B=4, T=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, 63, size=(B, T)).astype(np.int64)
    lm = np.zeros((B, T - 1), np.float32)
    lm[:, T // 2:] = 1.0
    return ids, lm, rng.normal(size=(B // 2, 2)).astype(np.float32)


def _agent():
    return TG.GRPO(config=CFG, seed=0, device="cpu", **KW)


def test_default_candidates_rank_and_each_learn_equals_the_unplaced_one(registry_restored):
    """One device: the default candidates are ``register_default_plans(1)``;
    every call places a fresh agent (``donate``), so each candidate's learns
    equal the unplaced learn bit for bit on the one rank."""
    batch = _batch()
    want = _agent().learn(batch)
    seen, built = {}, []

    def args_for(plan, mesh):
        agent = _agent()
        agent.to_mesh(mesh=mesh, plan=plan)
        built.append(plan.name)
        return (agent,)

    def learn(agent):
        out = agent.learn(batch)
        seen.setdefault(agent.sharding_plan.name, []).append(out)
        return out

    sink = MemorySink()
    reg = MetricsRegistry(sink=sink)
    with single_rank():
        result = search_layouts(learn, (None,), args_for, device="cpu", warmup=1, steps=2,
                                donate=True, registry=reg)
    names = [p.name for p in PL.default_grpo_plans(1)]
    assert PL.registered_plans() == sorted(names)
    assert [c.plan.name for c in result.candidates] == names
    assert built == [n for n in names for _ in range(3)]  # rebuilt before every call
    for cand in result.candidates:
        assert cand.ok and len(cand.step_times_s) == 2
        assert cand.step_time_s == pytest.approx(np.mean(cand.step_times_s))
        assert (cand.cache_hit, cand.load_s, cand.compile_s, cand.fingerprint) == (None,) * 4
        assert seen[cand.plan.name] == [want] * 3
        hist = reg.histogram(f"layout_search/{cand.plan.name}/step_time_s")
        assert hist.count == 2  # the timed calls only: the first step arms the timer
    assert result.best is result.ranked[0]
    assert reg.gauge("layout_search/best_step_time_s").value == result.best.step_time_s
    kinds = [e["kind"] for e in sink.events]
    assert kinds.count("layout_search") == len(names) and kinds[-1] == "layout_search_summary"


def test_a_failing_candidate_is_recorded_and_excluded(registry_restored):
    good = PL.make_grpo_plan(name="good")
    bad = PL.make_grpo_plan(name="bad")

    def step(x):
        return x * 2

    def args_for(plan, mesh):
        if plan.name == "bad":
            raise ValueError("no layout for this shape")
        return (torch.ones(3),)

    with single_rank():
        result = search_layouts(step, (None,), args_for, plans=[bad, good], device="cpu",
                                warmup=0, steps=1, registry=MetricsRegistry())
    assert [c.plan.name for c in result.ranked] == ["good"]
    failed = result.candidates[0]
    assert not failed.ok and failed.error == "ValueError: no layout for this shape"
    assert result.to_dict()["candidates"][-1]["plan"] == "bad"


def test_plans_by_name_a_shared_mesh_and_placed_args(registry_restored):
    """Registered names resolve; ``mesh=`` serves every candidate (the
    plans' rules shaped to it); tensor args named by a group are placed."""
    plan = PL.register_plan(PL.make_grpo_plan(name="named", fsdp=1, tp=1))
    other = PL.ShardingPlan.from_yaml("configs/sharding/grpo_7b_fsdp16xtp4.yaml")
    placed = []

    def step(batch):
        placed.append(type(batch["ids"]).__name__)
        return batch["ids"] + 1

    with single_rank():
        mesh = PL.ShardingPlan("one", {"fsdp": 1}).build_mesh("cpu")
        result = search_layouts(step, ("batch",), ({"ids": torch.arange(4.0)},),
                                plans=["named", other], mesh=mesh, warmup=0, steps=1,
                                registry=MetricsRegistry())
    assert [c.ok for c in result.candidates] == [True, True]
    assert placed == ["DTensor", "DTensor"] and result.candidates[0].plan is plan


def test_refusals():
    with pytest.raises(NotImplementedError, match="eagerly"):
        search_layouts(lambda x: x, (None,), (1,), cache="/tmp/store")
    with pytest.raises(ValueError, match="at least one candidate"):
        search_layouts(lambda x: x, (None,), (1,), plans=[])


def test_sync_outputs_takes_host_values_and_cpu_tensors():
    sync_outputs((1.0, {"a": torch.ones(2)}, None, np.zeros(2)))


def test_result_classes_match_the_jax_module():
    pytest.importorskip("jax")
    from agilerl_tpu.parallel import layout_search as JLS

    class _Plan:
        def __init__(self, name):
            self.name = name

        def ordered_axes(self):
            return [("fsdp", 2), ("tp", 2)]

    def build(mod):
        cands = [mod.LayoutCandidate(plan=_Plan("slow"), step_times_s=[0.3, 0.5],
                                     step_time_s=0.4),
                 mod.LayoutCandidate(plan=_Plan("broken"), error="RuntimeError: x"),
                 mod.LayoutCandidate(plan=_Plan("fast"), step_times_s=[0.1], step_time_s=0.1)]
        return mod.LayoutSearchResult(cands)

    ours = build(__import__("agilerl_tpu_torch.parallel.layout_search", fromlist=["x"]))
    theirs = build(JLS)
    assert ours.to_dict() == theirs.to_dict()
    assert [c.plan.name for c in ours.ranked] == [c.plan.name for c in theirs.ranked]
    assert ours.best.plan.name == theirs.best.plan.name == "fast"
    assert isinstance(ours, LayoutSearchResult) and isinstance(ours.best, LayoutCandidate)
