"""The port's sharding-plan engine (``agilerl_tpu_torch/parallel/plan.py``,
``tree_paths.py``, ``mesh.py``) against the JAX package's, in one process on
the CPU. Each test names its JAX counterpart in
``tests/test_parallel/test_plan.py`` (or ``test_mesh.py``). The port's trees
are built on the meta device (shapes only): a llama3-8b tree costs nothing.
Multi-rank placement runs in ``test_torch_sharded.py``."""

import math
import os

import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.llm.presets import preset as j_preset  # noqa: E402
from agilerl_tpu.llm.presets import preset_names  # noqa: E402
from agilerl_tpu.parallel import plan as JPL  # noqa: E402
from agilerl_tpu.parallel import tree_paths as JTP  # noqa: E402
from agilerl_tpu_torch.algorithms.core.optimizer import OptimizerWrapper  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.presets import preset as t_preset  # noqa: E402
from agilerl_tpu_torch.parallel import mesh as TMESH  # noqa: E402
from agilerl_tpu_torch.parallel import plan as TPL  # noqa: E402
from agilerl_tpu_torch.parallel import tree_paths as TTP  # noqa: E402

SHARDING_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, "configs",
                            "sharding")
YAMLS = ["grpo_7b_fsdp16xtp4.yaml", "grpo_7b_dp2xfsdp8xtp4.yaml", "grpo_test_fsdp4xtp2.yaml"]
KW = dict(vocab_size=128, n_layer=2, n_head=4, n_kv_head=2, d_model=32, max_seq_len=32)


class FakeMesh:
    """The two attributes the resolver reads from a ``DeviceMesh``."""

    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


@pytest.fixture
def registry():
    """An empty plan registry for the test, restored after it."""
    saved = dict(TPL._REGISTRY)
    TPL.clear_registry()
    yield
    TPL.clear_registry()
    TPL._REGISTRY.update(saved)


def _flat_specs(specs, is_port):
    out = {}
    if is_port:
        TTP.named_tree_map(lambda n, s: out.__setitem__(n, tuple(s)), specs,
                           is_leaf=lambda x: isinstance(x, TPL.PartitionSpec))
    else:
        JTP.named_tree_map(lambda n, s: out.__setitem__(n, tuple(s)), specs,
                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return out


def _j_shapes(cfg):
    return jax.eval_shape(lambda k: JM.init_params(k, cfg), jax.random.PRNGKey(0))


def _t_meta(cfg):
    return TM.init_params(0, cfg, device="meta")


# --------------------------------------------------------------------------- #
# tree paths
# --------------------------------------------------------------------------- #


def test_tree_paths_match_jax_key_paths():
    """``tree_paths`` over params, a NamedTuple cache and an optimizer state
    renders the JAX key paths' names."""
    jcfg = JM.GPTConfig(dtype=jnp.float32, **KW)
    tcfg = TM.GPTConfig(dtype=torch.float32, **KW)
    # the JAX flatten visits dict keys sorted; the port visits them in order
    assert sorted(TTP.tree_paths(_t_meta(tcfg))) == sorted(JTP.tree_paths(_j_shapes(jcfg)))
    tcache = TM.init_caches(tcfg, 2, 8, device="meta")
    jcache = JM.init_caches(jcfg, 2, 8)
    assert sorted(TTP.tree_paths(tcache)) == sorted(JTP.tree_paths(jcache))
    lora = TM.init_lora(0, tcfg, 4, device="cpu")
    opt = OptimizerWrapper(optimizer="adamw", lr=5e-6, max_grad_norm=0.1)
    opt.init(lora)
    paths = TTP.tree_paths(opt.opt_state)
    assert "1/inner_state/0/mu/blocks/0/wq/A" in paths
    assert TTP.tree_path_to_string(("a", "b"), sep=None) == ("a", "b")


# --------------------------------------------------------------------------- #
# rule resolution (test_plan.py:76-131)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", preset_names())
def test_params_specs_match_jax_for_every_preset(name):
    """``test_plan_params_specs_match_handbuilt_for_every_preset``: the port's
    meta-device tree resolves to the JAX specs, leaf for leaf."""
    got = TPL.make_grpo_plan(fsdp=4, tp=2).resolve(
        "params", _t_meta(t_preset(name, max_seq_len=128)))
    want = JPL.make_grpo_plan(fsdp=4, tp=2).resolve(
        "params", _j_shapes(j_preset(name, max_seq_len=128)))
    assert _flat_specs(got, True) == _flat_specs(want, False)


def test_params_specs_match_jax_moe():
    """``test_plan_params_specs_match_handbuilt_moe``: interleaved MoE layers
    hit the ep rules by the rank guard."""
    kw = dict(KW, n_layer=4, moe_every=2, n_experts=4)
    got = TPL.make_grpo_plan(fsdp=4, tp=2).resolve(
        "params", _t_meta(TM.GPTConfig(dtype=torch.float32, **kw)))
    want = JPL.make_grpo_plan(fsdp=4, tp=2).resolve(
        "params", _j_shapes(JM.GPTConfig(dtype=jnp.float32, **kw)))
    flat = _flat_specs(got, True)
    assert flat == _flat_specs(want, False)
    assert flat["blocks/1/w_gate"] == ("ep", "fsdp", "tp")
    assert flat["blocks/0/w_gate"] == ("fsdp", "tp")
    assert TMESH.gpt_param_specs(TM.GPTConfig(dtype=torch.float32, **kw))["blocks"]["1"][
        "w_down"] == ("ep", "tp", "fsdp")


def test_lora_specs_match_jax():
    """``test_plan_lora_specs_match_legacy``: A over fsdp, B over tp, with
    the explicit trailing None."""
    tl = TM.init_lora(0, TM.GPTConfig(dtype=torch.float32, **KW), 8, device="meta")
    jl = jax.eval_shape(lambda k: JM.init_lora(k, JM.GPTConfig(dtype=jnp.float32, **KW), 8),
                        jax.random.PRNGKey(0))
    got = _flat_specs(TPL.make_grpo_plan(fsdp=4, tp=2).resolve("lora", tl), True)
    assert got == _flat_specs(JPL.make_grpo_plan(fsdp=4, tp=2).resolve("lora", jl), False)
    assert got["blocks/0/wq/A"] == ("fsdp", None) and got["blocks/1/wv/B"] == (None, "tp")
    assert _flat_specs(TMESH.lora_specs(tl), True) == got


def test_optimizer_rules_shard_moments_like_params():
    """``test_optimizer_rules_shard_moments_like_params``: Adam moments take
    their adapter's spec through the embedded path; counts and the
    injected learning rate replicate."""
    lora = TM.init_lora(0, TM.GPTConfig(dtype=torch.float32, **KW), 8, device="cpu")
    opt = OptimizerWrapper(optimizer="adamw", lr=5e-6, max_grad_norm=0.1)
    opt.init(lora)
    flat = _flat_specs(TPL.make_grpo_plan(fsdp=4, tp=2).resolve("optimizer", opt.opt_state),
                       True)
    moments = [n for n in flat if n.endswith("/A")]
    assert moments and all(flat[n] == ("fsdp", None) for n in moments)
    assert all(flat[n] == (None, "tp") for n in flat if n.endswith("/B"))
    assert flat["1/hyperparams/learning_rate"] == ()


# --------------------------------------------------------------------------- #
# matcher semantics (test_plan.py:140-186)
# --------------------------------------------------------------------------- #


def test_strict_mode_raises_on_unmatched_leaf():
    with pytest.raises(TPL.UnmatchedLeafError) as ei:
        TPL.match_partition_rules([(r"(^|/)weight$", TPL.P("fsdp"))],
                                  {"weight": torch.zeros(8, 8), "mystery": torch.zeros(4, 4)},
                                  strict=True)
    assert "mystery" in str(ei.value)


def test_scalar_fast_path_skips_rules():
    specs = TPL.match_partition_rules(
        [(r".*", TPL.P("fsdp"))],
        {"s": torch.zeros(()), "one": torch.zeros(1), "v": torch.zeros(8), "n": 3})
    assert tuple(specs["s"]) == () and tuple(specs["one"]) == () and tuple(specs["n"]) == ()
    assert tuple(specs["v"]) == ("fsdp",)


def test_rank_guard_orders_moe_vs_dense_rules():
    rules = [(r"(^|/)w_gate$", TPL.P("ep", "fsdp", "tp")),
             (r"(^|/)w_gate$", TPL.P("fsdp", "tp"))]
    specs = TPL.match_partition_rules(
        rules, {"moe": {"w_gate": torch.zeros(4, 8, 8)}, "dense": {"w_gate": torch.zeros(8, 8)}})
    assert tuple(specs["moe"]["w_gate"]) == ("ep", "fsdp", "tp")
    assert tuple(specs["dense"]["w_gate"]) == ("fsdp", "tp")


def test_non_strict_unmatched_replicates_and_warns_once():
    import warnings

    plan = TPL.make_grpo_plan(name="warn-once-case", fsdp=4, tp=2)
    tree = {"unmatched_leaf_name": torch.zeros(8, 8)}
    with pytest.warns(RuntimeWarning, match="unmatched_leaf_name"):
        specs = plan.resolve("params", tree, strict=False)
    assert tuple(specs["unmatched_leaf_name"]) == ()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        plan.resolve("params", tree, strict=False)  # first occurrence only


# --------------------------------------------------------------------------- #
# YAML (test_plan.py:189-261)
# --------------------------------------------------------------------------- #


def test_yaml_round_trip(tmp_path):
    plan = TPL.make_grpo_plan(name="rt", dp=2, fsdp=2, tp=2, dcn_dp=2, strict=True,
                              description="round trip")
    path = str(tmp_path / "rt.yaml")
    plan.to_yaml(path)
    loaded = TPL.ShardingPlan.from_yaml(path)
    assert loaded.to_dict() == plan.to_dict()
    assert loaded.to_dict() == JPL.make_grpo_plan(
        name="rt", dp=2, fsdp=2, tp=2, dcn_dp=2, strict=True,
        description="round trip").to_dict()
    assert tuple(loaded.resolve("batch", {"tokens": torch.zeros(8, 16)})["tokens"]) == \
        (("dp", "fsdp"),)
    # and the JAX package reads the port's file
    assert JPL.ShardingPlan.from_yaml(path).to_dict() == plan.to_dict()


@pytest.mark.parametrize("fname", YAMLS)
def test_committed_yaml_plans_load_unchanged(fname):
    """``test_committed_yaml_plans_round_trip``: each committed plan loads to
    the JAX plan's dict; the two 7B plans resolve the port's meta-device
    llama3-8b tree strictly, to the JAX specs."""
    path = os.path.join(SHARDING_DIR, fname)
    plan = TPL.ShardingPlan.from_yaml(path)
    assert plan.to_dict() == JPL.ShardingPlan.from_yaml(path).to_dict()
    assert plan.to_dict() == TPL.ShardingPlan.from_dict(plan.to_dict()).to_dict()
    assert plan.rules.keys() >= {"params", "lora", "optimizer", "batch", "kv"}
    if "7b" in fname:
        got = plan.resolve("params", _t_meta(t_preset("llama3-8b", max_seq_len=128)),
                           strict=True)
        want = JPL.ShardingPlan.from_yaml(path).resolve(
            "params", _j_shapes(j_preset("llama3-8b", max_seq_len=128)), strict=True)
        assert _flat_specs(got, True) == _flat_specs(want, False)


def test_7b_plan_degrades_to_smaller_meshes():
    """``test_7b_plan_degrades_to_8_device_mesh``: on an fsdp4 x tp2 mesh the
    7B plan's wq keeps (fsdp, tp); axes absent from the mesh, or of size 1,
    drop (an sp-only mesh replicates everything; one card replicates)."""
    plan = TPL.ShardingPlan.from_yaml(os.path.join(SHARDING_DIR, "grpo_7b_fsdp16xtp4.yaml"))
    params = _t_meta(TM.GPTConfig(dtype=torch.float32, **KW))
    specs = plan.resolve("params", params, mesh=FakeMesh(fsdp=4, tp=2))
    assert tuple(specs["blocks"]["0"]["wq"]) == ("fsdp", "tp")
    for mesh in (FakeMesh(sp=8), FakeMesh(dp=1, fsdp=1, tp=1)):
        flat = _flat_specs(plan.resolve("params", params, mesh=mesh), True)
        assert all(set(s) <= {None} for s in flat.values())
    assert tuple(TMESH.filter_spec(TPL.P(("dp", "fsdp"), "tp"), FakeMesh(dp=1, fsdp=2, tp=2))) \
        == (("fsdp",), "tp")


def test_spec_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(fsdp=2, tp=2)
    assert TPL.spec_to_placements(TPL.P("tp", "fsdp"), mesh) == (Shard(1), Shard(0))
    assert TPL.spec_to_placements(TPL.P(("fsdp", "tp")), mesh) == (Shard(0), Shard(0))
    assert TPL.spec_to_placements(TPL.P(), mesh) == (Replicate(), Replicate())


def test_with_axes_and_grpo_plan_for_mesh():
    plan = TPL.make_grpo_plan(fsdp=4, tp=2).with_axes(name="x", fsdp=2)
    assert plan.axes == {"dp": 1, "fsdp": 2, "tp": 2} and plan.name == "x"
    assert plan.device_count == JPL.make_grpo_plan(fsdp=4, tp=2).with_axes(fsdp=2).device_count
    g = TPL.grpo_plan_for_mesh(FakeMesh(fsdp=2, sp=2))
    assert g.name == "grpo-fsdp2xsp2" and g.rules.keys() == TPL.make_grpo_plan().rules.keys()
    assert [a for a, _ in TPL.ShardingPlan("o", {"pop": 8, "fsdp": 1}).ordered_axes()] == \
        ["fsdp", "pop"]


# --------------------------------------------------------------------------- #
# registry (test_plan.py:426)
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("n", [1, 4, 8])
def test_registry_and_device_count_filter(registry, n):
    names = TPL.register_default_plans(n)
    assert names == [p.name for p in JPL.default_grpo_plans(n)]
    valid = TPL.plans_for_device_count(n)
    assert {p.name for p in valid} >= set(names)
    assert all(p.device_count == n for p in valid)
    assert TPL.get_plan(names[0]).name == names[0]
    assert TPL.register_default_plans(n) == names  # idempotent
    with pytest.raises(ValueError):
        TPL.register_plan(TPL.get_plan(names[0]))
    with pytest.raises(KeyError):
        TPL.get_plan("no-such-plan")


def test_load_plan_registers(registry):
    plan = TPL.load_plan(os.path.join(SHARDING_DIR, "grpo_test_fsdp4xtp2.yaml"))
    assert TPL.registered_plans() == [plan.name]
    assert [p.name for p in TPL.plans_for_device_count(8)] == [plan.name]
    assert TPL.resolve_plan_and_mesh(None, "m") == (None, "m")
    assert TPL.resolve_plan_and_mesh(plan.name, "m") == (plan, "m")


# --------------------------------------------------------------------------- #
# serving KV rules (test_plan.py:548)
# --------------------------------------------------------------------------- #


def test_kv_rules_on_dense_and_paged_caches():
    tcfg = TM.GPTConfig(dtype=torch.float32, **KW)
    plan = TPL.make_grpo_plan(fsdp=4, tp=2)
    specs = plan.resolve("kv", TM.init_caches(tcfg, batch=8, max_len=32, device="meta"))
    assert tuple(specs.k) == (None, ("dp", "fsdp"), None, "tp", None)
    assert tuple(specs.mask) == (("dp", "fsdp"),)
    assert tuple(specs.length) == ()
    pspecs = plan.resolve("kv_paged", TM.init_paged_cache(tcfg, 9, 8, device="meta"))
    assert tuple(pspecs.k) == (None, None, None, "tp", None)
    jplan = JPL.make_grpo_plan(fsdp=4, tp=2)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **KW)
    assert tuple(jplan.resolve("kv", JM.init_caches(jcfg, batch=8, max_len=32)).k) == \
        tuple(specs.k)


def _gspmd_padded(shape, sharding):
    """``shape`` with each dim rounded up to its tiling factor under the JAX
    ``NamedSharding``, as GSPMD pads an uneven dim."""
    sizes = dict(sharding.mesh.shape)
    out = []
    for d, e in enumerate(shape):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        n = math.prod(sizes[a] for a in ((entry,) if isinstance(entry, str)
                                         else (entry or ())))
        out.append(-(-e // n) * n)
    return tuple(out)


@pytest.mark.parametrize("batch, n_blocks", [(8, 9), (1, 13)])
def test_kv_placements_give_the_jax_shard_shapes(batch, n_blocks):
    """The serving caches' placements on fsdp4 x tp2 (``resolve`` then
    ``tiling_placements``) and this rank's shapes (``local_shape``) against
    the JAX plan's shardings on 8 devices: a dense cache [L, B, S, KV, hd]
    with rows over fsdp and KV heads over tp; a one-row prefill cache, whose
    row 4 ranks cannot split, keeps it whole on every rank (the JAX
    package pads it to the same shard shape); the paged pool keeps its
    block axis whole at a count fsdp does not divide (``test_plan.py:563``)
    and shards only KV heads."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh(fsdp=4, tp=2)
    tcfg = TM.GPTConfig(dtype=torch.float32, **KW)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **KW)
    plan, jplan = TPL.make_grpo_plan(fsdp=4, tp=2), JPL.make_grpo_plan(fsdp=4, tp=2)
    jmesh = jplan.build_mesh()
    cases = [("kv", TM.init_caches(tcfg, batch, 24, device="meta"),
              JM.init_caches(jcfg, batch=batch, max_len=24)),
             ("kv_paged", TM.init_paged_cache(tcfg, n_blocks, 8, device="meta"),
              JM.init_paged_cache(jcfg, n_blocks=n_blocks, block_size=8))]
    for group, tree, jtree in cases:
        specs = plan.resolve(group, tree, mesh)
        jshard = jplan.shardings(group, jtree, jmesh)
        for name in ("k", "v") + (("mask",) if group == "kv" else ()):
            leaf, spec = getattr(tree, name), getattr(specs, name)
            pl = TPL.tiling_placements(spec, leaf.shape, mesh)
            want = getattr(jshard, name).shard_shape(_gspmd_padded(
                getattr(jtree, name).shape, getattr(jshard, name)))
            assert TPL.local_shape(leaf.shape, pl, mesh) == tuple(want), (group, name)
            if name != "mask":
                rows = Shard(1) if group == "kv" and batch % 4 == 0 else Replicate()
                assert pl == (rows, Shard(3))
    assert TPL.tiling_placements(TPL.P(None, "tp"), (3, 3), mesh) == (Replicate(), Replicate())


def test_pop_axis_follows_build_mesh_order():
    from agilerl_tpu_torch.parallel.generation import pop_axis_of

    plan = TPL.ShardingPlan(name="pop-first", axes={"pop": 8, "fsdp": 1},
                            rules={"member": TPL.member_rules()})
    assert [a for a, _ in plan.ordered_axes()][-1] == "pop"
    assert pop_axis_of(plan, FakeMesh(fsdp=1, pop=8)) == "pop"
    assert tuple(TPL.make_population_plan(8).resolve("member", {"w": torch.zeros(8, 3)})["w"]) \
        == ("pop",)


def test_build_mesh_needs_a_matching_process_group():
    with pytest.raises((ValueError, RuntimeError)):
        TPL.make_grpo_plan(fsdp=4).build_mesh("cpu")
