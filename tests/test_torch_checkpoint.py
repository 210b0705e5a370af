"""The port's tree and LLM checkpoints on torch.distributed.checkpoint
(agilerl_tpu_torch.utils.checkpoint) and its memory budget
(agilerl_tpu_torch.utils.hbm_budget), on the CPU, in one process with no
process group: tests/test_utils/test_checkpoint_roundtrip.py's pytree cases
(step-dir retention on the same directories as the JAX helpers,
``save_pytree(step=, keep_last=)``, an atomic overwrite that a crash at the
commit cannot tear) plus trees of every leaf kind restored without a
template; the LLM case (adapters restored bit for bit into a fresh agent,
the base only when asked for, the JAX checkpoint's layout); a snapshot's
AsyncPytree entry on DCP; and the budget against the JAX package's
param_counts / grpo_hbm_budget for the same config and mesh numbers (a
formula: equal exactly), the llama3-8b count within 7.9e9-8.1e9. Each test
imports the JAX modules it compares with inside the test."""

from typing import NamedTuple

import numpy as np
import pytest
import torch

from agilerl_tpu_torch.algorithms.grpo import GRPO
from agilerl_tpu_torch.llm import model as TM
from agilerl_tpu_torch.llm.presets import preset
from agilerl_tpu_torch.resilience import FaultInjector, InjectedCrash
from agilerl_tpu_torch.utils import checkpoint as C, hbm_budget as H
from agilerl_tpu_torch.utils.tree import tree_leaves

torch.set_num_threads(1)


class _State(NamedTuple):
    count: int
    mu: dict


def _tree(scale=1.0):
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(4, 3, generator=g) * scale,
        "half": torch.randn(5, generator=g).to(torch.bfloat16),
        "blocks": {"0": {"A": torch.arange(6, dtype=torch.int64).reshape(2, 3)}},
        "opt": (_State(3, {"m": torch.ones(2)}), [np.arange(4, dtype=np.float32), None]),
        "step": 7, "name": "grpo", "flag": np.float64(0.5), "mask": np.array([True, False]),
    }


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b)


def test_step_dir_retention_matches_jax(tmp_path):
    pytest.importorskip("jax")
    from agilerl_tpu.utils import checkpoint as JC

    for root in (tmp_path / "t", tmp_path / "j"):
        for s in (100, 200, 300, 400):
            (root / f"step_{s}").mkdir(parents=True)
        (root / "step_500.tmp").mkdir()  # a crashed save: invisible
        (root / "unrelated").mkdir()
    assert [d.name for d in C.step_dirs(tmp_path / "t")] == [
        d.name for d in JC.step_dirs(tmp_path / "j")] == [
        "step_100", "step_200", "step_300", "step_400"]
    assert C.retain_step_dirs(tmp_path / "t", 2) == JC.retain_step_dirs(tmp_path / "j", 2) == 2
    assert [d.name for d in C.step_dirs(tmp_path / "t")] == ["step_300", "step_400"]
    assert (tmp_path / "t" / "unrelated").exists()


def test_save_pytree_versioned_atomic_with_retention(tmp_path):
    tree = {"w": np.arange(8.0, dtype=np.float32)}
    for s in (1, 2, 3):
        C.save_pytree(tmp_path, {"w": tree["w"] * s}, step=s, keep_last=2)
    assert [d.name for d in C.step_dirs(tmp_path)] == ["step_2", "step_3"]
    back = C.load_pytree(tmp_path, like=tree, step=3)
    np.testing.assert_array_equal(back["w"], tree["w"] * 3)
    assert not list(tmp_path.glob("*.tmp"))


def test_every_leaf_kind_round_trips_without_a_template(tmp_path):
    tree = _tree()
    C.save_pytree(tmp_path / "ck", tree)
    back = C.load_pytree(tmp_path / "ck")
    _assert_same(tree, back)
    assert all(t.device.type == "cpu" for t in tree_leaves(back) if isinstance(t, torch.Tensor))
    # with a template: the same values, on the template's devices
    _assert_same(tree, C.load_pytree(tmp_path / "ck", like=tree))
    with pytest.raises(KeyError, match="no tensor"):
        C.load_pytree(tmp_path / "ck", like={"other": torch.zeros(1)})


@pytest.mark.parametrize("tree", [
    {"a/b": torch.zeros(1), "a": {"b": torch.ones(1)}},
    {"blocks": {1: torch.zeros(1), "1": np.ones(2, np.float32)}},
], ids=["slash_in_key", "int_beside_str"])
def test_trees_whose_leaves_share_a_key_are_refused(tmp_path, tree):
    # two leaves under one DCP key would restore as one tensor: the save
    # refuses the tree and leaves nothing behind
    with pytest.raises(ValueError, match="under the key"):
        C.save_pytree(tmp_path / "ck", tree)
    assert not list(tmp_path.iterdir())


def test_atomic_overwrite_survives_a_crash_at_the_commit(tmp_path):
    path = tmp_path / "ck"
    C.save_pytree(path, _tree(1.0))
    C.save_pytree(path, _tree(2.0))  # a clean overwrite
    _assert_same(C.load_pytree(path), _tree(2.0))
    with FaultInjector(kill_at_op=0, match=("commit",)):
        with pytest.raises(InjectedCrash):
            C.save_pytree(path, _tree(3.0))
    # the crash came before the swap: the previous checkpoint is whole
    _assert_same(C.load_pytree(path), _tree(2.0))
    C.save_pytree(path, _tree(4.0))  # the next save clears the staging dir
    _assert_same(C.load_pytree(path), _tree(4.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck"]


TOK_VOCAB = 45
CFG = TM.GPTConfig(vocab_size=TOK_VOCAB, n_layer=2, n_head=4, d_model=32, max_seq_len=64,
                   dtype=torch.float32)


def _agent(seed):
    return GRPO(config=CFG, seed=seed, device="cpu", pad_token_id=0, eos_token_id=1,
                group_size=2, batch_size=4, max_output_tokens=4, lora_rank=4)


@pytest.mark.parametrize("include_base", [False, True])
def test_llm_adapters_restore_bit_for_bit(tmp_path, include_base):
    agent = _agent(0)
    g = torch.Generator().manual_seed(1)
    agent.actor.params = {"blocks": {i: {t: {"A": ab["A"], "B": torch.randn(
        ab["B"].shape, generator=g)} for t, ab in layer.items()}
        for i, layer in agent.actor.params["blocks"].items()}}
    agent.fitness, agent.steps = [0.25, 0.5], [0, 12]
    C.save_llm_checkpoint(agent, tmp_path, include_base=include_base)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["actor_adapter", "reference_adapter", "attributes.pkl"]
        + (["base_params"] if include_base else []))
    fresh = _agent(5)
    base_before = [t.clone() for t in tree_leaves(fresh.base_params)]
    C.load_llm_checkpoint(fresh, tmp_path)
    _assert_same(agent.actor.params, fresh.actor.params)
    _assert_same(agent.reference.params, fresh.reference.params)
    assert fresh.fitness == [0.25, 0.5] and fresh.steps == [0, 12]
    if include_base:
        _assert_same(agent.base_params, fresh.base_params)
    else:  # the base stays the agent's own
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh.base_params),
                                                      base_before))


def test_llm_checkpoint_layout_matches_jax(tmp_path):
    """The JAX package's save_llm_checkpoint (orbax) and the port's (DCP)
    write the same entries and the same attribute keys."""
    pytest.importorskip("orbax.checkpoint")
    import pickle

    import jax.numpy as jnp

    from agilerl_tpu.algorithms.grpo import GRPO as JGRPO
    from agilerl_tpu.llm import model as JM
    from agilerl_tpu.utils import checkpoint as JC

    jagent = JGRPO(config=JM.GPTConfig(vocab_size=TOK_VOCAB, n_layer=1, n_head=4, d_model=32,
                                       max_seq_len=64, dtype=jnp.float32),
                   pad_token_id=0, eos_token_id=1, group_size=2, batch_size=4,
                   max_output_tokens=4, lora_rank=4, seed=0)
    JC.save_llm_checkpoint(jagent, tmp_path / "j")
    C.save_llm_checkpoint(_agent(0), tmp_path / "t")
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == sorted(
        p.name for p in (tmp_path / "t").iterdir())
    attrs = [pickle.loads((tmp_path / d / "attributes.pkl").read_bytes()) for d in "jt"]
    assert sorted(attrs[0]) == sorted(attrs[1])


def test_snapshot_async_pytree_rides_dcp(tmp_path):
    from agilerl_tpu_torch.resilience import AsyncPytree, CheckpointManager

    mgr = CheckpointManager(tmp_path)
    tree = _tree()
    path = mgr.save({"tree": AsyncPytree(tree), "n": 1}, step=2)
    assert (path / "tree.pytree" / ".metadata").exists()
    info, entries = mgr.load()
    assert info.path == path and entries["n"] == 1
    _assert_same(tree, entries["tree"])


# --------------------------------------------------------------------------- #
# the memory budget
# --------------------------------------------------------------------------- #


def _jax_config(cfg):
    import jax.numpy as jnp

    from agilerl_tpu.llm import model as JM

    fields = ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model", "d_ff",
              "max_seq_len", "tie_embeddings", "qkv_bias")
    return JM.GPTConfig(dtype=jnp.bfloat16, **{f: getattr(cfg, f) for f in fields})


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-7b", "gpt2-small"])
def test_budget_equals_the_jax_formula(name, monkeypatch):
    """param_counts: the same parameter counts and LoRA bytes as the JAX
    package (its base_bytes count its f32 storage; the port's its bf16
    blocks and f32 head); grpo_hbm_budget: the JAX function evaluated on
    the port's counts gives the port's budget, every term equal."""
    pytest.importorskip("jax")
    from agilerl_tpu.utils import hbm_budget as JH

    cfg = preset(name)
    jcfg = _jax_config(cfg)
    got, want = H.param_counts(cfg), JH.param_counts(jcfg)
    for k in ("base_params", "lora_params", "lora_bytes", "lora_a_bytes", "lora_b_bytes"):
        assert got[k] == want[k], k
    base = TM.init_params(torch.Generator(), cfg, device="meta")
    assert got["base_bytes"] == sum(t.numel() * t.element_size() for t in tree_leaves(base))
    # the JAX formula on the port's counts (the JAX function passes its
    # config, rank and targets on to param_counts)
    monkeypatch.setattr(JH, "param_counts", lambda _cfg, *a, **k: H.param_counts(cfg, *a, **k))
    for mesh in (dict(fsdp=1, tp=1, batch_global=16, seq_len=320, gen_batch_global=16,
                      gen_total_len=320),
                 dict(fsdp=16, tp=4, batch_global=64, seq_len=2048, gen_batch_global=32,
                      gen_total_len=1536),
                 dict(fsdp=4, tp=2, dp=2, batch_global=32, seq_len=512, lora_rank=16,
                      lora_targets=("wq", "wk", "wv", "wo"))):
        assert H.grpo_hbm_budget(cfg, **mesh) == JH.grpo_hbm_budget(jcfg, **mesh)


def test_llama3_8b_count_and_render():
    counts = H.param_counts(preset("llama3-8b"))
    assert 7.9e9 < counts["base_params"] < 8.1e9  # Llama-3-8B: ~8.03 B
    b = H.grpo_hbm_budget(preset("llama3-8b"), fsdp=1, tp=1, batch_global=16, seq_len=320,
                          gen_batch_global=16, gen_total_len=320)
    md = H.render_budget_md(b, hbm_gib=79.2)
    assert "base weights" in md and "kv cache generation" in md and "fits" in md
    b2 = H.grpo_hbm_budget(preset("llama3-8b"), fsdp=2, tp=2, batch_global=16, seq_len=320)
    assert b2["base_weights"] == b["base_weights"] / 4
