"""Parity of the PyTorch port's model (agilerl_tpu_torch.llm.model) with the
JAX package's, on the same numpy weights and inputs, on the CPU.

Tolerances follow tests/test_llm/test_hf_golden.py: rtol 1e-4, atol 2e-4 in
f32; 3e-2 of the output scale in bf16 (the two frameworks round bf16 at
different places)."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.llm.presets import preset, preset_names  # noqa: E402

torch.set_num_threads(1)

VOCAB, T, B = 257, 24, 3
PADS = (0, 5, 11)  # left padding per row


def _configs(dtype_name="f32", tie=False):
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    kw = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
              max_seq_len=64, rope_theta=500_000.0, tie_embeddings=tie)
    return JM.GPTConfig(dtype=jd, **kw), TM.GPTConfig(dtype=td, **kw)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _weights(jcfg, seed=0, lora=False):
    params = _np_tree(JM.init_params(jax.random.PRNGKey(seed), jcfg))
    if not lora:
        return params, None
    ad = _np_tree(JM.init_lora(jax.random.PRNGKey(seed + 1), jcfg, rank=4))
    rng = np.random.default_rng(seed + 2)
    for layer in ad["blocks"].values():
        for ab in layer.values():  # non-zero B so the adapter matters
            ab["B"] = rng.normal(0, 0.05, ab["B"].shape).astype(np.float32)
    return params, ad


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b, p in enumerate(PADS):
        tokens[b, :p] = 0
        mask[b, :p] = 0
    return tokens, mask


def _real_targets(mask):
    """[B, T-1] positions whose input and target are both real."""
    return (mask[:, :-1] > 0) & (mask[:, 1:] > 0)


def _port(tcfg, params, ad):
    tp = params_from_numpy(params, tcfg, device="cpu")
    tl = lora_from_numpy(ad, device="cpu") if ad is not None else None
    return tp, tl


@pytest.mark.parametrize("lora", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_forward_and_apply_match_jax(lora, tie):
    jcfg, tcfg = _configs(tie=tie)
    params, ad = _weights(jcfg, lora=lora)
    tokens, mask = _inputs()
    jl, _ = JM.apply(jcfg, params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
                     lora=ad, flash=False)
    tp, tl = _port(tcfg, params, ad)
    tlog, _ = TM.apply(tcfg, tp, torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask),
                       lora=tl, flash=False)
    real = mask > 0
    np.testing.assert_allclose(tlog.numpy()[real], np.asarray(jl)[real], rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("fused,flash", [(True, True), (False, False), (True, False)])
def test_token_logprobs_match_jax(fused, flash):
    jcfg, tcfg = _configs()
    params, ad = _weights(jcfg, lora=True)
    tokens, mask = _inputs(1)
    jlp = JM.token_logprobs(jcfg, params, jnp.asarray(tokens), jnp.asarray(mask), lora=ad,
                            temperature=1.3, chunk_size=16, use_pallas=fused, flash=flash)
    tp, tl = _port(tcfg, params, ad)
    tlp = TM.token_logprobs(tcfg, tp, torch.as_tensor(tokens), torch.as_tensor(mask), lora=tl,
                            temperature=1.3, chunk_size=16, use_fused=fused, flash=flash)
    assert tlp.shape == (B, T - 1)
    real = _real_targets(mask)
    np.testing.assert_allclose(tlp.numpy()[real], np.asarray(jlp)[real], rtol=1e-4, atol=2e-4)


def test_bf16_forward_agrees_coarsely():
    jcfg, tcfg = _configs("bf16")
    params, ad = _weights(jcfg, lora=True)
    tokens, mask = _inputs(2)
    jl, _ = JM.apply(jcfg, params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask),
                     lora=ad)
    tp, tl = _port(tcfg, params, ad)
    tlog, _ = TM.apply(tcfg, tp, torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask),
                       lora=tl)
    real = mask > 0
    want = np.asarray(jl)[real]
    scale = np.abs(want).max()
    np.testing.assert_allclose(tlog.numpy()[real] / scale, want / scale, atol=3e-2)


def test_bf16_flash_fused_logprobs_agree_coarsely():
    jcfg, tcfg = _configs("bf16")
    params, ad = _weights(jcfg, lora=True)
    tokens, mask = _inputs(3)
    jlp = JM.token_logprobs(jcfg, params, jnp.asarray(tokens), jnp.asarray(mask), lora=ad,
                            use_pallas=True, flash=True)
    tp, tl = _port(tcfg, params, ad)
    tlp = TM.token_logprobs(tcfg, tp, torch.as_tensor(tokens), torch.as_tensor(mask), lora=tl,
                            use_fused=True, flash=True)
    real = _real_targets(mask)
    want = np.asarray(jlp)[real]
    scale = np.abs(want).max()
    np.testing.assert_allclose(tlp.numpy()[real] / scale, want / scale, atol=3e-2)


def test_cached_prefill_and_decode_match_jax():
    """Prefill then two single-token decode steps through the KV cache."""
    jcfg, tcfg = _configs()
    params, ad = _weights(jcfg, lora=True)
    tokens, mask = _inputs(4)
    P, S = 16, 20
    tp, tl = _port(tcfg, params, ad)
    jc = JM.init_caches(jcfg, B, S)
    tc = TM.init_caches(tcfg, B, S, device="cpu")
    pos = np.maximum(np.cumsum(mask[:, :P], -1) - 1, 0).astype(np.int32)
    steps = [(tokens[:, :P], mask[:, :P], pos)]
    last = pos[:, -1]
    for t in range(P, P + 2):
        last = last + 1
        steps.append((tokens[:, t:t + 1], mask[:, t:t + 1], last[:, None]))
    for tok, m, p in steps:
        jh, jc = JM.forward(jcfg, params, jnp.asarray(tok), attention_mask=jnp.asarray(m),
                            positions=jnp.asarray(p), cache=jc, lora=ad)
        th, tc = TM.forward(tcfg, tp, torch.as_tensor(tok), attention_mask=torch.as_tensor(m),
                            positions=torch.as_tensor(p), cache=tc, lora=tl)
        real = m > 0
        np.testing.assert_allclose(th.numpy()[real], np.asarray(jh)[real], rtol=1e-4, atol=2e-4)
    assert tc.length == int(jc.length)
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), rtol=1e-4, atol=2e-4)


def test_merge_lora_matches_jax():
    jcfg, tcfg = _configs()
    params, ad = _weights(jcfg, lora=True)
    want = JM.merge_lora(params, ad, scale=2.0)
    tp, tl = _port(tcfg, params, ad)
    got = TM.merge_lora(tp, tl, scale=2.0)
    for i, blk in want["blocks"].items():
        for name, w in blk.items():
            np.testing.assert_allclose(got["blocks"][i][name].numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-7)
    # the adapter is a no-op once merged
    tokens, mask = _inputs(5)
    a, _ = TM.apply(tcfg, tp, torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask),
                    lora=tl)
    b, _ = TM.apply(tcfg, got, torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("tie,qkv_bias", [(False, False), (True, True)])
def test_init_params_and_lora_match_jax_tree(tie, qkv_bias):
    kw = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
              tie_embeddings=tie, qkv_bias=qkv_bias)
    jcfg = JM.GPTConfig(dtype=jnp.bfloat16, **kw)
    tcfg = TM.GPTConfig(dtype=torch.bfloat16, **kw)
    jp = _np_tree(JM.init_params(jax.random.PRNGKey(0), jcfg))
    tp = TM.init_params(0, tcfg, device="cpu")
    flat_j = {p: v for p, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    assert {jax.tree_util.keystr(p) for p in flat_j} == {
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(lambda t: 0, tp))[0]}
    for path, v in flat_j.items():
        t = tp
        for k in path:
            t = t[k.key]
        assert tuple(t.shape) == v.shape
        want_dtype = torch.float32 if (path[0].key == "lm_head" or (
            tie and path[0].key == "tok_emb")) else torch.bfloat16
        assert t.dtype == want_dtype
        # same distribution family as the JAX init: std within 20%
        if v.size > 1000:
            assert abs(float(t.float().std()) / float(v.std()) - 1) < 0.2
    jl = _np_tree(JM.init_lora(jax.random.PRNGKey(0), jcfg, rank=4, targets=("wq", "wo")))
    tl = TM.init_lora(0, tcfg, rank=4, targets=("wq", "wo"), device="cpu")
    for i, layer in jl["blocks"].items():
        for t, ab in layer.items():
            assert tuple(tl["blocks"][i][t]["A"].shape) == ab["A"].shape
            assert not tl["blocks"][i][t]["B"].any()


def test_config_properties_match_jax():
    for d_model, d_ff in ((64, None), (100, None), (4096, 14336)):
        j = JM.GPTConfig(vocab_size=10, d_model=d_model, d_ff=d_ff, n_head=4)
        t = TM.GPTConfig(vocab_size=10, d_model=d_model, d_ff=d_ff, n_head=4)
        assert (t.ff_dim, t.head_dim, t.kv_heads) == (j.ff_dim, j.head_dim, j.kv_heads)
    # MoE layers are ported: the same layers route, with the same defaults
    for n_experts, moe_every in ((0, 1), (4, 1), (4, 2), (2, 3)):
        j = JM.GPTConfig(vocab_size=10, n_layer=6, n_experts=n_experts, moe_every=moe_every)
        t = TM.GPTConfig(vocab_size=10, n_layer=6, n_experts=n_experts, moe_every=moe_every)
        assert [t.is_moe_layer(i) for i in range(6)] == [j.is_moe_layer(i) for i in range(6)]
        assert (t.expert_top_k, t.capacity_factor, t.router_aux_weight) == (
            j.expert_top_k, j.capacity_factor, j.router_aux_weight)


def test_presets_match_jax():
    from agilerl_tpu.llm.presets import preset as jpreset, preset_names as jnames

    assert preset_names() == jnames()
    for name in preset_names():
        j, t = jpreset(name), preset(name)
        for field in ("vocab_size", "n_layer", "n_head", "n_kv_head", "d_model", "d_ff",
                      "max_seq_len", "rope_theta", "tie_embeddings", "qkv_bias",
                      "use_flash_attention"):
            assert getattr(t, field) == getattr(j, field), (name, field)
        assert t.dtype == torch.bfloat16 and t.ff_dim == j.ff_dim
    cfg = preset("llama3-8b")
    assert (cfg.vocab_size, cfg.n_layer, cfg.n_head, cfg.kv_heads, cfg.head_dim,
            cfg.ff_dim) == (128_256, 32, 32, 8, 128, 14_336)
