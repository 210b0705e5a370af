"""Parity of the port's evolvable transformers (agilerl_tpu_torch.modules.gpt
and .bert) with the JAX package's, on the CPU, on the same numpy weights,
inputs and mutation draws; and the flash kernels' head-dim plan.

Tolerances: forward logits at f32, rtol 1e-5 (atol 1e-6 for logits near
zero; XLA and torch sum in other orders); preserved slabs bit-equal; the
flash path against the JAX Pallas kernels (interpret mode on the CPU) at
rtol 1e-5, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu.modules.bert import EvolvableBERT as JBERT  # noqa: E402
from agilerl_tpu.modules.gpt import EvolvableGPT as JGPT  # noqa: E402
from agilerl_tpu.utils import profiling as JP  # noqa: E402
from agilerl_tpu_torch.llm import model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy, params_from_numpy  # noqa: E402
from agilerl_tpu_torch.modules.bert import EvolvableBERT  # noqa: E402
from agilerl_tpu_torch.modules.gpt import EvolvableGPT  # noqa: E402
from agilerl_tpu_torch.ops import flash_attention_vjp as tfa  # noqa: E402

torch.set_num_threads(1)

VOCAB = 61


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: np.asarray(tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor)
                               else tree)}


def _gpt_pair(**kw):
    """A JAX EvolvableGPT and the port's, on the JAX weights (f32)."""
    base = dict(vocab_size=VOCAB, n_layer=2, n_head=4, d_model=64, max_seq_len=32)
    base.update(kw)
    jg = JGPT(config=JM.GPTConfig(dtype=jnp.float32, **base), key=jax.random.PRNGKey(0))
    tcfg = TM.GPTConfig(dtype=torch.float32, **base)
    tg = EvolvableGPT(config=tcfg, key=torch.Generator().manual_seed(0), device="cpu")
    tg.params = params_from_numpy(_np(jg.params), tcfg, device="cpu")
    return jg, tg


def _bert_pair(**kw):
    base = dict(vocab_size=VOCAB, n_encoder_layers=2, n_decoder_layers=2, n_head=4,
                d_model=64, max_seq_len=16)
    base.update(kw)
    jb = JBERT(key=jax.random.PRNGKey(1), **base)
    tb = EvolvableBERT(key=torch.Generator().manual_seed(1), device="cpu", **base)
    tb.params = f32_tree_from_numpy(_np(jb.params), device="cpu")
    return jb, tb


def _tokens(B, T, seed=0, pads=None):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, VOCAB, (B, T)).astype(np.int32)
    mask = np.ones((B, T), np.int32)
    for b, p in enumerate(pads or ()):
        tokens[b, :p] = 0
        mask[b, :p] = 0
    return tokens, mask


def _assert_logits(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("moe", [False, True])
def test_gpt_forward_matches_jax(moe):
    kw = dict(n_experts=4, expert_top_k=2, n_kv_head=2) if moe else {}
    jg, tg = _gpt_pair(**kw)
    tokens, mask = _tokens(3, 12, pads=(0, 4, 7))
    jl = JGPT.apply(jg.config, jg.params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask))
    tl = EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens),
                            attention_mask=torch.as_tensor(mask))
    assert tl.shape == (3, 12, VOCAB)
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], rtol=1e-5, atol=1e-6)
    if moe:  # the aux loss surfaces through return_aux
        _, jaux = JGPT.apply(jg.config, jg.params, jnp.asarray(tokens), return_aux=True)
        _, taux = EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens),
                                     return_aux=True)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_bert_forward_matches_jax():
    jb, tb = _bert_pair()
    src, src_mask = _tokens(2, 9, seed=1, pads=(0, 3))
    tgt, _ = _tokens(2, 7, seed=2)
    src_mask = src_mask[:, ::-1].copy()  # right padding of the source
    jl = JBERT.apply(jb.config, jb.params, jnp.asarray(src), tgt=jnp.asarray(tgt),
                     src_mask=jnp.asarray(src_mask))
    tl = EvolvableBERT.apply(tb.config, tb.params, torch.as_tensor(src),
                             tgt=torch.as_tensor(tgt), src_mask=torch.as_tensor(src_mask))
    _assert_logits(tl, jl)
    je = JBERT.apply(jb.config, jb.params, jnp.asarray(src))
    te = EvolvableBERT.apply(tb.config, tb.params, torch.as_tensor(src))
    assert te.shape == (2, 9, 64)
    _assert_logits(te, je)


def _assert_preserved(old, jax_new, port_new):
    """Every leaf's shape equal across the packages, and on the slab a
    leaf shares with its old self both hold the old weights bit for bit."""
    old, jn, pn = _flat(old), _flat(jax_new), _flat(port_new)
    assert set(jn) == set(pn)
    kept = 0
    for path, j in jn.items():
        p = pn[path]
        assert p.shape == j.shape, path
        o = old.get(path)
        if o is None or o.ndim != j.ndim:
            continue
        sl = tuple(slice(0, min(a, b)) for a, b in zip(o.shape, j.shape))
        np.testing.assert_array_equal(p[sl], j[sl], err_msg=str(path))
        np.testing.assert_array_equal(p[sl], o[sl], err_msg=str(path))
        kept += 1
    assert kept > 0


GPT_MUTATIONS = ["add_layer", "remove_layer", "add_node", "remove_node"]


@pytest.mark.parametrize("name", GPT_MUTATIONS + ["add_expert", "remove_expert"])
def test_gpt_mutations_preserve_slabs_as_jax(name):
    moe = "expert" in name
    jg, tg = _gpt_pair(n_layer=3, d_model=128, **(dict(n_experts=3) if moe else {}))
    old = _np(jg.params)
    jout = getattr(jg, name)(rng=np.random.default_rng(7))
    tout = getattr(tg, name)(rng=np.random.default_rng(7))
    assert tout == jout
    assert dataclasses.asdict(tg.config) == {
        k: (torch.float32 if k == "dtype" else v)
        for k, v in dataclasses.asdict(jg.config).items()
        if k in {f.name for f in dataclasses.fields(tg.config)}}
    _assert_preserved(old, _np(jg.params), tg.params)
    tokens, _ = _tokens(2, 6, seed=3)
    assert EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens)).shape == (2, 6, VOCAB)


def test_remove_expert_clamps_top_k():
    _, tg = _gpt_pair(n_experts=3, expert_top_k=3)
    assert tg.remove_expert() == {"n_experts": 2}
    assert tg.config.expert_top_k == 2
    _, dense = _gpt_pair()
    dense.add_expert(rng=np.random.default_rng(0))  # a dense model takes a node mutation
    assert dense.last_mutation_attr == "add_expert" and dense.config.n_experts == 0
    assert dense.config.d_model > 64


@pytest.mark.parametrize("name", GPT_MUTATIONS)
def test_bert_mutations_preserve_slabs_as_jax(name):
    jb, tb = _bert_pair()
    old = _np(jb.params)
    jout = getattr(jb, name)(rng=np.random.default_rng(11))
    tout = getattr(tb, name)(rng=np.random.default_rng(11))
    assert tout == jout
    assert dataclasses.asdict(tb.config) == dataclasses.asdict(jb.config)
    _assert_preserved(old, _np(jb.params), tb.params)
    src, _ = _tokens(1, 5, seed=4)
    out = EvolvableBERT.apply(tb.config, tb.params, torch.as_tensor(src),
                              tgt=torch.as_tensor(src[:, :3]))
    assert out.shape == (1, 3, VOCAB)


def test_estimate_mfu_matches_jax():
    jg, tg = _gpt_pair()
    peak = 989e12
    want = JP.estimate_mfu(jg.config, 8192, 0.02, peak_flops=peak)
    assert tg.estimate_mfu(8192, 0.02, peak_flops=peak) == pytest.approx(want, rel=1e-12)
    assert tg.estimate_mfu(8192, 0.02) is None  # the CPU has no published peak
    assert EvolvableGPT.get_mutation_methods().keys() == JGPT.get_mutation_methods().keys()


@pytest.mark.parametrize("head_dim", [16, 20, 32, 68])
def test_flash_gpt_at_padded_head_dims_matches_jax_pallas(head_dim):
    """The model with flash on at head dims the CUDA kernels run zero-padded
    (on the CPU the plain version) against the JAX model through its Pallas
    flash kernels in interpret mode: logits, and at head dim 20 also the
    token logprobs."""
    jg, tg = _gpt_pair(n_layer=1, n_head=2, n_kv_head=1, d_model=2 * head_dim,
                       use_flash_attention=True)
    tokens, mask = _tokens(2, 16, seed=5, pads=(0, 6))
    jl = JGPT.apply(jg.config, jg.params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask))
    tl = EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens),
                            attention_mask=torch.as_tensor(mask))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], rtol=1e-5, atol=1e-5)
    if head_dim != 20:  # the logprobs once: each JAX call compiles anew
        return
    jlp = JM.token_logprobs(jg.config, jg.params, jnp.asarray(tokens), jnp.asarray(mask))
    tlp = TM.token_logprobs(tg.config, tg.params, torch.as_tensor(tokens),
                            torch.as_tensor(mask))
    both = real[:, :-1] & real[:, 1:]
    np.testing.assert_allclose(tlp.numpy()[both], np.asarray(jlp)[both], rtol=1e-5, atol=1e-5)


def test_flash_gpt_node_mutation_moves_the_head_dim_as_jax():
    """add_node at 4 heads: head dim 16 -> 20, both packages through flash."""
    jg, tg = _gpt_pair(n_layer=1, use_flash_attention=True)
    jg.add_node(numb_new_nodes=16)
    tg.add_node(numb_new_nodes=16)
    assert tg.config.head_dim == jg.config.head_dim == 20
    tg.params = params_from_numpy(_np(jg.params), tg.config, device="cpu")
    tokens, mask = _tokens(2, 16, seed=6, pads=(3, 0))
    jl = JGPT.apply(jg.config, jg.params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask))
    tl = EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens),
                            attention_mask=torch.as_tensor(mask))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], rtol=1e-5, atol=1e-5)


def test_flash_gpt_node_mutated_past_head_dim_256_matches_jax():
    """add_node at 2 heads: d_model 512 -> 544, head dim 256 -> 272 (past
    the built tiles: the wide kernels on the card), both packages through
    flash; the port's logits against the JAX EvolvableGPT's (its Pallas
    kernel in interpret mode) at the tolerance above."""
    jg, tg = _gpt_pair(n_layer=1, n_head=2, d_model=512, max_seq_len=16,
                       use_flash_attention=True)
    jg.add_node(numb_new_nodes=32)
    tg.add_node(numb_new_nodes=32)
    assert tg.config.head_dim == jg.config.head_dim == 272
    tg.params = params_from_numpy(_np(jg.params), tg.config, device="cpu")
    tokens, mask = _tokens(2, 16, seed=7, pads=(5, 0))
    jl = JGPT.apply(jg.config, jg.params, jnp.asarray(tokens), attention_mask=jnp.asarray(mask))
    tl = EvolvableGPT.apply(tg.config, tg.params, torch.as_tensor(tokens),
                            attention_mask=torch.as_tensor(mask))
    real = mask > 0
    np.testing.assert_allclose(tl.numpy()[real], np.asarray(jl)[real], rtol=1e-5, atol=1e-5)


def test_flash_head_dim_plan():
    """The head dim the kernels run d at: the smallest built one (64, 128,
    256) that holds d; past 256 d rounded up to a multiple of 64 (the wide
    kernels), with no upper limit; below 1 a ValueError."""
    for d in range(1, 257):
        assert tfa.flash_head_dim_plan(d) == min(h for h in (64, 128, 256) if h >= d)
    for d in (257, 272, 320, 321, 511, 1024, 1025, 4096):
        assert tfa.flash_head_dim_plan(d) == -(-d // 64) * 64
    for d in (0, -64):
        with pytest.raises(ValueError, match="must be positive"):
            tfa.flash_head_dim_plan(d)


@pytest.mark.parametrize("d", [20, 68, 272])
def test_zero_padded_head_dim_leaves_attention_unchanged(d):
    """The wrappers' padding on the plain versions: q, k, v and dO padded
    with zeros to the planned head dim, at the true d's scale, give the
    unpadded out, lse, dq, dk and dv in their first d columns and zeros in
    the rest."""
    g = torch.Generator().manual_seed(d)
    hd = tfa.flash_head_dim_plan(d)
    q, k, v = (torch.randn(2, h, 40, d, generator=g) for h in (4, 2, 2))
    mask = torch.ones(2, 40, dtype=torch.int32)
    mask[1, :9] = 0
    dout = torch.randn(2, 4, 40, d, generator=g)
    out, lse = tfa.flash_attention_reference(q, k, v, mask)
    dd = (dout * out).sum(-1)
    grads = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask)
    pq, pk, pv, pdo = (tfa._pad_head(t, hd) for t in (q, k, v, dout))
    assert pq.shape[-1] == hd and not pq[..., d:].any()
    scale = d ** -0.5
    pout, plse = tfa.flash_attention_reference(pq, pk, pv, mask, scale=scale)
    pgrads = tfa.flash_attention_bwd_reference(pq, pk, pv, pdo, plse, dd, mask, scale=scale)
    torch.testing.assert_close(pout[..., :d], out, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(plse, lse, rtol=1e-6, atol=1e-6)
    assert not pout[..., d:].any()
    for pg, gr in zip(pgrads, grads):
        torch.testing.assert_close(pg[..., :d], gr, rtol=1e-6, atol=1e-6)
        assert not pg[..., d:].any()
