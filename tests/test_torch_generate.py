"""Parity of the PyTorch port's generation loop (agilerl_tpu_torch.llm.generate)
with the JAX package's: the filters exactly on fixed logits, greedy decoding
token for token on the same numpy weights, and sampling by distribution
(the two frameworks' random streams differ)."""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.llm import model as JM  # noqa: E402
from agilerl_tpu_torch.llm import generate as TG, model as TM  # noqa: E402
from agilerl_tpu_torch.llm.convert import lora_from_numpy, params_from_numpy  # noqa: E402

# the JAX package's llm/__init__ re-exports a `generate` function under the
# submodule's name
JG = importlib.import_module("agilerl_tpu.llm.generate")
torch.set_num_threads(1)

VOCAB = 257


def _fixed_logits():
    rng = np.random.default_rng(0)
    # distinct values, well separated: no tie and no mass exactly at top_p
    base = np.linspace(-4.0, 4.0, 37, dtype=np.float32)
    return np.stack([rng.permutation(base) for _ in range(5)])


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.5, 8, 0.6), (2.0, 1, 0.3)])
def test_filter_logits_exact(temperature, top_k, top_p):
    logits = _fixed_logits()
    want = np.asarray(JG._filter_logits(jnp.asarray(logits), temperature, top_k, top_p))
    got = TG._filter_logits(torch.as_tensor(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(got == -1e9, want == -1e9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("step,min_new", [(0, 2), (3, 2), (np.array([0, 4, 1]), 2)])
def test_suppress_eos_matches_jax(step, min_new):
    logits = np.random.default_rng(1).normal(size=(3, 11)).astype(np.float32)
    want = JG._suppress_eos(jnp.asarray(logits), jnp.asarray(step), 4, min_new)
    tstep = torch.as_tensor(step) if isinstance(step, np.ndarray) else step
    got = TG._suppress_eos(torch.as_tensor(logits), tstep, 4, min_new)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_left_pad_matches_jax():
    seqs = [[5, 6, 7], [1], [9, 8, 7, 6, 5]]
    for max_len in (None, 4):
        for a, b in zip(TG.left_pad(seqs, 0, max_len), JG.left_pad(seqs, 0, max_len)):
            np.testing.assert_array_equal(a, b)


def test_sampling_follows_the_filtered_distribution():
    logits = torch.as_tensor(_fixed_logits()[:1]).repeat(20_000, 1)
    g = torch.Generator().manual_seed(0)
    toks = TG._sample_token(logits, g, 1.5, 6, 0.8)
    probs = torch.softmax(TG._filter_logits(logits[:1], 1.5, 6, 0.8), -1)[0]
    freq = torch.bincount(toks, minlength=logits.shape[1]).float() / toks.numel()
    assert (freq[probs == 0] == 0).all()
    torch.testing.assert_close(freq, probs, rtol=0, atol=0.015)


def _model(seed=1):
    kw = dict(vocab_size=VOCAB, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
              max_seq_len=64, rope_theta=10_000.0, tie_embeddings=False)
    jcfg = JM.GPTConfig(dtype=jnp.float32, **kw)
    tcfg = TM.GPTConfig(dtype=torch.float32, **kw)
    params = jax.tree_util.tree_map(np.asarray, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    # init's std 0.02 leaves the logits nearly flat and greedy decoding
    # collapses onto one token; wider weights give decisive, varied argmaxes
    params = jax.tree_util.tree_map(lambda x: x * 12.0 if x.ndim == 2 else x, params)
    ad = jax.tree_util.tree_map(np.asarray, JM.init_lora(jax.random.PRNGKey(seed + 1), jcfg))
    rng = np.random.default_rng(seed)
    for layer in ad["blocks"].values():
        for ab in layer.values():
            ab["B"] = rng.normal(0, 0.1, ab["B"].shape).astype(np.float32)
    return jcfg, tcfg, params, ad


def _prompts():
    rng = np.random.default_rng(7)
    seqs = [rng.integers(1, VOCAB, n) for n in (9, 4, 12)]
    return TG.left_pad(seqs, 0)


@pytest.mark.parametrize("eos_id,min_new", [(None, None), (3, 2)])
def test_greedy_generate_token_for_token(eos_id, min_new):
    jcfg, tcfg, params, ad = _model()
    prompt, pmask = _prompts()
    N = 12
    jt, jm = JG.generate(jcfg, params, jnp.asarray(prompt), jnp.asarray(pmask),
                         jax.random.PRNGKey(0), max_new_tokens=N, lora=ad, temperature=0.0,
                         eos_id=eos_id, min_new_tokens=min_new)
    tt, tm = TG.generate(tcfg, params_from_numpy(params, tcfg, device="cpu"),
                         torch.as_tensor(prompt), torch.as_tensor(pmask), None,
                         max_new_tokens=N, lora=lora_from_numpy(ad, device="cpu"),
                         temperature=0.0, eos_id=eos_id, min_new_tokens=min_new)
    assert tt.shape == (3, N) and tm.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert len(np.unique(np.asarray(jt))) > 3  # not collapsed onto one token


def test_greedy_path_has_decisive_margins():
    """The token-for-token test is meaningful only if no greedy step is a
    near tie: check the JAX top-2 logit gap along the decoded path."""
    jcfg, _, params, ad = _model()
    prompt, pmask = _prompts()
    toks, _ = JG.generate(jcfg, params, jnp.asarray(prompt), jnp.asarray(pmask),
                          jax.random.PRNGKey(0), max_new_tokens=12, lora=ad, temperature=0.0)
    full = np.concatenate([prompt, np.asarray(toks)], 1)
    mask = np.concatenate([pmask, np.ones_like(np.asarray(toks))], 1)
    logits, _ = JM.apply(jcfg, params, jnp.asarray(full), attention_mask=jnp.asarray(mask),
                         lora=ad)
    P = prompt.shape[1]
    top2 = np.sort(np.asarray(logits)[:, P - 1:-1], -1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-2  # f32 parity: ~1e-5


def test_sampled_generate_shapes_and_eos_masking():
    _, tcfg, params, ad = _model()
    prompt, pmask = _prompts()
    g = torch.Generator().manual_seed(3)
    tt, tm = TG.generate(tcfg, params_from_numpy(params, tcfg, device="cpu"),
                         torch.as_tensor(prompt), torch.as_tensor(pmask), g,
                         max_new_tokens=10, lora=lora_from_numpy(ad, device="cpu"),
                         temperature=0.9, top_k=20, eos_id=5, pad_id=0)
    assert tt.shape == (3, 10) and tm.shape == (3, 10)
    for row, m in zip(tt.numpy(), tm.numpy()):
        hit = np.flatnonzero(row == 5)
        if hit.size:  # mask covers up to and including the first EOS
            assert m[:hit[0] + 1].all() and not m[hit[0] + 1:].any()
            assert (row[hit[0] + 1:] == 0).all()
        else:
            assert m.all()
