"""Parity of the PyTorch port's ops (agilerl_tpu_torch.ops) with the JAX
package's kernels, on the CPU, where each port wrapper runs its kernel's plain
version and the JAX kernels run in Pallas interpret mode (as
tests/test_ops runs them). The CUDA kernels themselves are held against the
same plain versions on the card by tests/test_torch_kernels.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.ops import decode_attention as jdec  # noqa: E402
from agilerl_tpu.ops.flash_attention_vjp import flash_attention_diff, flash_attention_with_lse  # noqa: E402
from agilerl_tpu.ops.fused_loss import fused_token_logprob as j_fused  # noqa: E402
from agilerl_tpu_torch.ops import decode_attention as tdec  # noqa: E402
from agilerl_tpu_torch.ops import fused_loss as tfl  # noqa: E402
from agilerl_tpu_torch.ops import flash_attention_vjp as tfa  # noqa: E402
from agilerl_tpu_torch.ops.flash_attention import flash_attention  # noqa: E402

torch.set_num_threads(1)


def _qkv(seed, B, H, Hkv, T, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, H, T, d)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, T, d)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, T, d)).astype(np.float32)
    return q, k, v


def _left_pad_mask(B, T, pads):
    mask = np.ones((B, T), np.int32)
    for b, p in enumerate(pads):
        mask[b, :p] = 0
    return mask


# ------------------------------ flash attention ----------------------------- #


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("T", [32, 24])
def test_flash_reference_matches_jax_kernel(causal, with_mask, T):
    B, H, d = 2, 2, 16
    q, k, v = _qkv(0, B, H, H, T, d)
    mask = _left_pad_mask(B, T, (0, 7)) if with_mask else None
    jo, jl = flash_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask), causal, 16, 16)
    jd = flash_attention_diff(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask), causal, 16, 16)
    tm = None if mask is None else torch.as_tensor(mask)
    to, tl = tfa.flash_attention_with_lse(torch.as_tensor(q), torch.as_tensor(k),
                                          torch.as_tensor(v), tm, causal)
    assert to.shape == (B, H, T, d) and tl.shape == (B, H, T)
    # real query rows only: fully masked rows are finite garbage in both
    rows = np.ones((B, T), bool) if mask is None else mask > 0
    for b in range(B):
        np.testing.assert_allclose(to.numpy()[b][:, rows[b]], np.asarray(jo)[b][:, rows[b]],
                                   atol=2e-5)
        np.testing.assert_allclose(to.numpy()[b][:, rows[b]], np.asarray(jd)[b][:, rows[b]],
                                   atol=2e-5)
        np.testing.assert_allclose(tl.numpy()[b][:, rows[b]], np.asarray(jl)[b][:, rows[b]],
                                   atol=2e-5)
    assert np.isfinite(to.numpy()).all() and np.isfinite(tl.numpy()).all()


def test_flash_gqa_reads_kv_head_in_place():
    """Unrepeated K/V give what the JAX kernel gives on jnp.repeat'ed K/V."""
    B, H, Hkv, T, d = 2, 4, 2, 24, 16
    q, k, v = _qkv(1, B, H, Hkv, T, d)
    mask = _left_pad_mask(B, T, (3, 0))
    rep = lambda x: jnp.repeat(jnp.asarray(x), H // Hkv, axis=1)  # noqa: E731
    jo = flash_attention_diff(jnp.asarray(q), rep(k), rep(v), jnp.asarray(mask), True, 16, 16)
    to = tfa.flash_attention_diff(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                  torch.as_tensor(mask), True)
    for b in range(B):
        r = mask[b] > 0
        np.testing.assert_allclose(to.numpy()[b][:, r], np.asarray(jo)[b][:, r], atol=2e-5)


def test_flash_attention_forward_only_twin_matches():
    B, H, T, d = 1, 2, 20, 16
    q, k, v = (torch.as_tensor(x) for x in _qkv(2, B, H, H, T, d))
    out, _ = tfa.flash_attention_with_lse(q, k, v, None, True)
    torch.testing.assert_close(flash_attention(q, k, v, None, True), out, rtol=0, atol=0)


def test_flash_reference_bf16_close_to_f32():
    B, H, T, d = 2, 2, 24, 16
    q, k, v = (torch.as_tensor(x) for x in _qkv(3, B, H, H, T, d))
    mask = torch.as_tensor(_left_pad_mask(B, T, (0, 4)))
    o32, l32 = tfa.flash_attention_with_lse(q, k, v, mask, True)
    o16, l16 = tfa.flash_attention_with_lse(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask, True)
    assert o16.dtype == torch.bfloat16 and l16.dtype == torch.float32
    real = mask.bool()
    for b in range(B):
        torch.testing.assert_close(o16[b][:, real[b]].float(), o32[b][:, real[b]],
                                   rtol=0, atol=5e-2)


# ------------------------------ fused logprob ------------------------------- #


@pytest.mark.parametrize("temperature", [1.0, 1.7])
@pytest.mark.parametrize("N", [40, 7])
def test_fused_reference_matches_jax_kernel(temperature, N):
    rng = np.random.default_rng(4)
    D, V = 32, 257  # V not a multiple of the 128-column tile
    hidden = rng.normal(size=(N, D)).astype(np.float32)
    head = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    want = j_fused(jnp.asarray(hidden), jnp.asarray(head), jnp.asarray(targets),
                   temperature=temperature, block_n=16, block_v=128)
    got = tfl.reference_token_logprob(torch.as_tensor(hidden), torch.as_tensor(head),
                                      torch.as_tensor(targets), temperature)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    wrapped = tfl.fused_token_logprob(torch.as_tensor(hidden), torch.as_tensor(head),
                                      torch.as_tensor(targets).long(), temperature)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_fused_lse_is_logsumexp():
    rng = np.random.default_rng(5)
    h = torch.as_tensor(rng.normal(size=(9, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 130)).astype(np.float32))
    t = torch.as_tensor(rng.integers(0, 130, 9))
    lp, lse = tfl._fwd_call(h, w, t, 1.3)
    torch.testing.assert_close(lse, torch.logsumexp((h @ w) / 1.3, -1))
    torch.testing.assert_close(lp, torch.log_softmax((h @ w) / 1.3, -1)[torch.arange(9), t])


@pytest.mark.parametrize("n_rows,vocab,sms", [(5104, 128_256, 132), (7, 257, 132),
                                              (100_000, 300, 132)])
def test_vocab_split_covers_every_tile(n_rows, vocab, sms):
    n_split, per = tfl.vocab_split(n_rows, vocab, sms)
    n_vt = -(-vocab // 128)
    assert (n_split - 1) * per < n_vt <= n_split * per
    assert n_split >= 1 and per >= 1


# --------------------------- chunked cached attention ----------------------- #


def _cache_case(seed, B=3, S=40, T=3, Hq=4, Hkv=2, d=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, d)).astype(np.float32)
    kc = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    vc = rng.normal(size=(B, S, Hkv, d)).astype(np.float32)
    valid = (rng.random((B, S)) > 0.2).astype(np.int32)
    return q, kc, vc, valid


@pytest.mark.parametrize("block", [16, 512])
@pytest.mark.parametrize("start", [np.array([5, 20, 33], np.int32), 17])
def test_chunked_cached_attention_matches_jax(block, start):
    """Per-row start with a T > 1 window (the verify-window shape), and a
    scalar start; block 16 leaves a clamped last chunk (S % 16 != 0)."""
    q, kc, vc, valid = _cache_case(6)
    want = jdec.chunked_cached_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                         jnp.asarray(valid), jnp.asarray(start), block=block)
    tstart = torch.as_tensor(start) if isinstance(start, np.ndarray) else start
    got = tdec.chunked_cached_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                        torch.as_tensor(vc), torch.as_tensor(valid), tstart,
                                        block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)
    dense = tdec._dense_reference(torch.as_tensor(q), torch.as_tensor(kc), torch.as_tensor(vc),
                                  torch.as_tensor(valid), tstart)
    jdense = jdec._dense_reference(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(valid), jnp.asarray(start))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-5, atol=2e-5)


def test_chunked_cached_attention_bf16_decode_step():
    q, kc, vc, valid = _cache_case(7, T=1)
    args = [jnp.asarray(x, jnp.bfloat16) for x in (q, kc, vc)]
    want = jdec.chunked_cached_attention(*args, jnp.asarray(valid), jnp.asarray(21), block=16)
    targs = [torch.as_tensor(x).bfloat16() for x in (q, kc, vc)]
    got = tdec.chunked_cached_attention(*targs, torch.as_tensor(valid), 21, block=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=2e-2)
