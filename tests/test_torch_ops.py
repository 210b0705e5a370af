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
from agilerl_tpu.ops.fused_loss import fused_token_logprob_diff as j_fused_diff  # noqa: E402
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


def _jax_flash_grads(q, k, v, mask, causal, wo, wl=None):
    """jax.grad of the JAX kernels (Pallas interpret mode) on jnp.repeat'ed
    K/V: the repeat's transpose sums dK/dV over each GQA group."""
    rep = q.shape[1] // k.shape[1]
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        kr, vr = jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1)
        if wl is None:
            return jnp.sum(flash_attention_diff(q, kr, vr, jm, causal, 16, 16) * wo)
        out, lse = flash_attention_with_lse(q, kr, vr, jm, causal, 16, 16)
        return jnp.sum(out * wo) + jnp.sum(lse * wl)

    return jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _torch_flash_grads(q, k, v, mask, causal, wo, wl=None):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    tm = None if mask is None else torch.as_tensor(mask)
    if wl is None:
        loss = (tfa.flash_attention_diff(tq, tk, tv, tm, causal) * torch.as_tensor(wo)).sum()
    else:
        out, lse = tfa.flash_attention_with_lse(tq, tk, tv, tm, causal)
        loss = (out * torch.as_tensor(wo)).sum() + (lse * torch.as_tensor(wl)).sum()
    return torch.autograd.grad(loss, (tq, tk, tv))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_mask", [False, True])
@pytest.mark.parametrize("T,H,Hkv", [(32, 2, 2), (24, 4, 2)])
def test_flash_gradients_match_jax_kernel(causal, with_mask, T, H, Hkv):
    """dQ, dK, dV through the port's autograd path (its plain backward on the
    CPU) against jax.grad of the JAX kernels, atol 5e-4 as tests/test_ops.
    T = 24 is ragged against the 16-row blocks; H = 4 over Hkv = 2 is GQA. The
    upstream gradient is zero on padded query rows (their outputs are
    garbage in both, and callers never read them)."""
    B, d = 2, 16
    q, k, v = _qkv(7, B, H, Hkv, T, d)
    mask = _left_pad_mask(B, T, (0, 7)) if with_mask else None
    rows = np.ones((B, T), np.float32) if mask is None else mask.astype(np.float32)
    wo = np.random.default_rng(8).normal(size=(B, H, T, d)).astype(np.float32)
    wo = wo * rows[:, None, :, None]
    want = _jax_flash_grads(q, k, v, mask, causal, wo)
    got = _torch_flash_grads(q, k, v, mask, causal, wo)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_with_lse_gradients_match_jax_kernel(causal):
    """A nonzero lse cotangent enters the backward as D - dlse."""
    B, H, Hkv, T, d = 2, 4, 2, 24, 16
    q, k, v = _qkv(9, B, H, Hkv, T, d)
    mask = _left_pad_mask(B, T, (5, 0))
    rng = np.random.default_rng(10)
    wo = rng.normal(size=(B, H, T, d)).astype(np.float32) * mask[:, None, :, None]
    wl = rng.normal(size=(B, H, T)).astype(np.float32) * mask[:, None, :]
    want = _jax_flash_grads(q, k, v, mask, causal, wo, wl)
    got = _torch_flash_grads(q, k, v, mask, causal, wo, wl)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, err_msg=name)
    # and the lse term matters: without it the gradients differ
    no_lse = _torch_flash_grads(q, k, v, mask, causal, wo)
    assert max((a - b).abs().max().item() for a, b in zip(got, no_lse)) > 1e-2


def test_flash_bwd_reference_gives_fully_masked_rows_no_gradient():
    """Query rows with no visible key: p = 0 in the plain backward (the JAX
    kernels' where(mask, exp(s - lse), 0)), whatever dO they receive."""
    B, H, T, d = 1, 2, 12, 16
    q, k, v = (torch.as_tensor(x) for x in _qkv(11, B, H, H, T, d))
    mask = torch.as_tensor(_left_pad_mask(B, T, (4,)))
    out, lse = tfa.flash_attention_reference(q, k, v, mask, True)
    dout = torch.ones_like(out)
    dd = (dout * out).sum(-1)
    dq, dk, dv = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, True)
    assert torch.count_nonzero(dq[:, :, :4]) == 0
    assert torch.count_nonzero(dk[:, :, :4]) == 0 and torch.count_nonzero(dv[:, :, :4]) == 0
    assert torch.isfinite(dq).all() and torch.count_nonzero(dq[:, :, 4:]) > 0


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


@pytest.mark.parametrize("temperature", [1.0, 1.7])
@pytest.mark.parametrize("N", [40, 7])
def test_fused_gradients_match_jax_kernel(temperature, N):
    """dH and dW through the port's autograd path (its plain backward on the
    CPU) against jax.grad of fused_token_logprob_diff (the JAX dH and dW
    kernels in interpret mode), atol 2e-4 as tests/test_ops; and the head's
    gradient is skipped when the head needs none."""
    rng = np.random.default_rng(12)
    D, V = 32, 257
    hidden = rng.normal(size=(N, D)).astype(np.float32)
    head = (0.3 * rng.normal(size=(D, V))).astype(np.float32)
    targets = rng.integers(0, V, N).astype(np.int32)
    g = rng.normal(size=N).astype(np.float32)
    want = jax.grad(lambda h, w: jnp.sum(j_fused_diff(h, w, jnp.asarray(targets), temperature,
                                                       16, 128) * g), argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(head))
    th = torch.tensor(hidden, requires_grad=True)
    tw = torch.tensor(head, requires_grad=True)
    lp = tfl.fused_token_logprob_diff(th, tw, torch.as_tensor(targets), temperature)
    got = torch.autograd.grad((lp * torch.as_tensor(g)).sum(), (th, tw))
    for a, b, name in zip(got, want, ("dH", "dW")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)
    th2 = torch.tensor(hidden, requires_grad=True)
    lp = tfl.fused_token_logprob_diff(th2, torch.as_tensor(head), torch.as_tensor(targets),
                                      temperature)
    (lp * torch.as_tensor(g)).sum().backward()
    torch.testing.assert_close(th2.grad, got[0])


def test_fused_lse_is_logsumexp():
    rng = np.random.default_rng(5)
    h = torch.as_tensor(rng.normal(size=(9, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 130)).astype(np.float32))
    t = torch.as_tensor(rng.integers(0, 130, 9))
    lp, lse = tfl._fwd_call(h, w, t, 1.3)
    torch.testing.assert_close(lse, torch.logsumexp((h @ w) / 1.3, -1))
    torch.testing.assert_close(lp, torch.log_softmax((h @ w) / 1.3, -1)[torch.arange(9), t])


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
