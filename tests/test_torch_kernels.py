"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no jax, so it also runs on a machine with a GPU and no jax:
    python -m pytest --noconftest -q tests/test_torch_kernels.py tests/test_torch_imports.py
(``--noconftest``: tests/conftest.py sets up jax for the JAX package's tests).
Without a GPU the kernel tests skip; the wrappers' CPU-side checks run.
"""

import pytest
import torch

from agilerl_tpu_torch.ops import kernel_counters, reset_kernel_counters
from agilerl_tpu_torch.ops import flash_attention_vjp as tfa
from agilerl_tpu_torch.ops import fused_loss as tfl

torch.set_num_threads(1)

# Decided the same way on every worker: no card, no kernel.
cuda_only = pytest.mark.skipif(not torch.cuda.is_available(),
                               reason="CUDA kernels run only on the GPU")

# f32: the kernel and the plain version differ only in summation order and
# in expf; bf16: the output is rounded to bf16 (2^-9 relative) and p is
# rounded to bf16 against the kernel's running max, not the global max.
FLASH_ATOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_fwd_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_logprob_fwd_cuda(torch.randn(2, 4), torch.randn(4, 3), torch.tensor([0, 1]))


def _flash_case(B, H, Hkv, T, d, dtype, pad_rows, strided, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if strided:  # [B, T, H, d] storage seen as [B, H, T, d], as the model passes it
        q = torch.randn(B, T, H, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
        k = torch.randn(B, T, Hkv, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
        v = torch.randn(B, T, Hkv, d, device="cuda", generator=g).to(dtype).transpose(1, 2)
    else:
        q = torch.randn(B, H, T, d, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
        v = torch.randn(B, Hkv, T, d, device="cuda", generator=g).to(dtype)
    mask = None
    if pad_rows:
        mask = torch.ones(B, T, dtype=torch.int32, device="cuda")
        for b, p in enumerate(pad_rows):
            mask[b, :p] = 0
    return q, k, v, mask


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pad_rows,strided", [(None, False), ((0, 37), False), ((5, 0), True)])
@pytest.mark.parametrize("T,d", [(200, 128), (64, 64)])
def test_flash_kernel_matches_plain(dtype, causal, pad_rows, strided, T, d):
    q, k, v, mask = _flash_case(2, 4, 2, T, d, dtype, pad_rows, strided)
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert out.shape == q.shape and out.dtype == dtype and lse.shape == q.shape[:3]
    rows = torch.ones(q.shape[0], T, dtype=torch.bool, device="cuda") if mask is None \
        else mask.bool()
    for b in range(q.shape[0]):  # real query rows only
        r = rows[b]
        torch.testing.assert_close(out[b][:, r].float(), ref[b][:, r].float(), rtol=0,
                                   atol=FLASH_ATOL[dtype])
        torch.testing.assert_close(lse[b][:, r], ref_lse[b][:, r], rtol=0, atol=1e-4)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()


@pytest.mark.cuda
@cuda_only
@pytest.mark.parametrize("N,V,temperature", [(300, 50_257, 1.0), (300, 50_257, 1.7),
                                             (129, 1000, 1.0), (1, 128, 0.5)])
def test_fused_kernel_matches_plain(N, V, temperature):
    g = torch.Generator(device="cuda").manual_seed(0)
    D = 512
    h = torch.randn(N, D, device="cuda", generator=g)
    w = 0.05 * torch.randn(D, V, device="cuda", generator=g)
    t = torch.randint(0, V, (N,), device="cuda", generator=g)
    got, lse = tfl.fused_logprob_fwd_cuda(h, w, t, temperature)
    want, want_lse = tfl._plain_fwd(h, w, t, temperature)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)


@pytest.mark.cuda
@cuda_only
def test_wrappers_count_kernel_launches_only():
    reset_kernel_counters()
    q, k, v, mask = _flash_case(1, 2, 2, 32, 64, torch.bfloat16, (3,), False)
    tfa.flash_attention_diff(q, k, v, mask)
    tfa.flash_attention_reference(q, k, v, mask)
    h = torch.randn(4, 64, device="cuda")
    w = torch.randn(64, 300, device="cuda")
    tfl.fused_token_logprob(h, w, torch.tensor([1, 2, 3, 4], device="cuda"))
    tfl.reference_token_logprob(h, w, torch.tensor([1, 2, 3, 4], device="cuda"))
    assert kernel_counters() == {"flash_attention_fwd": 1, "fused_logprob_fwd": 1}


@pytest.mark.cuda
@cuda_only
def test_kernels_raise_when_a_gradient_is_needed():
    q = torch.randn(1, 2, 8, 64, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        tfa.flash_attention_diff(q, q, q)
    h = torch.randn(3, 8, device="cuda", requires_grad=True)
    with pytest.raises(NotImplementedError):
        tfl.fused_token_logprob(h, torch.randn(8, 5, device="cuda"),
                                torch.tensor([0, 1, 2], device="cuda"))
    with torch.no_grad():
        tfa.flash_attention_diff(q, q, q)


@pytest.mark.cuda
@cuda_only
def test_flash_kernel_rejects_unsupported_head_dim():
    q = torch.randn(1, 2, 8, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd_cuda(q, q, q)
