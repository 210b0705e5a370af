"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no jax, so it also runs on a machine with a GPU and no jax:
    python -m pytest --noconftest -q tests/test_torch_kernels.py tests/test_torch_imports.py
(``--noconftest``: tests/conftest.py sets up jax for the JAX package's tests).
Without a GPU the kernel tests skip; the wrappers' CPU-side checks run.
"""

import math

import pytest
import torch

from agilerl_tpu_torch.ops import kernel_counters, reset_kernel_counters
from agilerl_tpu_torch.ops import flash_attention_vjp as tfa
from agilerl_tpu_torch.ops import fused_loss as tfl

torch.set_num_threads(1)



@pytest.fixture
def cuda_only():
    """Skips a kernel test where there is no card. Decided when the test
    runs, not when the module is imported, so every worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernels run only on the GPU")


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


def test_build_target_follows_included_headers(tmp_path, monkeypatch):
    """A library is rebuilt when a header its source includes (directly or
    through another header) changes, not only when the source does."""
    from agilerl_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\nint x;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// v1\n")
    assert _build.local_includes(tmp_path / "k.cu") == [tmp_path / "a.cuh", tmp_path / "b.cuh"]
    before = _build.library_path("k")
    (tmp_path / "b.cuh").write_text("// v2\n")
    assert _build.library_path("k") != before
    assert "-I" in _build.NVCC_FLAGS


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
@pytest.mark.usefixtures("cuda_only")
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
@pytest.mark.usefixtures("cuda_only")
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
@pytest.mark.usefixtures("cuda_only")
def test_wrappers_count_kernel_launches_only():
    reset_kernel_counters()
    q, k, v, mask = _flash_case(1, 2, 2, 32, 64, torch.bfloat16, (3,), False)
    tfa.flash_attention_diff(q, k, v, mask)
    tfa.flash_attention_reference(q, k, v, mask)
    h = torch.randn(4, 64, device="cuda")
    w = torch.randn(64, 300, device="cuda")
    tfl.fused_token_logprob(h, w, torch.tensor([1, 2, 3, 4], device="cuda"))
    tfl.reference_token_logprob(h, w, torch.tensor([1, 2, 3, 4], device="cuda"))
    assert kernel_counters() == {"flash_attention_fwd": 1, "flash_attention_dq": 0,
                                 "flash_attention_dkv": 0, "fused_logprob_fwd": 1,
                                 "fused_logprob_dh": 0, "fused_logprob_dw": 0}


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_kernels_raise_when_a_gradient_is_needed():
    """A gradient on CUDA tensors goes through the backward kernels (the
    plain version is never taken on the card), and a wrapper given what its
    kernel does not take raises instead of falling back."""
    reset_kernel_counters()
    q = torch.randn(1, 2, 8, 64, device="cuda", requires_grad=True)
    tfa.flash_attention_diff(q, q, q).sum().backward()
    h = torch.randn(3, 8, device="cuda", requires_grad=True)
    tfl.fused_token_logprob(h, torch.randn(8, 5, device="cuda"),
                            torch.tensor([0, 1, 2], device="cuda")).sum().backward()
    counts = kernel_counters()
    assert counts["flash_attention_dq"] == 1 and counts["flash_attention_dkv"] == 1
    assert counts["fused_logprob_dh"] == 1 and counts["fused_logprob_dw"] == 0
    q320 = torch.randn(1, 2, 8, 320, device="cuda", requires_grad=True)
    with pytest.raises(ValueError, match="head_dim 320 exceeds"):
        tfa.flash_attention_diff(q320, q320, q320)


def _bwd_case(dtype, causal, pad_rows, strided, T, d, H, Hkv, with_lse, seed=0):
    q, k, v, mask = _flash_case(2, H, Hkv, T, d, dtype, pad_rows, strided, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    dd = (dout.float() * out.float()).sum(-1)
    if with_lse:
        dd = dd - torch.randn(lse.shape, device="cuda", generator=g)
    return q, k, v, mask, dout, lse, dd.contiguous()


def _close(got, want, dtype, what):
    """f32: the repo's flash-gradient tolerance (5e-4; summation order).
    bf16: 1 % of the output's largest magnitude (one bf16 rounding of the
    output, and of p/dS where their f32 values straddle a bf16 step)."""
    want = want.float()
    atol = 5e-4 if dtype == torch.float32 else 1e-2 * want.abs().max().item()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol, msg=what)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("pad_rows,strided", [(None, False), ((0, 37), False), ((5, 0), True)])
@pytest.mark.parametrize("T,d,H,Hkv", [(200, 128, 8, 2), (64, 64, 4, 2), (77, 128, 2, 2)])
@pytest.mark.parametrize("with_lse", [False, True])
def test_flash_bwd_kernels_match_plain(dtype, causal, pad_rows, strided, T, d, H, Hkv, with_lse):
    q, k, v, mask, dout, lse, dd = _bwd_case(dtype, causal, pad_rows, strided, T, d, H, Hkv,
                                             with_lse)
    dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, causal)
    dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, causal)
    rq, rk, rv = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, causal)
    torch.cuda.synchronize()
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    for got, want, what in ((dq, rq, "dq"), (dk, rk, "dk"), (dv, rv, "dv")):
        assert torch.isfinite(got.float()).all(), what
        _close(got, want, dtype, what)


# bf16 backward cases of the wgmma kernels beyond the grid above: long T
# (accumulation over 32 tile products per output tile, 4 heads per GQA
# group), a kv tile with every key masked (dK/dV writes zeros, dQ skips it)
# beside interior and left padding, first visible keys on the edge of the
# skip rule, and the model's strided transpose(1, 2)
# views at llama3-8b's GQA 32/8 with the learn step's left padding.
BF16_BWD_CASES = {
    "T2048_d128": dict(B=1, H=8, Hkv=2, T=2048, d=128, pads=None, strided=False),
    "T2048_d64": dict(B=1, H=4, Hkv=1, T=2048, d=64, pads=None, strided=False),
    "masked_kv_tile": dict(B=2, H=4, Hkv=2, T=200, d=128, pads=(150, 0), strided=False,
                           hole=(64, 128)),
    # first visible keys on a q tile's last row (63, 127) and only the last key
    "first_key_on_tile_edges": dict(B=3, H=4, Hkv=2, T=200, d=64, pads=(63, 199, 127),
                                    strided=False),
    "model_views_gqa_32_8": dict(B=4, H=32, Hkv=8, T=320, d=128, pads=(192, 128, 56, 0),
                                 strided=True),
}


def _bf16_bwd_case(name, causal, seed=0):
    c = BF16_BWD_CASES[name]
    q, k, v, mask = _flash_case(c["B"], c["H"], c["Hkv"], c["T"], c["d"], torch.bfloat16,
                                c["pads"], c["strided"], seed)
    if "hole" in c:  # row 1: keys 64..127, one whole kv tile, are padding
        mask[1, c["hole"][0]:c["hole"][1]] = 0
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(torch.bfloat16)
    dd = (dout.float() * out.float()).sum(-1).contiguous()
    return q, k, v, mask, dout, lse, dd


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(BF16_BWD_CASES))
def test_flash_bwd_bf16_long_masked_and_model_views(name, causal):
    q, k, v, mask, dout, lse, dd = _bf16_bwd_case(name, causal)
    dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, causal)
    dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, causal)
    rq, rk, rv = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, causal)
    torch.cuda.synchronize()
    for got, want, what in ((dq, rq, "dq"), (dk, rk, "dk"), (dv, rv, "dv")):
        assert torch.isfinite(got.float()).all(), what
        _close(got, want, torch.bfloat16, f"{name} {what}")
    if "hole" in BF16_BWD_CASES[name]:  # the all-padding kv tile gets exact zeros
        assert not dk[1, :, 64:128].any() and not dv[1, :, 64:128].any()


def _rows_with_a_visible_key(mask, causal, B, T):
    """[B, 1, T] bool: query rows that see at least one key."""
    return tfa._visible(T, mask, causal, torch.device("cuda")).expand(B, 1, T, T).any(-1)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("name", list(BF16_BWD_CASES))
def test_flash_fwd_bf16_long_masked_and_model_views(name, causal):
    """The bf16 forward on the backward's cases: T = 2048 at d = 128 and 64,
    a kv tile of padding beside left padding that covers whole q tiles
    (which then visit no kv tile), first visible keys on the skip rule's
    edges, and the model's strided views at GQA 32/8. Rows with a visible
    key against the plain version; the others come out 0 with lse =
    -1e30 + log(1e-30); every row finite."""
    c = BF16_BWD_CASES[name]
    q, k, v, mask = _flash_case(c["B"], c["H"], c["Hkv"], c["T"], c["d"], torch.bfloat16,
                                c["pads"], c["strided"])
    if "hole" in c:
        mask[1, c["hole"][0]:c["hole"][1]] = 0
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, causal)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    r = _rows_with_a_visible_key(mask, causal, c["B"], c["T"]).expand(lse.shape)
    torch.testing.assert_close(out[r].float(), ref[r].float(), rtol=0,
                               atol=FLASH_ATOL[torch.bfloat16])
    torch.testing.assert_close(lse[r], ref_lse[r], rtol=0, atol=1e-4)
    assert not out[~r].any()
    assert (lse[~r] == torch.tensor(-1e30, dtype=torch.float32) + math.log(1e-30)).all()


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_flash_fwd_bf16_is_deterministic():
    """Two launches of the bf16 forward give bit-identical out and lse."""
    c = BF16_BWD_CASES["model_views_gqa_32_8"]
    q, k, v, mask = _flash_case(c["B"], c["H"], c["Hkv"], c["T"], c["d"], torch.bfloat16,
                                c["pads"], c["strided"])
    runs = [tfa.flash_attention_fwd_cuda(q, k, v, mask, True) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_flash_bwd_bf16_is_deterministic():
    """Two launches give bit-identical dQ, dK and dV: every output tile is
    summed by one block in a fixed order (no atomics)."""
    q, k, v, mask, dout, lse, dd = _bf16_bwd_case("model_views_gqa_32_8", True)
    runs = [(tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True),
             *tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True))
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("N,V,temperature", [(300, 50_257, 1.0), (300, 50_257, 1.7),
                                             (129, 1000, 1.0), (1, 128, 0.5)])
def test_fused_bwd_kernels_match_plain(N, V, temperature):
    """f32 at the repo's fused-gradient tolerance, 2e-4 (summation order)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    D = 512
    h = torch.randn(N, D, device="cuda", generator=g)
    w = 0.05 * torch.randn(D, V, device="cuda", generator=g)
    t = torch.randint(0, V, (N,), device="cuda", generator=g)
    up = torch.randn(N, device="cuda", generator=g)
    _, lse = tfl.fused_logprob_fwd_cuda(h, w, t, temperature)
    dh = tfl.fused_logprob_dh_cuda(h, w, t, lse, up, temperature)
    dw = tfl.fused_logprob_dw_cuda(h, w, t, lse, up, temperature)
    want_dh = tfl.plain_dh(h, w, t, lse, up, temperature)
    want_dw = tfl.plain_dw(h, w, t, lse, up, temperature)
    torch.cuda.synchronize()
    torch.testing.assert_close(dh, want_dh, rtol=0, atol=2e-4)
    torch.testing.assert_close(dw, want_dw, rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("temperature", [1.0, 1.7])
@pytest.mark.parametrize("N", [1, 65, 129, 300])
def test_fused_tensor_core_kernels_ragged_shapes(N, temperature):
    """The 3xTF32 forward, dH and dW at ragged edges: N below, at and past
    one 128-row tile (for dW, the contraction: N is no multiple of the
    32-deep stage and its transposed operands' rows are padded), V = 50,257
    (no multiple of the 128-column tile), and D = 200 (a multiple of 8, not
    of the 32-deep stage). Forward at 1e-4, dH and dW at 2e-4, against the
    plain f32 versions."""
    g = torch.Generator(device="cuda").manual_seed(N)
    D, V = 200, 50_257
    h = torch.randn(N, D, device="cuda", generator=g)
    w = 0.05 * torch.randn(D, V, device="cuda", generator=g)
    t = torch.randint(0, V, (N,), device="cuda", generator=g)
    up = torch.randn(N, device="cuda", generator=g)
    got, lse = tfl.fused_logprob_fwd_cuda(h, w, t, temperature)
    want, want_lse = tfl._plain_fwd(h, w, t, temperature)
    dh = tfl.fused_logprob_dh_cuda(h, w, t, want_lse, up, temperature)
    want_dh = tfl.plain_dh(h, w, t, want_lse, up, temperature)
    dw = tfl.fused_logprob_dw_cuda(h, w, t, want_lse, up, temperature)
    want_dw = tfl.plain_dw(h, w, t, want_lse, up, temperature)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(dh, want_dh, rtol=0, atol=2e-4)
    torch.testing.assert_close(dw, want_dw, rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("transpose,ld", [(False, 0), (False, 204), (True, 0), (True, 304)])
def test_tf32_split_kernel_is_bit_exact(transpose, ld):
    """tf32x3_split on the card gives the plain split_tf32's bits, plain and
    transposed, padding columns past the source with zeros."""
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(300, 201, device="cuda", generator=g) * 10.0 ** torch.randint(
        -5, 5, (300, 201), device="cuda", generator=g)
    hi, lo = tfl._split_cuda(x, transpose=transpose, ld=ld)
    want_hi, want_lo = tfl.split_tf32(x, transpose=transpose, ld=ld)
    torch.cuda.synchronize()
    assert torch.equal(hi, want_hi) and torch.equal(lo, want_lo)
    if ld:
        cols = 300 if transpose else 201
        assert not hi[:, cols:].any() and not lo[:, cols:].any()


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_autograd_gradients_match_plain_path():
    """Gradients through flash_attention_with_lse (both outputs) and
    fused_token_logprob_diff on the card equal the same calls on the CPU,
    whose plain versions the CPU tests hold against the JAX package."""
    q, k, v, mask = _flash_case(2, 4, 2, 96, 64, torch.float32, (0, 21), True, seed=3)
    g = torch.Generator(device="cuda").manual_seed(4)
    wo = torch.randn(q.shape, device="cuda", generator=g)
    wl = torch.randn(q.shape[:3], device="cuda", generator=g)
    rows = mask.bool()[:, None, :, None]

    def grads(q, k, v, mask, wo, wl, rows):
        q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
        out, lse = tfa.flash_attention_with_lse(q, k, v, mask, True)
        loss = (out * wo * rows).sum() + (lse * wl * rows[..., 0]).sum()
        return torch.autograd.grad(loss, (q, k, v))

    got = grads(q, k, v, mask, wo, wl, rows)
    want = grads(*(t.cpu() for t in (q, k, v, mask, wo, wl, rows)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=5e-4)

    h = torch.randn(40, 64, device="cuda", generator=g, requires_grad=True)
    w = (0.05 * torch.randn(64, 300, device="cuda", generator=g)).requires_grad_(True)
    t = torch.randint(0, 300, (40,), device="cuda", generator=g)
    got = torch.autograd.grad(tfl.fused_token_logprob_diff(h, w, t, 1.3).sum(), (h, w))
    hc, wc = h.detach().cpu().requires_grad_(True), w.detach().cpu().requires_grad_(True)
    want = torch.autograd.grad(tfl.fused_token_logprob_diff(hc, wc, t.cpu(), 1.3).sum(), (hc, wc))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_flash_kernel_rejects_unsupported_head_dim():
    """Head dims past 256, the kernels' limit, raise; every smaller one runs
    (``test_flash_kernels_at_every_head_dim``)."""
    q = torch.randn(1, 2, 8, 320, device="cuda")
    with pytest.raises(ValueError, match="head_dim 320 exceeds"):
        tfa.flash_attention_fwd_cuda(q, q, q)


# Head dims the kernels are not built for (run zero-padded to 64, 128 or
# 256) and 256 itself: the evolvable GPT's node mutations (68, 72, 80), the
# tutorials' small models (16, 20, 32) and 96.
PADDED_HEAD_DIMS = (16, 20, 32, 68, 72, 80, 96, 256)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
def test_flash_kernels_at_every_head_dim(d, dtype):
    """Forward, dQ and dK/dV at head dims past the built 64 / 128, with a
    ragged mask, GQA 4/2 and causal masking, against the plain versions at
    the true d (rows with a visible key; the tolerances above); each launch
    counted, and bf16 repeats bit-identical."""
    q, k, v, mask = _flash_case(2, 4, 2, 150, d, dtype, (0, 37), True)
    reset_kernel_counters()
    out, lse = tfa.flash_attention_fwd_cuda(q, k, v, mask, True)
    ref, ref_lse = tfa.flash_attention_reference(q, k, v, mask, True)
    g = torch.Generator(device="cuda").manual_seed(1)
    dout = torch.randn(out.shape, device="cuda", generator=g).to(dtype)
    dd = (dout.float() * out.float()).sum(-1).contiguous()
    dq = tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True)
    dk, dv = tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True)
    rq, rk, rv = tfa.flash_attention_bwd_reference(q, k, v, dout, lse, dd, mask, True)
    torch.cuda.synchronize()
    assert kernel_counters()["flash_attention_fwd"] == 1
    assert kernel_counters()["flash_attention_dq"] == kernel_counters()["flash_attention_dkv"] == 1
    assert out.shape == q.shape and dq.shape == q.shape and dk.shape == k.shape
    r = _rows_with_a_visible_key(mask, True, 2, 150).expand(lse.shape)
    torch.testing.assert_close(out[r].float(), ref[r].float(), rtol=0, atol=FLASH_ATOL[dtype])
    torch.testing.assert_close(lse[r], ref_lse[r], rtol=0, atol=1e-4)
    for got, want, what in ((dq, rq, "dq"), (dk, rk, "dk"), (dv, rv, "dv")):
        assert torch.isfinite(got.float()).all(), what
        _close(got, want, dtype, f"d={d} {what}")
    if dtype == torch.bfloat16:
        again = (tfa.flash_attention_fwd_cuda(q, k, v, mask, True)[0],
                 tfa.flash_attention_dq_cuda(q, k, v, dout, lse, dd, mask, True),
                 *tfa.flash_attention_dkv_cuda(q, k, v, dout, lse, dd, mask, True))
        for a, b in zip((out, dq, dk, dv), again):
            assert torch.equal(a, b)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


# DPO-shaped graphs: (model widths, chosen and rejected (B, T, left pads),
# loss and gradient tolerances). f32 at head_dim 64: summation order and the
# fused kernels' 3xTF32 products. bf16 at head_dim 128 (the bf16 wgmma flash
# kernels; the fused head stays f32): phase 3's bf16 rule, 1 % of the largest
# magnitude, for one bf16 rounding of an activation where its f32 value
# straddles a bf16 step, carried through the model.
DPO_GRAPH_CASES = {
    "float32": (dict(n_head=4, n_kv_head=2, d_model=256),
                ((3, 40, (0, 9, 30)), (3, 27, (4, 0, 17))), 1e-5, 1e-3),
    "bfloat16": (dict(n_head=4, n_kv_head=2, d_model=512),
                 ((3, 150, (0, 40, 130)), (3, 97, (10, 0, 70))), 1e-3, 1e-2),
}


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
@pytest.mark.parametrize("dtype", sorted(DPO_GRAPH_CASES))
def test_dpo_update_graph_two_padded_passes(dtype):
    """DPO's update graph: a chosen and a rejected batch of different lengths
    and left padding go through token_logprobs (flash + fused) into one loss,
    differentiated into the adapter once. On the card (the kernels: flash
    forward, dQ, dK/dV and fused forward, dH per pass, no dW) the loss and
    the adapter gradient equal the same graph on the CPU (the plain
    versions): the loss at ``loss_rtol``, the gradient within ``grad_rel`` of
    its largest entry (DPO_GRAPH_CASES)."""
    from agilerl_tpu_torch.algorithms.dpo import DPO, _dpo_loss
    from agilerl_tpu_torch.llm import model as TM
    from agilerl_tpu_torch.utils.tree import tree_leaves, tree_map

    widths, sides, loss_rtol, grad_rel = DPO_GRAPH_CASES[dtype]
    cfg = TM.GPTConfig(vocab_size=1000, n_layer=2, max_seq_len=256, tie_embeddings=False,
                       dtype=getattr(torch, dtype), **widths)
    gc = torch.Generator().manual_seed(0)
    batch = {}
    for side, (B, T, pads) in zip(("chosen", "rejected"), sides):
        mask = torch.ones(B, T, dtype=torch.int32)
        for b, p in enumerate(pads):
            mask[b, :p] = 0
        # completion targets: the second half, real tokens only (as
        # PreferenceGym's loss masks; a query row with no visible key is
        # defined differently by the kernel and the plain version)
        loss_mask = (mask[:, :-1] * mask[:, 1:]).float()
        loss_mask[:, :T // 2] = 0.0
        batch[f"{side}_ids"] = torch.randint(2, 1000, (B, T), generator=gc) * mask
        batch[f"{side}_mask"] = mask
        batch[f"{side}_loss_mask"] = loss_mask
    params = TM.init_params(1, cfg, device="cpu")
    lora = TM.init_lora(2, cfg, rank=4, device="cpu")
    for layer in lora["blocks"].values():
        for ab in layer.values():
            ab["B"].normal_(0.0, 0.05, generator=gc)
    ref = (-torch.rand(3, generator=gc) * 5, -torch.rand(3, generator=gc) * 5)

    def loss_and_grad(device):
        agent = DPO(config=cfg, base_params=_to(params, device), device=device, seed=0)
        seq_logprob = agent._seq_logprob_fn()
        b = _to(batch, device)
        lo = tree_map(lambda t: t.detach().requires_grad_(True), _to(lora, device))
        pol_c, pol_r = seq_logprob(lo, b, "chosen"), seq_logprob(lo, b, "rejected")
        loss, _, _ = _dpo_loss(pol_c, pol_r, *(_to(r, device) for r in ref), 0.5, 0.1)
        grads = torch.autograd.grad(loss, tree_leaves(lo))
        return loss.item(), torch.cat([g.float().flatten() for g in grads]).cpu()

    reset_kernel_counters()
    loss_gpu, g_gpu = loss_and_grad("cuda")
    L = cfg.n_layer
    assert kernel_counters() == {"flash_attention_fwd": 2 * L, "flash_attention_dq": 2 * L,
                                 "flash_attention_dkv": 2 * L, "fused_logprob_fwd": 2,
                                 "fused_logprob_dh": 2, "fused_logprob_dw": 0}
    loss_cpu, g_cpu = loss_and_grad("cpu")
    assert math.isfinite(loss_gpu) and bool(torch.isfinite(g_gpu).all())
    assert loss_gpu == pytest.approx(loss_cpu, rel=loss_rtol)
    torch.testing.assert_close(g_gpu, g_cpu, rtol=0, atol=grad_rel * g_cpu.abs().max().item())


# --------------------------------------------------------------------------- #
# The serving tier on the card (torch ops, no kernel of its own)
# --------------------------------------------------------------------------- #


def _small_serving_model(seed=7):
    from agilerl_tpu_torch.llm import model as TM

    cfg = TM.GPTConfig(vocab_size=1000, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
                       max_seq_len=256, tie_embeddings=False, dtype=torch.float32)
    params = TM.init_params(seed, cfg, device="cpu")
    # wider weights give decisive, varied argmaxes
    params = {k: ({i: {n: (w * 8 if w.dim() == 2 else w) for n, w in b.items()}
                   for i, b in v.items()} if k == "blocks" else v * 8)
              for k, v in params.items()}
    return cfg, params


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_serving_greedy_matches_dense_on_the_card(monkeypatch):
    """f32 small model: continuous (plain and speculative) and bucketed
    greedy serving on the card give dense greedy ``generate``'s tokens, and
    the CPU's."""
    import numpy as np

    from agilerl_tpu_torch.llm import generate as TG
    from agilerl_tpu_torch.llm.serving import BucketedGenerator, ContinuousGenerator
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.utils.tree import tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _small_serving_model()
    gparams = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(0)
    base = [rng.integers(1, 1000, size=n).astype(np.int32) for n in (9, 30, 17, 60)]
    seqs = base + base[:3]  # more requests than slots, prefix hits
    kw = dict(max_new_tokens=12, prompt_buckets=(32, 64), block_size=16, slots=3,
              decode_chunk=4, n_blocks=40)
    dense = {}
    for Pb in (32, 64):
        rows = [i for i, s in enumerate(seqs) if (32 if len(s) <= 32 else 64) == Pb]
        toks, mask = TG.left_pad([seqs[i] for i in rows], 0, Pb)
        comp, _ = TG.generate(cfg, gparams, torch.as_tensor(toks).cuda(),
                              torch.as_tensor(mask).cuda(), None, max_new_tokens=12,
                              temperature=0.0)
        dense.update(zip(rows, comp.cpu().numpy()))
    want = np.stack([dense[i] for i in range(len(seqs))])
    for spec in (None, {"k": 3}):
        outs = {}
        for dev, p in (("cuda", gparams), ("cpu", params)):
            gen = ContinuousGenerator(cfg, metrics=MetricsRegistry(), speculate=spec,
                                      device=dev, **kw)
            outs[dev], _, info = gen.generate(seqs, 0, p, greedy=True)
            assert info["prefix_cache_hits"] == 3
            assert gen.allocator.available() == kw["n_blocks"] - 1
        np.testing.assert_array_equal(outs["cuda"], want)
        np.testing.assert_array_equal(outs["cpu"], want)
    bucketed = BucketedGenerator(cfg, max_new_tokens=12, prompt_buckets=(64,),
                                 row_buckets=(8,), decode_chunk=4, device="cuda",
                                 metrics=MetricsRegistry())
    comp, _, _ = bucketed.generate(seqs, None, gparams, greedy=True)
    np.testing.assert_array_equal(comp, want)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_paged_writes_past_the_extent_on_the_card():
    """A released slot whose lengths ran past the logical extent S: the
    paged scatters and the slab insert redirect or drop its writes on CUDA
    (an out-of-range index would device-assert) and agree with the CPU
    outside the garbage block."""
    from agilerl_tpu_torch.llm import model as TM

    cfg, params = _small_serving_model()
    g = torch.Generator().manual_seed(0)
    L, KV, hd, nb, bs = cfg.n_layer, cfg.kv_heads, cfg.head_dim, 10, 4
    pool_k = torch.randn(L, nb, bs, KV, hd, generator=g) * 0.3
    pool_v = torch.randn(L, nb, bs, KV, hd, generator=g) * 0.3
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 0, 0], [0, 0, 0, 0]], dtype=torch.int32)
    S = 4 * bs
    lengths = torch.tensor([6, 3, S + 5], dtype=torch.int32)
    mask = (torch.arange(S)[None] <= lengths[:, None]).int()
    mask[2] = 0
    tok = torch.randint(1, cfg.vocab_size, (3, 3), generator=g)
    new_k = torch.randn(L, 3, KV, hd, generator=g)
    new_k3 = torch.randn(L, 3, 3, KV, hd, generator=g)
    wp3 = lengths[:, None] + torch.arange(3)[None]
    wp3[0] += S - 8  # slot 0's window crosses the extent

    def run(dev):
        to = lambda t: t.to(dev)  # noqa: E731
        cache = TM.PagedKVCache(to(pool_k.clone()), to(pool_v.clone()))
        TM.paged_scatter_tokens(cache, to(tables), to(lengths), to(new_k), to(new_k))
        TM.paged_scatter_multi(cache, to(tables), to(wp3), to(new_k3), to(new_k3))
        p = {k: ({i: {n: to(w) for n, w in b.items()} for i, b in v.items()}
                 if k == "blocks" else to(v)) for k, v in params.items()}
        hidden, (nk, _) = TM.forward_paged(cfg, p, to(tok), to(wp3), to(wp3), cache,
                                           to(tables), to(mask))
        if dev == "cuda":
            torch.cuda.synchronize()  # surfaces a device assert here
        return cache.k[:, 1:].cpu(), hidden[:2].cpu(), nk.cpu()

    for a, b in zip(run("cuda"), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_fleet_greedy_on_the_card_matches_the_cpu(monkeypatch, tmp_path):
    """f32 small model: the unified fleet, the disaggregated fleet (prompt KV
    through the transfer store) and a fleet after kill_replica give the same
    greedy tokens on the card as on the CPU, and as one generator."""
    import numpy as np

    from agilerl_tpu_torch.llm.fleet import ServingFleet
    from agilerl_tpu_torch.llm.serving import ContinuousGenerator
    from agilerl_tpu_torch.observability import MetricsRegistry
    from agilerl_tpu_torch.utils.tree import tree_map

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, params = _small_serving_model()
    gparams = tree_map(lambda t: t.cuda(), params)
    rng = np.random.default_rng(1)
    base = [rng.integers(1, 1000, size=n).astype(np.int32) for n in (9, 30, 17, 60)]
    seqs = base + base[:3]
    kw = dict(max_new_tokens=12, prompt_buckets=(32, 64), block_size=16, slots=3,
              decode_chunk=4)
    rows = {}
    for dev, p in (("cuda", gparams), ("cpu", params)):
        gen = ContinuousGenerator(cfg, metrics=MetricsRegistry(), device=dev, **kw)
        rows[dev, "single"] = gen.generate(seqs, 0, p, greedy=True)[0]
        fl = ServingFleet(cfg, 2, metrics=MetricsRegistry(), device=dev, **kw)
        rows[dev, "unified"] = fl.generate(seqs, 0, p, greedy=True)[0]
        fl = ServingFleet(cfg, 2, topology="disaggregated", transfer_dir=tmp_path / dev,
                          metrics=MetricsRegistry(), device=dev, **kw)
        rows[dev, "disaggregated"] = fl.generate(seqs, 0, p, greedy=True)[0]
        assert fl.metrics.counter("fleet/kv_imports_total").value > 0
        fl = ServingFleet(cfg, 2, metrics=MetricsRegistry(), device=dev, **kw)
        tickets = [fl.submit(s, key=[i, 0], no_shed=True) for i, s in enumerate(seqs)]
        fl.step(p, greedy=True)
        fl.kill_replica(fl.replica_ids[0])
        fl.run_until_drained(p, greedy=True)
        rows[dev, "failover"] = np.stack([fl.result(t)[0] for t in tickets])
    for name in ("unified", "disaggregated", "failover"):
        for dev in ("cuda", "cpu"):
            np.testing.assert_array_equal(rows[dev, name], rows["cpu", "single"])
    np.testing.assert_array_equal(rows["cuda", "single"], rows["cpu", "single"])


@pytest.mark.cuda
@pytest.mark.usefixtures("cuda_only")
def test_bf16_kv_transfer_round_trip_on_the_card(tmp_path):
    """A bf16 prompt KV computed on the card crosses the transfer store as
    host numpy and lands back on the card bit for bit."""
    from agilerl_tpu_torch.llm.convert import tensor_from_host, tensor_to_host
    from agilerl_tpu_torch.llm.fleet import KVTransferStore
    from agilerl_tpu_torch.observability import MetricsRegistry

    g = torch.Generator(device="cuda").manual_seed(0)
    k = (torch.randn(4, 64, 2, 128, device="cuda", generator=g) * 30).to(torch.bfloat16)
    host, dtype = tensor_to_host(k)
    store = KVTransferStore(tmp_path, metrics=MetricsRegistry())
    path = store.export("transfer_000001", {"k": host, "hashes": []})
    back = tensor_from_host(store.load(path)["k"], dtype, "cuda")
    assert back.device.type == "cuda" and back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), k.view(torch.int16))
