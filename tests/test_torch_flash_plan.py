"""The bf16 flash kernels' tile skipping, on the CPU.

The forward of ``csrc/flash_attention_fwd.cu`` and the dQ and dK/dV kernels
of ``csrc/flash_attention_bwd.cu`` visit a (q tile, kv tile) pair only when
the first visible key of the kv tile says the pair holds a visible key.
``first_visible_keys`` below is the plain version of the table each block
builds from the mask, and ``tile_pairs`` the rule the three kernels apply.
Held here against the plain backward's p: a skipped pair never has p != 0,
and every pair without a visible key is skipped. The plain forward and
backward restricted to the visited pairs are held against the unrestricted
plain versions and against the JAX package's kernels (Pallas interpret
mode). On the card, ``tests/test_torch_kernels.py`` holds the kernels
themselves against the unrestricted plain versions on masks that make them
skip."""

import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from agilerl_tpu.ops.flash_attention_vjp import (  # noqa: E402
    flash_attention_diff, flash_attention_with_lse)
from agilerl_tpu_torch.ops import flash_attention_vjp as tfa  # noqa: E402

torch.set_num_threads(1)

TILE = 64  # BQ = BK of the bf16 kernels


def first_visible_keys(padding_mask, B, T):
    """[B, kv tiles] int32: the first visible key of each 64-key tile, T
    where every key of the tile is masked."""
    nt = -(-T // TILE)
    keys = torch.arange(nt * TILE, dtype=torch.int32)
    visible = (keys < T).expand(B, -1)
    if padding_mask is not None:
        real = torch.zeros(B, nt * TILE, dtype=torch.bool)
        real[:, :T] = padding_mask > 0
        visible = visible & real
    return torch.where(visible, keys, T).view(B, nt, TILE).amin(dim=2).to(torch.int32)


def tile_pairs(first, T, causal):
    """[B, q tiles, kv tiles] bool: the pairs the kernels visit. A kv tile
    counts for a q tile iff its first visible key is at most the q tile's
    last row (causal) or anywhere before T (not causal)."""
    nt = first.shape[1]
    last_row = (torch.arange(nt) * TILE + TILE - 1).clamp(max=T - 1)
    limit = last_row if causal else torch.full_like(last_row, T - 1)
    return first[:, None, :] <= limit[None, :, None]


def fwd_on_pairs(q, k, v, mask, causal, pairs):
    """The bf16 forward kernel's arithmetic (f32 inputs) over the visited
    pairs only: a score that is masked or outside ``pairs`` gives p = 0 (not
    exp(-1e30 - m)), so a row with no visible key keeps m = -1e30 and l = 0:
    out = 0, lse = -1e30 + log(1e-30)."""
    rep = q.shape[1] // k.shape[1]
    kr, vr = tfa._repeat_kv(k, rep), tfa._repeat_kv(v, rep)
    s = torch.matmul(q, kr.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    keep = tfa._visible(q.shape[2], mask, causal, q.device) & pairs
    s = torch.where(keep, s, tfa._NEG)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.matmul(p, vr) / l, (m + torch.log(l))[..., 0]


def bwd_probs(q, k, lse, mask, causal, pairs=None):
    """The plain backward's p [B, H, T, T] (``flash_attention_bwd_reference``'s
    ``where(visible, exp(s - lse), 0)``), and 0 outside ``pairs`` where given."""
    kr = tfa._repeat_kv(k, q.shape[1] // k.shape[1])
    s = torch.matmul(q, kr.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    visible = tfa._visible(q.shape[2], mask, causal, q.device)
    if pairs is not None:
        visible = visible & pairs
    return torch.where(visible, torch.exp(s - lse[..., None]), 0.0)


def bwd_on_pairs(q, k, v, dout, lse, dd, mask, causal, pairs):
    """``flash_attention_bwd_reference`` (f32 inputs) with p = 0 outside
    ``pairs``: the backward of the visited pairs only."""
    rep = q.shape[1] // k.shape[1]
    kr, vr = tfa._repeat_kv(k, rep), tfa._repeat_kv(v, rep)
    p = bwd_probs(q, k, lse, mask, causal, pairs)
    ds = p * (torch.matmul(dout, vr.transpose(-1, -2)) - dd[..., None])
    scale = 1.0 / math.sqrt(q.shape[-1])
    B, Hkv, T, d = k.shape
    dk = (torch.matmul(ds.transpose(-1, -2), q) * scale).view(B, Hkv, rep, T, d).sum(2)
    dv = torch.matmul(p.transpose(-1, -2), dout).view(B, Hkv, rep, T, d).sum(2)
    return torch.matmul(ds, kr) * scale, dk, dv


def _mask(kind, B, T, rng):
    """[B, T] int32 key padding masks of one kind."""
    m = np.ones((B, T), np.int32)
    if kind == "left_pad":
        for b in range(B):
            m[b, :int(rng.integers(0, T))] = 0
    elif kind == "all_masked_row":
        m[0] = 0
        m[1, :int(rng.integers(T // 2, T))] = 0
    elif kind == "holes":
        for b in range(B):
            for _ in range(3):
                a = int(rng.integers(0, T))
                m[b, a:a + int(rng.integers(1, 2 * TILE))] = 0
    elif kind == "random":
        m = (rng.random((B, T)) < 0.15).astype(np.int32)
    elif kind == "edges":  # first visible keys on a q tile's last row, and the last key
        m[0, :TILE - 1] = 0
        m[1, :T - 1] = 0
        m[2, :min(2 * TILE - 1, T - 1)] = 0
    return m


def _tile_any(x, T):
    """[B, H, T, T] bool -> [B, q tiles, kv tiles]: any element of each pair."""
    nt = -(-T // TILE)
    pad = torch.zeros(x.shape[0], x.shape[1], nt * TILE, nt * TILE, dtype=torch.bool)
    pad[:, :, :T, :T] = x
    return pad.view(x.shape[0], x.shape[1], nt, TILE, nt, TILE).any(dim=(1, 3, 5))


def _elements(pairs, T):
    """[B, q tiles, kv tiles] bool -> [B, 1, T, T] bool over the elements."""
    full = pairs.repeat_interleave(TILE, dim=1).repeat_interleave(TILE, dim=2)
    return full[:, None, :T, :T]


def _inputs(seed, B, H, Hkv, T, d):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (torch.as_tensor(rng.normal(size=(B, n, T, d)).astype(np.float32))
                     for n in (H, Hkv, Hkv, H))
    return q, k, v, dout


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["none", "left_pad", "all_masked_row", "holes", "random",
                                  "edges"])
@pytest.mark.parametrize("T", [77, 130, 320])
def test_plan_skips_exactly_the_pairs_without_a_visible_key(T, kind, causal):
    B, H, Hkv, d = 3, 2, 1, 16
    rng = np.random.default_rng(T + 7 * len(kind) + causal)
    mask = None if kind == "none" else torch.as_tensor(_mask(kind, B, T, rng))
    q, k, v, dout = _inputs(T, B, H, Hkv, T, d)
    _, lse = tfa.flash_attention_reference(q, k, v, mask, causal)
    first = first_visible_keys(mask, B, T)
    nt = -(-T // TILE)
    assert first.shape == (B, nt) and first.dtype == torch.int32
    visited = tile_pairs(first, T, causal)

    visible = tfa._visible(T, mask, causal, q.device).expand(B, 1, T, T)
    has_visible = _tile_any(visible, T)
    p = bwd_probs(q, k, lse, mask, causal)
    p_nonzero = _tile_any(p != 0, T)
    assert not (p_nonzero & ~visited).any(), "a skipped pair has p != 0"
    assert torch.equal(visited, has_visible), "visited pairs != pairs with a visible key"
    # a kv tile that no q tile visits is one whose dK/dV block writes zeros
    empty = first >= T
    assert torch.equal(empty, ~has_visible.any(dim=1))
    if kind == "all_masked_row":
        assert not visited[0].any()


@pytest.mark.parametrize("T", [77, 200, 320, 2048])
def test_plan_without_mask_visits_every_causal_pair(T):
    nt = -(-T // TILE)
    first = first_visible_keys(None, 2, T)
    assert first.tolist() == [list(range(0, nt * TILE, TILE))] * 2
    pairs = tile_pairs(first, T, True)
    assert torch.equal(pairs[0], torch.tril(torch.ones(nt, nt, dtype=torch.bool)))
    assert tile_pairs(first, T, False).all()


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_on_visited_pairs_matches_jax_kernel(causal):
    """Left padding past one tile, a kv tile of interior padding and a fully
    masked row: the plain backward with p set to 0 outside the visited pairs
    against jax.grad of the JAX kernels at 5e-4 (tests/test_ops' flash
    gradient tolerance)."""
    B, H, Hkv, T, d = 3, 2, 1, 150, 16
    mask = np.ones((B, T), np.int32)
    mask[0, :70] = 0            # kv tile 0 all padding, tile 1 partly
    mask[1, 64:128] = 0         # kv tile 1 all padding, inside the row
    mask[2, :] = 0              # no visible key at all
    q, k, v, _ = _inputs(21, B, H, Hkv, T, d)
    tm = torch.as_tensor(mask)
    rows = torch.as_tensor(mask, dtype=torch.float32)  # padded rows' outputs are garbage
    wo = torch.as_tensor(np.random.default_rng(22).normal(size=(B, H, T, d)).astype(np.float32))
    wo = wo * rows[:, None, :, None]

    visited = tile_pairs(first_visible_keys(tm, B, T), T, causal)
    assert not visited.all(), "the mask must make the plan skip pairs"
    out, lse = tfa.flash_attention_reference(q, k, v, tm, causal)
    dd = (wo * out).sum(-1)
    got = bwd_on_pairs(q, k, v, wo, lse, dd, tm, causal, _elements(visited, T))
    full = tfa.flash_attention_bwd_reference(q, k, v, wo, lse, dd, tm, causal)
    for g, f in zip(got, full):  # skipping the pairs leaves the plain backward as it is
        torch.testing.assert_close(g, f, rtol=0, atol=1e-5)

    def loss(q, k, v):  # the JAX kernels take repeated K/V; the repeat sums the group
        kr, vr = jnp.repeat(k, H // Hkv, axis=1), jnp.repeat(v, H // Hkv, axis=1)
        return jnp.sum(flash_attention_diff(q, kr, vr, jnp.asarray(mask), causal, 16, 16)
                       * jnp.asarray(wo.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, err_msg=name)
    assert float(got[2].abs().sum()) > 0


def _rows_with_a_visible_key(mask, causal, B, T):
    """[B, T] bool: query rows that see at least one key."""
    return tfa._visible(T, mask, causal, torch.device("cpu")).expand(B, 1, T, T)[:, 0].any(-1)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["none", "left_pad", "all_masked_row", "holes", "random",
                                  "edges"])
@pytest.mark.parametrize("T", [77, 130, 320])
def test_forward_on_visited_pairs_equals_plain_forward(T, kind, causal):
    """The forward's skip rule: a q tile visits the kv tiles of tile_pairs,
    and a q tile that visits none is one whose rows all lack a visible key.
    Restricted to the visited pairs, the plain forward equals the
    unrestricted one on rows with a visible key (the skipped pairs add
    exp(-1e30 - m) = 0 there) and gives out = 0, lse = -1e30 + log(1e-30)
    on the rest."""
    B, H, Hkv, d = 3, 2, 1, 16
    rng = np.random.default_rng(T + 7 * len(kind) + causal)
    mask = None if kind == "none" else torch.as_tensor(_mask(kind, B, T, rng))
    q, k, v, _ = _inputs(T + 1, B, H, Hkv, T, d)
    visited = tile_pairs(first_visible_keys(mask, B, T), T, causal)
    rows = _rows_with_a_visible_key(mask, causal, B, T)
    nt = -(-T // TILE)
    tile_rows = torch.zeros(B, nt * TILE, dtype=torch.bool)
    tile_rows[:, :T] = rows
    assert torch.equal(~visited.any(dim=2), ~tile_rows.view(B, nt, TILE).any(dim=2))

    out, lse = fwd_on_pairs(q, k, v, mask, causal, _elements(visited, T))
    want, want_lse = tfa.flash_attention_reference(q, k, v, mask, causal)
    r = rows[:, None, :].expand(B, H, T)
    torch.testing.assert_close(out[r], want[r], rtol=0, atol=1e-6)
    torch.testing.assert_close(lse[r], want_lse[r], rtol=0, atol=1e-6)
    assert not out[~r].any()
    empty_lse = torch.tensor(tfa._NEG, dtype=torch.float32) + math.log(1e-30)
    assert torch.equal(lse[~r], empty_lse.expand(int((~r).sum())))
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["none", "left_pad", "all_masked_row", "holes", "random",
                                  "edges"])
def test_forward_on_visited_pairs_matches_jax_kernel(kind, causal):
    """The plain forward restricted to the visited pairs against the JAX
    package's forward kernel (interpret mode) at tests/test_ops' flash
    forward tolerance, 2e-5, on rows with a visible key (the JAX kernel
    gives the others the mean of v over their masked keys)."""
    B, H, Hkv, T, d = 3, 2, 1, 130, 16
    rng = np.random.default_rng(31 + len(kind) + causal)
    mask = None if kind == "none" else _mask(kind, B, T, rng)
    tm = None if mask is None else torch.as_tensor(mask)
    q, k, v, _ = _inputs(32, B, H, Hkv, T, d)
    visited = tile_pairs(first_visible_keys(tm, B, T), T, causal)
    out, lse = fwd_on_pairs(q, k, v, tm, causal, _elements(visited, T))
    kr, vr = (jnp.repeat(jnp.asarray(t.numpy()), H // Hkv, axis=1) for t in (k, v))
    jo, jl = flash_attention_with_lse(jnp.asarray(q.numpy()), kr, vr,
                                      None if mask is None else jnp.asarray(mask), causal, 64, 64)
    r = _rows_with_a_visible_key(tm, causal, B, T)[:, None, :].expand(B, H, T).numpy()
    np.testing.assert_allclose(out.numpy()[r], np.asarray(jo)[r], rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy()[r], np.asarray(jl)[r], rtol=0, atol=2e-5)


@pytest.mark.parametrize("d", [272, 512])
def test_wide_head_dims_match_jax_kernels(d):
    """Head dims past 256 (the wide kernels on the card; on the CPU the
    plain versions at the true d): the port's ``flash_attention_with_lse``
    and its gradients through ``flash_attention_diff``, GQA 2 over 1 KV
    head, causal, a ragged mask, against the JAX package's kernels (Pallas
    interpret mode): forward at 2e-5 on rows with a visible key, gradients
    at 5e-4 (tests/test_ops' flash tolerances)."""
    B, H, Hkv, T = 1, 2, 1, 64
    mask = np.ones((B, T), np.int32)
    mask[0, :13] = 0
    q, k, v, wo = _inputs(d, B, H, Hkv, T, d)
    tm = torch.as_tensor(mask)
    r = _rows_with_a_visible_key(tm, True, B, T)[:, None, :].expand(B, H, T)
    wo = wo * r[..., None]
    out, lse = tfa.flash_attention_with_lse(q, k, v, tm, True)
    kr, vr = (jnp.repeat(jnp.asarray(t.numpy()), H // Hkv, axis=1) for t in (k, v))
    jo, jl = flash_attention_with_lse(jnp.asarray(q.numpy()), kr, vr, jnp.asarray(mask), True,
                                      64, 64)
    rn = r.numpy()
    np.testing.assert_allclose(out.numpy()[rn], np.asarray(jo)[rn], rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy()[rn], np.asarray(jl)[rn], rtol=0, atol=2e-5)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    (tfa.flash_attention_diff(*leaves, tm, True) * wo).sum().backward()

    def loss(q, k, v):  # the JAX kernels take repeated K/V; the repeat sums the group
        kr, vr = jnp.repeat(k, H // Hkv, axis=1), jnp.repeat(v, H // Hkv, axis=1)
        return jnp.sum(flash_attention_diff(q, kr, vr, jnp.asarray(mask), True, 64, 64)
                       * jnp.asarray(wo.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for t, w, name in zip(leaves, want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=5e-4, err_msg=name)


def fwd_split_d(q, k, v, mask, causal):
    """The arithmetic of the bf16 wide forward (``csrc/flash_attention_fwd.cu``,
    ``flash_fwd_split_kernel``): warpgroup 0 owns the first ceil(nc / 2) of
    the nc = d / 64 boxes of d, warpgroup 1 the rest. Each computes its
    partial S over its own boxes and both form S = S_0 + S_1. Over the
    visited 64-key tiles, in order, both run the same online softmax in
    log2 units (p = 0 where a score is masked), and each adds p, rounded to
    the input dtype, times its own columns of V. Returns out (the two
    warpgroups' columns side by side) and lse, as the kernel writes them."""
    B, H, T, d = q.shape
    rep = H // k.shape[1]
    qf, kr, vr = q.float(), tfa._repeat_kv(k, rep).float(), tfa._repeat_kv(v, rep).float()
    split = 64 * ((d // 64 + 1) // 2)
    cols = (slice(0, split), slice(split, d))
    s0, s1 = (torch.matmul(qf[..., c], kr[..., c].transpose(-1, -2)) for c in cols)
    s = s0 + s1
    keep = tfa._visible(T, mask, causal, q.device) & _elements(
        tile_pairs(first_visible_keys(mask, B, T), T, causal), T)
    scale2 = 1.0 / math.sqrt(d) * math.log2(math.e)
    m = torch.full((B, H, T, 1), tfa._NEG)
    l = torch.zeros(B, H, T, 1)
    o = [torch.zeros(B, H, T, c.stop - c.start) for c in cols]
    for k0 in range(0, T, TILE):
        keys = slice(k0, min(k0 + TILE, T))
        seen = keep[..., keys]
        st = torch.where(seen, s[..., keys] * scale2, tfa._NEG)
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(seen, torch.exp2(st - m_new), 0.0)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        m = m_new
        pr = p.to(q.dtype).float()
        o = [ow * alpha + torch.matmul(pr, vr[..., keys, c]) for ow, c in zip(o, cols)]
    lc = l.clamp_min(1e-30)
    lse = torch.where(m == tfa._NEG, tfa._NEG, m * math.log(2.0)) + torch.log(lc)
    return torch.cat([ow / lc for ow in o], dim=-1).to(q.dtype), lse[..., 0]


@pytest.mark.parametrize("d", [320, 512])
def test_split_d_forward_matches_jax_kernel(d):
    """The split-d forward model (3 + 2 boxes at d = 320, 4 + 4 at 512), GQA
    2 over 1 KV head, causal, a ragged mask (row 1's first q tile sees no
    key, so it visits no kv tile): in f32 against the JAX package's forward
    kernel (Pallas interpret mode) at 2e-5 (tests/test_ops' flash forward
    tolerance) and against the port's plain forward at 1e-5 (f32 summation
    order, an online max), on rows with a visible key; out = 0 and lse =
    -1e30 + log(1e-30) on the others; in bf16 against the plain forward at 1 %
    of the largest magnitude (chip_smoke's bf16 bound: p is rounded at the
    running max, not the row's)."""
    B, H, Hkv, T = 2, 2, 1, 130
    mask = np.ones((B, T), np.int32)
    mask[0, :13] = 0
    mask[1, :70] = 0
    q, k, v, _ = _inputs(d + 2, B, H, Hkv, T, d)
    tm = torch.as_tensor(mask)
    r = _rows_with_a_visible_key(tm, True, B, T)[:, None, :].expand(B, H, T)
    out, lse = fwd_split_d(q, k, v, tm, True)
    want, want_lse = tfa.flash_attention_reference(q, k, v, tm, True)
    torch.testing.assert_close(out[r], want[r], rtol=0, atol=1e-5)
    torch.testing.assert_close(lse[r], want_lse[r], rtol=0, atol=1e-5)
    assert not out[~r].any()
    empty_lse = torch.tensor(tfa._NEG, dtype=torch.float32) + math.log(1e-30)
    assert torch.equal(lse[~r], empty_lse.expand(int((~r).sum())))

    kr, vr = (jnp.repeat(jnp.asarray(t.numpy()), H // Hkv, axis=1) for t in (k, v))
    jo, jl = flash_attention_with_lse(jnp.asarray(q.numpy()), kr, vr, jnp.asarray(mask), True,
                                      64, 64)
    rn = r.numpy()
    np.testing.assert_allclose(out.numpy()[rn], np.asarray(jo)[rn], rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy()[rn], np.asarray(jl)[rn], rtol=0, atol=2e-5)

    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    out_b, lse_b = fwd_split_d(qb, kb, vb, tm, True)
    want_b, want_lse_b = tfa.flash_attention_reference(qb, kb, vb, tm, True)
    assert out_b.dtype == torch.bfloat16
    tol = 1e-2 * float(want_b[r].float().abs().max())
    assert float((out_b[r].float() - want_b[r].float()).abs().max()) <= tol
    torch.testing.assert_close(lse_b[r], want_lse_b[r], rtol=0, atol=1e-4)


SLICE_COLS = 128  # the columns of d a block of a wide dK/dV cluster owns


def bwd_split_d(q, k, v, dout, lse, dd, mask, causal):
    """The arithmetic of the bf16 wide dK/dV clusters
    (``csrc/flash_attention_bwd.cu``, ``flash_dkv_cluster_kernel``): block r
    of a cluster owns columns [128 r, 128 r + 128) of d. S and dP are the
    sums of the blocks' partial products over their columns, added in rank
    order; P and dS come from the sums and are rounded to the input dtype
    once, for every block alike; each block's columns of dK and dV are
    products of the shared P and dS with its own columns of Q and dO. The
    dQ of the same split (dS with each block's columns of K) is held too."""
    B, H, T, d = q.shape
    Hkv = k.shape[1]
    rep = H // Hkv
    scale = 1.0 / math.sqrt(d)
    kr, vr = tfa._repeat_kv(k, rep).float(), tfa._repeat_kv(v, rep).float()
    qf, of = q.float(), dout.float()
    cols = [slice(c, min(c + SLICE_COLS, d)) for c in range(0, d, SLICE_COLS)]
    s = dp = None
    for sl in cols:  # rank order
        ps = torch.matmul(qf[..., sl], kr[..., sl].transpose(-1, -2))
        pd = torch.matmul(of[..., sl], vr[..., sl].transpose(-1, -2))
        s, dp = (ps, pd) if s is None else (s + ps, dp + pd)
    visible = tfa._visible(T, mask, causal, q.device)
    p = torch.where(visible, torch.exp(s * scale - lse[..., None]), 0.0)
    ds = p * (dp - dd[..., None])
    p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dq = torch.cat([torch.matmul(ds, kr[..., sl]) for sl in cols], -1) * scale
    dk = torch.cat([torch.matmul(ds.transpose(-1, -2), qf[..., sl]) for sl in cols], -1) * scale
    dv = torch.cat([torch.matmul(p.transpose(-1, -2), of[..., sl]) for sl in cols], -1)
    dk, dv = (t.view(B, Hkv, rep, T, d).sum(2) for t in (dk, dv))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("d", [320, 512])
def test_split_d_backward_matches_jax_kernels(d):
    """The split-d model (3 blocks at d = 320, the last owning 64 columns; 4
    at 512), GQA 2 over 1 KV head, causal, a ragged mask: in f32 against
    jax.grad of the JAX kernels (Pallas interpret mode) at 5e-4 (tests/test_ops'
    flash gradient tolerance) and against the port's plain backward at 1e-5
    (f32 summation order); in bf16 against the plain backward at 1 % of each
    output's largest magnitude (chip_smoke's bf16 bound: a partial sum order
    can move a bf16 rounding of P or dS by one unit)."""
    B, H, Hkv, T = 1, 2, 1, 64
    mask = np.ones((B, T), np.int32)
    mask[0, :13] = 0
    q, k, v, wo = _inputs(d + 1, B, H, Hkv, T, d)
    tm = torch.as_tensor(mask)
    r = _rows_with_a_visible_key(tm, True, B, T)[:, None, :].expand(B, H, T)
    wo = wo * r[..., None]
    out, lse = tfa.flash_attention_reference(q, k, v, tm, True)
    dd = (wo * out).sum(-1)
    got = bwd_split_d(q, k, v, wo, lse, dd, tm, True)
    plain = tfa.flash_attention_bwd_reference(q, k, v, wo, lse, dd, tm, True)
    for g, f in zip(got, plain):
        torch.testing.assert_close(g, f, rtol=0, atol=1e-5)

    def loss(q, k, v):  # the JAX kernels take repeated K/V; the repeat sums the group
        kr, vr = jnp.repeat(k, H // Hkv, axis=1), jnp.repeat(v, H // Hkv, axis=1)
        return jnp.sum(flash_attention_diff(q, kr, vr, jnp.asarray(mask), True, 64, 64)
                       * jnp.asarray(wo.numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4, err_msg=name)
    assert all(float(g.abs().sum()) > 0 for g in got)

    qb, kb, vb, wb = (t.to(torch.bfloat16) for t in (q, k, v, wo))
    ob, lse_b = tfa.flash_attention_reference(qb, kb, vb, tm, True)
    ddb = (wb.float() * ob.float()).sum(-1)
    got_b = bwd_split_d(qb, kb, vb, wb, lse_b, ddb, tm, True)
    plain_b = tfa.flash_attention_bwd_reference(qb, kb, vb, wb, lse_b, ddb, tm, True)
    for g, f in zip(got_b, plain_b):
        assert g.dtype == torch.bfloat16
        tol = 1e-2 * float(f.float().abs().max())
        assert float((g.float() - f.float()).abs().max()) <= tol
