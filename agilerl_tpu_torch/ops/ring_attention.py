"""Ring attention: sequence parallelism over a mesh axis, the port of
``agilerl_tpu/ops/ring_attention.py``.

Each rank holds one contiguous block of the sequence. K/V blocks (with their
key mask) travel around the ring of the axis's ranks (``parallel/comm.py``:
``ring_shift``, whose backward shifts the gradient back), and each rank
merges its partial attentions online, so attention memory per rank is
O((T/P)^2) with the dense engine and O(tile^2) with the flash engine.

The rank is a host integer, so whether a block lies in the past, on the
diagonal or in the future of this rank's queries is decided on the host: a
past block runs non-causal attention, the diagonal block causal attention,
and a future block launches nothing and contributes zeros with a row
maximum (or lse) of -1e30. The future block's contribution still depends on
its K/V in the graph (``_Future``), so every rank runs the same backward
shifts in the same order.

``use_flash=True`` runs each block through ``flash_attention_with_lse``
(the flash kernels on CUDA tensors: forward, dQ and dK/dV, with the lse
cotangent of the merge entering the backward's ``dd``) and merges by
logsumexp.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from agilerl_tpu_torch.parallel.comm import group_rank, group_size, ring_shift

NEG = -1e30


class _Future(torch.autograd.Function):
    """A future block's contribution: zeros (and ``fill``) shaped like
    ``like``, with a zero gradient for ``kv`` so the block stays in the
    graph."""

    @staticmethod
    def forward(ctx, kv, like, fill_shape, fill):
        ctx.kv_meta = (kv.shape, kv.dtype, kv.device)
        return (torch.zeros_like(like),
                torch.full(fill_shape, fill, dtype=torch.float32, device=like.device))

    @staticmethod
    def backward(ctx, *_):
        shape, dtype, device = ctx.kv_meta
        return torch.zeros(shape, dtype=dtype, device=device), None, None, None


def _block_attn(q, k, v, mask, scale):
    """One q-block x kv-block partial attention. q [B, Tq, H, d]; k/v
    [B, Tk, H, d]; mask broadcastable to [B, H, Tq, Tk] or None. Returns
    (numerator [B, Tq, H, d], row max [B, Tq, H], denominator [B, Tq, H])."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o, m.transpose(1, 2), l.transpose(1, 2)


def _kind(src: int, me: int, causal: bool) -> str:
    if not causal or src < me:
        return "past"
    return "diag" if src == me else "future"


def _ring_flash(q, k, v, group, causal, kv_mask):
    from agilerl_tpu_torch.ops.flash_attention_vjp import flash_attention_with_lse

    P, me = group_size(group), group_rank(group)
    B, T, H, d = q.shape
    qh = q.transpose(1, 2)  # [B, H, T, d]
    kv = torch.stack([k, v])  # one tensor travels: one backward chain
    mask = kv_mask
    o = lse = None
    for i in range(P):
        src = (me - i) % P
        kind = _kind(src, me, causal)
        if kind == "future":
            o_b, lse_b = _Future.apply(kv, qh, (B, H, T), NEG)
        else:
            kh, vh = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
            o_b, lse_b = flash_attention_with_lse(qh, kh, vh, mask, kind == "diag")
        o_b = o_b.float()
        if o is None:
            o, lse = o_b, lse_b
        else:
            new = torch.logaddexp(lse, lse_b)
            o = o * torch.exp(lse - new)[..., None] + o_b * torch.exp(lse_b - new)[..., None]
            lse = new
        if i + 1 < P:
            kv, mask = ring_shift(kv, group, 1, (mask,))
    return o.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group=None,
                   causal: bool = True, kv_mask: Optional[torch.Tensor] = None,
                   use_flash: bool = False) -> torch.Tensor:
    """Attention of this rank's block of the sequence: q/k/v [B, T_local, H,
    d]; ``kv_mask`` [B, T_local] (1 = real key) travels with its K/V block.
    ``group`` is the sequence axis's process group (None: the default
    group)."""
    if use_flash:
        return _ring_flash(q, k, v, group, causal, kv_mask)
    P, me = group_size(group), group_rank(group)
    B, T, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    t_ids = torch.arange(T, device=q.device)
    intra = (t_ids[:, None] >= t_ids[None, :])[None, None]  # [1, 1, T, T]
    kv = torch.stack([k, v])
    mask = kv_mask
    o = m = l = None
    for i in range(P):
        src = (me - i) % P
        kind = _kind(src, me, causal)
        if kind == "future":
            o_b, m_b = _Future.apply(kv, q, (B, T, H), NEG)
            l_b = torch.zeros_like(m_b)
        else:
            eff = intra if kind == "diag" else None
            if mask is not None:
                pad = mask[:, None, None, :].bool()
                eff = pad if eff is None else eff & pad
            o_b, m_b, l_b = _block_attn(q, kv[0], kv[1], eff, scale)
        if o is None:
            o, m, l = o_b, m_b, l_b
        else:
            m_new = torch.maximum(m, m_b)
            alpha, beta = torch.exp(m - m_new), torch.exp(m_b - m_new)
            l = l * alpha + l_b * beta
            o = o * alpha[..., None] + o_b * beta[..., None]
            m = m_new
        if i + 1 < P:
            kv, mask = ring_shift(kv, group, 1, (mask,))
    return o / l.clamp_min(1e-30)[..., None]


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = True,
                        with_mask: bool = False, use_flash: bool = False):
    """``fn(q, k, v[, mask])`` over whole [B, T, H, d] tensors (the same on
    every rank): each rank takes its block of T along ``axis_name`` of
    ``mesh``, runs the ring, and the blocks are gathered back (with their
    gradient kept per rank, as ``parallel/comm.gather_replicated_loss``)."""
    from agilerl_tpu_torch.parallel.comm import gather_replicated_loss

    group = mesh.get_group(axis_name)
    P, me = group_size(group), group_rank(group)

    def fn(q, k, v, m=None):
        if with_mask and m is None:
            raise ValueError("with_mask=True needs the [B, T] key mask")
        n = q.shape[1] // P
        sl = slice(me * n, (me + 1) * n)
        out = ring_attention(q[:, sl], k[:, sl], v[:, sl], group, causal,
                             m[:, sl] if with_mask else None, use_flash)
        return gather_replicated_loss(out, group, 1)

    return fn


def reference_attention(q, k, v, causal: bool = True):
    """Dense attention for correctness checks ([B, T, H, d])."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        T = q.shape[1]
        t = torch.arange(T, device=q.device)
        scores = torch.where((t[:, None] >= t[None, :])[None, None], scores, NEG)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
