"""Chunked cached attention: the port of ``agilerl_tpu/ops/decode_attention.py``.

The JAX package runs this as an XLA loop, with no Pallas kernel on purpose
(a static Pallas grid cannot skip the dead cache tail), so the faithful port
is plain PyTorch: an online softmax over KV chunks whose count is bounded by
the live cache length, GQA folded into the einsum so K/V are never repeated,
and the last chunk clamped to the cache end with a ``fresh`` mask so no slot
is counted twice.

Visibility rule: slot j is visible to query t of row b iff
``j <= start[b] + t`` and ``valid[b, j]``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

_NEG = -1e30


def _start_per_row(start, B: int, device) -> torch.Tensor:
    return torch.as_tensor(start, device=device).to(torch.int64).expand(B)


def _dense_reference(q, k_cache, v_cache, valid, start):
    """Dense formulation of the same visibility rule over the whole cache."""
    B, T, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    rep = Hq // Hkv
    qr = q.reshape(B, T, Hkv, rep, d).float()
    scores = torch.einsum("bthrd,bshd->bhrts", qr, k_cache.float()) / math.sqrt(d)
    slot = torch.arange(S, device=q.device)
    start_b = _start_per_row(start, B, q.device)
    causal = slot[None, None, :] <= (
        start_b[:, None] + torch.arange(T, device=q.device)[None, :])[:, :, None]
    mask = causal[:, None, None] & valid.bool()[:, None, None, None, :]
    probs = torch.softmax(torch.where(mask, scores, _NEG), dim=-1)
    out = torch.einsum("bhrts,bshd->bhrtd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, d).to(q.dtype)


def chunked_cached_attention(
    q: torch.Tensor,        # [B, T, Hq, d] RoPE'd queries at start..start+T-1
    k_cache: torch.Tensor,  # [B, S, Hkv, d] cache AFTER inserting this step's K
    v_cache: torch.Tensor,  # [B, S, Hkv, d]
    valid: torch.Tensor,    # [B, S] 1 = slot holds a real token
    start: Union[int, torch.Tensor],  # [] or [B] cache length before this step
    *,
    block: int = 512,
    live: Optional[int] = None,
) -> torch.Tensor:
    """Returns attention output [B, T, Hq, d]. The chunk count is a host
    value: an int ``start`` costs nothing, a tensor ``start`` costs one read
    of its maximum unless ``live``, a host upper bound of ``max(start) + T``,
    is given (chunks past the live prefix are wholly masked and add exact
    zeros, so any bound gives the same output for every query row that sees
    a slot)."""
    B, T, Hq, d = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    block = min(block, S)
    rep = Hq // Hkv
    scale = 1.0 / math.sqrt(d)
    dev = q.device

    qr = q.reshape(B, T, Hkv, rep, d).float()
    t_ids = torch.arange(T, device=dev)
    start_b = _start_per_row(start, B, dev)
    if live is None:
        live = (start if isinstance(start, int) else int(start_b.max())) + T
    n_chunks = min(-(-live // block), -(-S // block))

    m = torch.full((B, Hkv, rep, T), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, rep, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, rep, T, d), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        off = i * block
        # the last chunk is clamped to S - block (no padded copy of the
        # cache); slots it re-reads below `off` are masked as not fresh
        off_c = min(off, S - block)
        ks = k_cache[:, off_c:off_c + block].float()
        vs = v_cache[:, off_c:off_c + block]
        vm = valid[:, off_c:off_c + block]
        scores = torch.einsum("bthrd,bshd->bhrts", qr, ks) * scale
        slot = off_c + torch.arange(block, device=dev)
        causal = slot[None, None, :] <= (start_b[:, None] + t_ids[None, :])[:, :, None]
        fresh = slot >= off
        mask = ((causal & fresh[None, None, :])[:, None, None]
                & vm.bool()[:, None, None, None, :])
        scores = torch.where(mask, scores, _NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhrts,bshd->bhrtd", p.to(vs.dtype).float(), vs.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]   # [B, Hkv, rep, T, d]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, d).to(q.dtype)
