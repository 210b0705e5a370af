"""Sequence-parallel transformer forward: long-context training over an
``"sp"`` mesh axis with ring attention, the port of
``agilerl_tpu/llm/long_context.py``.

The sequence splits into one contiguous block per rank of the axis;
activations per rank are O(T/P); attention runs blockwise around the ring
(``ops/ring_attention.py``) in f32 on repeated KV heads, as the JAX
function does, through the flash engine when ``use_flash_attention`` is set.
The head is a dense f32 product + ``log_softmax`` (the JAX function computes
it outside any kernel). Every rank gathers the per-token log-probabilities of
all blocks, so a loss on them is the same on every rank; each rank's
gradient covers its own block (``parallel/comm.gather_replicated_loss``),
and the caller sums the parameters' gradients over the axis.

``config.remat`` checkpoints each block of a learn, as ``llm/model.forward``
does (the JAX function does not remat; the result is the same function).

Constraints: right-padded batches (global positions = block offset + local
index; no key mask), T divisible by the axis size.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from agilerl_tpu_torch.llm.model import GPTConfig, _maybe_lora, _rms, _rope
from agilerl_tpu_torch.ops.ring_attention import ring_attention
from agilerl_tpu_torch.parallel.comm import gather_replicated_loss, group_rank, group_size, shift


def _local(w: Any) -> Any:
    """A parameter as this rank's whole plain tensor (a DTensor is gathered;
    its gradient then reaches the DTensor)."""
    return w.full_tensor() if isinstance(w, DTensor) else w


def _block_sp(config: GPTConfig, blk, lora_layer, h, positions, group, lora_scale):
    """One transformer block with ring attention over the group.
    h: [B, T_local, D]; positions: [B, T_local] global positions."""
    B, T, _ = h.shape
    dtype = config.dtype
    x = _rms(h, blk["ln1"], config.rms_eps)
    q = _maybe_lora(x, blk["wq"], lora_layer, "wq", lora_scale, dtype)
    k = _maybe_lora(x, blk["wk"], lora_layer, "wk", lora_scale, dtype)
    v = _maybe_lora(x, blk["wv"], lora_layer, "wv", lora_scale, dtype)
    if config.qkv_bias:
        q = q + blk["bq"].to(dtype)
        k = k + blk["bk"].to(dtype)
        v = v + blk["bv"].to(dtype)
    q = _rope(q.reshape(B, T, config.n_head, config.head_dim), positions, config.rope_theta)
    k = _rope(k.reshape(B, T, config.kv_heads, config.head_dim), positions, config.rope_theta)
    v = v.reshape(B, T, config.kv_heads, config.head_dim)
    rep = config.n_head // config.kv_heads
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    attn = ring_attention(q.float(), k.float(), v.float(), group, causal=True,
                          use_flash=config.use_flash_attention).to(dtype)
    attn = attn.reshape(B, T, config.n_head * config.head_dim)
    h = h + _maybe_lora(attn, blk["wo"], lora_layer, "wo", lora_scale, dtype)
    x = _rms(h, blk["ln2"], config.rms_eps)
    gate = _maybe_lora(x, blk["w_gate"], lora_layer, "w_gate", lora_scale, dtype)
    up = _maybe_lora(x, blk["w_up"], lora_layer, "w_up", lora_scale, dtype)
    return h + _maybe_lora(F.silu(gate) * up, blk["w_down"], lora_layer, "w_down",
                           lora_scale, dtype)


def _block_sp_at_use(config: GPTConfig, blk, layer, h, positions, group, lora_scale):
    """``_block_sp`` with the block's weights and adapter taken whole in
    here: under ``remat`` the gathered weights are freed after the forward
    and gathered again in the recompute."""
    blk = {k: _local(w) for k, w in blk.items()}
    if layer is not None:
        layer = {t: {k: _local(w) for k, w in ab.items()} for t, ab in layer.items()}
    return _block_sp(config, blk, layer, h, positions, group, lora_scale)


def _forward_local(config: GPTConfig, params, tokens, lora, lora_scale, group):
    """This rank's forward over its block of the sequence ([B, T_local]).
    ``config.remat`` checkpoints each block while grad is enabled: the
    recompute in the backward sends the ring's shifts again, and every rank
    recomputes its blocks in the same order (the backward's)."""
    B, T = tokens.shape
    start = group_rank(group) * T
    positions = (start + torch.arange(T, device=tokens.device))[None, :].expand(B, T)
    h = F.embedding(tokens, _local(params["tok_emb"])).to(config.dtype)
    remat = config.remat and torch.is_grad_enabled()
    for i in range(config.n_layer):
        args = (config, params["blocks"][str(i)],
                lora["blocks"].get(str(i)) if lora is not None else None,
                h, positions, group, lora_scale)
        if remat:
            h = checkpoint(_block_sp_at_use, *args, use_reentrant=False,
                           preserve_rng_state=False)  # a block draws nothing
        else:
            h = _block_sp_at_use(*args)
    return _rms(h, _local(params["ln_f"]), config.rms_eps).float()


def make_sp_logprob_fn(config: GPTConfig, mesh, axis_name: str = "sp", lora_scale: float = 2.0):
    """``fn(params, lora, tokens [B, T]) -> per-token logprobs [B, T-1]``
    with the sequence split over ``axis_name`` of ``mesh``. ``tokens`` is the
    whole batch on every rank; the result is whole on every rank.
    Differentiable: the gradient reaching a parameter on one rank is that
    rank's part; sum it over the axis (``GRPO`` does) for the total."""
    group = mesh.get_group(axis_name)

    def sp_logprobs(params, lora, tokens):
        P, me = group_size(group), group_rank(group)
        B, T = tokens.shape
        if T % P:
            raise ValueError(f"sequence length {T} not divisible by sp axis size {P}")
        n = T // P
        local = tokens[:, me * n:(me + 1) * n]
        hidden = _forward_local(config, params, local, lora, lora_scale, group)
        head = _local(params["tok_emb"]).t() if config.tie_embeddings else _local(
            params["lm_head"])
        logp = torch.log_softmax(hidden @ head.float(), dim=-1)
        # the target of local position t is token t + 1; the last local
        # target is the next block's first token, shifted in from rank r + 1
        (first_next,) = shift((local[:, :1],), group, -1)
        targets = torch.cat([local[:, 1:], first_next], dim=1)
        lp = logp.gather(-1, targets.long()[..., None])[..., 0]
        lp = gather_replicated_loss(lp, group, 1)  # [B, T]
        return lp[:, :-1]  # the last entry predicts past the sequence

    return sp_logprobs
