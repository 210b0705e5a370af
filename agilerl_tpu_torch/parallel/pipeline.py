"""Pipeline parallelism: the port of ``agilerl_tpu/parallel/pipeline.py``
(GPipe microbatching over a ``pp`` mesh axis).

The transformer blocks are stacked into one ``[L, ...]`` tree and split
into S contiguous stages: rank ``s`` of the ``pp`` axis holds the stage's
``[L/S, ...]`` slice. Each rank runs the GPipe schedule of M + S - 1 ticks
(the JAX package's ``lax.scan``): every tick each stage applies its layers
to its microbatch and hands the activation to the next stage with one
differentiable ``comm.ring_shift``, whose backward shifts the gradient
back, so autograd replays the ticks backwards as the GPipe backward.

Torch runs one program per rank, so the JAX package's ``shard_map``
becomes explicit collectives, and three things keep the backward right:

- **every rank runs the same shifts in the same order.** Stage 0's fresh
  microbatch, the last stage's writes and the bubble ticks are chosen with
  ``torch.where`` on the stage id, as the JAX program's ``jnp.where``:
  every received activation stays in each rank's graph (with a zero
  gradient where it is not used), so every rank's backward calls every
  shift's backward. A Python branch that dropped one on some ranks would
  deadlock the others;
- **the loss counts once.** The last stage's outputs are summed to every
  stage (``comm.sum_to_all``) and every rank computes the same loss from
  them, so that sum's backward passes the gradient as it is; the embedded
  input, which only stage 0 reads, sums its gradient over the stages
  (``comm.sum_grads``). Embedding, ``ln_f`` and the head stay replicated
  outside the stages, and their gradients are whole and equal on every
  rank;
- **pp × fsdp** (``fsdp_axis``): each stage's weights are also sharded on
  their first non-stage dim, gathered one layer at a time inside
  ``torch.utils.checkpoint`` (the backward gathers again), and the batch
  rows split over the same axis. Each fsdp rank runs other rows, so the
  gather's backward is a reduce-scatter (``comm.gather_shards``), not the
  keep-my-slice backward of a replicated loss; the rows come back whole
  (``comm.gather_replicated_loss``) before the head.

A placed stack (``shard_stacked_blocks``) is this rank's local slice, plain
tensors: the JAX package's global arrays have no counterpart in a program
that runs per rank.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from agilerl_tpu_torch.llm.model import GPTConfig, _rms, block_apply_dense, logits_fn
from agilerl_tpu_torch.parallel import comm

Params = Any


def stack_blocks(params: Params, config: GPTConfig) -> Dict[str, torch.Tensor]:
    """Per-layer dicts -> one ``{name: [L, ...]}`` tree. The blocks must be
    homogeneous (dense everywhere, or MoE with ``moe_every == 1``)."""
    blocks = [params["blocks"][str(i)] for i in range(config.n_layer)]
    keys0 = set(blocks[0])
    if not all(set(b) == keys0 for b in blocks):
        raise ValueError("pipeline stages need homogeneous blocks (interleaved MoE unsupported)")
    return {k: torch.stack([b[k] for b in blocks]) for k in blocks[0]}


def unstack_blocks(stacked: Dict[str, torch.Tensor], config: GPTConfig) -> Dict[str, Params]:
    return {str(i): {k: v[i] for k, v in stacked.items()} for i in range(config.n_layer)}


def _axis(mesh, axis: str):
    """(size, this rank's coordinate, process group) of a mesh axis."""
    return mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis), \
        mesh.get_group(axis)


def _check_fsdp(config: GPTConfig, F_: int) -> None:
    hd = config.head_dim
    for dim, what in ((config.d_model, "d_model"), (config.ff_dim, "ff_dim"),
                      (config.n_head * hd, "n_head*head_dim"),
                      (config.kv_heads * hd, "kv_heads*head_dim")):
        if dim % F_ != 0:
            raise ValueError(f"pp x fsdp: {what}={dim} must divide by the fsdp axis size {F_}")


def pipeline_hidden_fn(config: GPTConfig, mesh, num_microbatches: int, axis: str = "pp",
                       fsdp_axis: Optional[str] = None):
    """Build ``fn(local_blocks, h0, mask, positions) -> hidden`` running the
    block stack as a GPipe pipeline over ``mesh[axis]``.

    - ``local_blocks``: this rank's ``[L/S, ...]`` slice
      (``shard_stacked_blocks``; with ``fsdp_axis`` also sharded on dim 1);
    - ``h0``: [B, T, d] embedded inputs, the same on every rank;
      B % num_microbatches == 0 (and B % (fsdp size x num_microbatches)
      with ``fsdp_axis``);
    - returns the final hidden [B, T, d], the same on every rank (before
      ``ln_f``).
    """
    S, sid, group = _axis(mesh, axis)
    if config.n_layer % S != 0:
        raise ValueError(f"n_layer {config.n_layer} must divide into {S} pipeline stages")
    if fsdp_axis is not None:
        F_, frank, fgroup = _axis(mesh, fsdp_axis)
        _check_fsdp(config, F_)
    M = int(num_microbatches)

    def one_layer(h, m, p, keys, *leaves):
        blk = dict(zip(keys, leaves))
        if fsdp_axis is not None:
            # ZeRO: this layer's weights live sharded (dim 0 here: the stage
            # dim is indexed away); gathered just in time, and again in the
            # checkpointed backward, whose gradient is reduce-scattered
            blk = {k: comm.gather_shards(v, fgroup, 0) for k, v in blk.items()}
        return block_apply_dense(config, blk, h, m, p)

    def apply_stage(local_blocks, h, m, p):
        keys = tuple(local_blocks)
        for i in range(config.n_layer // S):
            leaves = [local_blocks[k][i] for k in keys]
            if fsdp_axis is not None:
                h = checkpoint(one_layer, h, m, p, keys, *leaves, use_reentrant=False)
            else:
                h = one_layer(h, m, p, keys, *leaves)
        return h

    def fn(local_blocks, h0, mask, positions):
        # every rank's gradient of h0 is only its own part (stage 0, its
        # fsdp rows): summed over the stages and the fsdp ranks
        h0 = comm.sum_grads(h0, group)
        if fsdp_axis is not None:
            h0 = comm.sum_grads(h0, fgroup)
            rows = h0.shape[0] // F_
            h0, mask, positions = (x.narrow(0, frank * rows, rows) for x in (h0, mask, positions))
        B = h0.shape[0]
        mb = B // M
        h_mb = h0.reshape((M, mb) + tuple(h0.shape[1:]))
        mask_mb = mask.reshape((M, mb) + tuple(mask.shape[1:]))
        pos_mb = positions.reshape((M, mb) + tuple(positions.shape[1:]))
        first = torch.tensor(sid == 0, device=h0.device)
        h_in = h0.new_zeros((mb,) + tuple(h0.shape[1:]))
        out_buf = h0.new_zeros((M, mb) + tuple(h0.shape[1:]))
        for t in range(M + S - 1):
            mb_idx = t - sid  # the microbatch this stage handles at tick t
            safe = min(max(mb_idx, 0), M - 1)
            # stage 0 takes a fresh microbatch, the others the received one
            h_cur = torch.where(first, h_mb[min(t, M - 1)], h_in)
            h_out = apply_stage(local_blocks, h_cur, mask_mb[safe], pos_mb[safe])
            write = torch.tensor(sid == S - 1 and 0 <= mb_idx < M, device=h0.device)
            written = out_buf.index_copy(0, torch.tensor([safe], device=h0.device), h_out[None])
            out_buf = torch.where(write, written, out_buf)
            (h_in,) = comm.ring_shift(h_out, group)
        # the last stage's outputs to every stage
        last = torch.tensor(sid == S - 1, device=h0.device)
        hidden = comm.sum_to_all(torch.where(last, out_buf, torch.zeros_like(out_buf)), group)
        hidden = hidden.reshape((B,) + tuple(h0.shape[1:]))
        if fsdp_axis is not None:
            hidden = comm.gather_replicated_loss(hidden, fgroup, 0)
        return hidden

    return fn


def pipeline_apply(
    config: GPTConfig,
    params: Params,
    tokens: torch.Tensor,
    mesh,
    num_microbatches: int = 2,
    attention_mask: Optional[torch.Tensor] = None,
    axis: str = "pp",
    stacked: Optional[Dict[str, torch.Tensor]] = None,
    fsdp_axis: Optional[str] = None,
) -> torch.Tensor:
    """Full forward to logits [B, T, V] (f32, the same on every rank) with
    the block stack pipelined over ``axis``, optionally composed with ZeRO
    sharding and batch rows over ``fsdp_axis`` (see
    ``pipeline_hidden_fn``). ``tokens`` are the whole batch on every rank.
    Pass ``stacked=shard_stacked_blocks(stack_blocks(params, config), mesh,
    ...)`` (this rank's slice, with the same axes) to train the stack;
    ``params["blocks"]`` is then not read."""
    if config.n_experts != 0:
        raise ValueError("pipeline_apply stages the dense block program; pp x MoE composition "
                         "is not supported (shard experts on ep instead)")
    if fsdp_axis is not None:
        F_ = mesh.size(mesh.mesh_dim_names.index(fsdp_axis))
        if tokens.shape[0] % (F_ * num_microbatches) != 0:
            raise ValueError(f"pp x fsdp: batch {tokens.shape[0]} must divide by fsdp size {F_} "
                             f"x num_microbatches {num_microbatches}")
    if attention_mask is None:
        attention_mask = torch.ones(tokens.shape, dtype=torch.int32, device=tokens.device)
    positions = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)
    h0 = F.embedding(tokens, params["tok_emb"]).to(config.dtype)
    if stacked is None:
        stacked = shard_stacked_blocks(stack_blocks(params, config), mesh, axis, fsdp_axis)
    fn = pipeline_hidden_fn(config, mesh, num_microbatches, axis, fsdp_axis)
    hidden = fn(stacked, h0, attention_mask, positions)
    hidden = _rms(hidden, params["ln_f"], config.rms_eps).float()
    return logits_fn(config, params, hidden)


def shard_stacked_blocks(stacked: Dict[str, torch.Tensor], mesh, axis: str = "pp",
                         fsdp_axis: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """This rank's part of a stacked block tree: its stage's ``[L/S, ...]``
    slice of dim 0 and, for the pp x fsdp composition, its fsdp shard of dim
    1, each a tensor of its own (the whole stack is not kept alive)."""
    S, sid, _ = _axis(mesh, axis)
    out = {}
    for k, x in stacked.items():
        n = x.shape[0] // S
        x = x.narrow(0, sid * n, n)
        if fsdp_axis is not None:
            F_, frank, _ = _axis(mesh, fsdp_axis)
            w = x.shape[1] // F_
            x = x.narrow(1, frank * w, w)
        out[k] = x.detach().clone().requires_grad_(x.requires_grad)
    return out
