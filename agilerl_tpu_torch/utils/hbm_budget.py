"""Per-device memory budgeting for GRPO training: the port of
``agilerl_tpu/utils/hbm_budget.py``.

A static budget of the GRPO step's memory, term by term, as the JAX package
states it for an (fsdp, tp) mesh with the batch sharded over fsdp and
per-block remat. The formula is the JAX package's, unchanged; the counts it
starts from are the port's own: every size comes from the port's REAL init
functions run on ``torch.device("meta")`` (no weights materialised), so the
budget cannot drift from the model code. The port stores the blocks in
``config.dtype`` and the head in f32 (``llm/model.head_dtype_of``), so its
``base_bytes`` are those storage bytes (the JAX package's ``eval_shape``
counts its f32 storage).

The port runs eager ``learn`` without remat (``remat`` is not ported), so
on the card the activation terms are a floor, not the peak; the base-weight
and KV-cache terms are exact. The one device size the module knows is the
card's: :func:`device_memory_gib` reads ``torch.cuda.mem_get_info()``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.ops import resolve_device
from agilerl_tpu_torch.utils.tree import tree_leaves

GIB = 1024 ** 3


def device_memory_gib(device=None) -> float:
    """The card's memory in GiB, as ``torch.cuda.mem_get_info`` reports its
    total (``device=None`` is the card; raises without one)."""
    _free, total = torch.cuda.mem_get_info(resolve_device(device))
    return total / GIB


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def param_counts(config: M.GPTConfig, lora_rank: int = 8,
                 lora_targets=("wq", "wv")) -> Dict[str, int]:
    """Exact parameter counts and bytes from the real initialisers on the
    meta device."""
    base = M.init_params(torch.Generator(), config, device="meta")
    lora = M.init_lora(torch.Generator(), config, lora_rank, tuple(lora_targets),
                       device="meta")
    # A/B split: they shard on DIFFERENT mesh axes (A on fsdp, B on tp), so
    # the per-device budget needs them separately
    a_bytes = b_bytes = 0
    for layer in lora["blocks"].values():
        for ab in layer.values():
            a_bytes += ab["A"].numel() * ab["A"].element_size()
            b_bytes += ab["B"].numel() * ab["B"].element_size()
    return {
        "base_params": sum(t.numel() for t in tree_leaves(base)),
        "base_bytes": _tree_bytes(base),
        "lora_params": sum(t.numel() for t in tree_leaves(lora)),
        "lora_bytes": _tree_bytes(lora),
        "lora_a_bytes": a_bytes,
        "lora_b_bytes": b_bytes,
    }


def grpo_hbm_budget(
    config: M.GPTConfig,
    fsdp: int,
    tp: int,
    batch_global: int,
    seq_len: int,
    dp: int = 1,
    lora_rank: int = 8,
    lora_targets=("wq", "wv"),
    gen_batch_global: Optional[int] = None,
    gen_total_len: Optional[int] = None,
    logit_chunk: int = 512,
) -> Dict[str, Any]:
    """Per-device budget (bytes) for the sharded GRPO step on an (fsdp, tp)
    mesh, batch sharded over fsdp, per-block remat. The JAX package's terms:

    - base weights: matmul weights sharded over fsdp x tp;
    - LoRA adapter: f32 A / B (each sharded over one axis) + AdamW moments
      (2x f32) + a transient gradient (1x);
    - activation checkpoints: per-block remat stores the L block INPUTS,
      [B_local, T, d] bf16 each;
    - within-block recompute peak: the largest single-block working set
      during backward (QKV + attention output + SwiGLU gate / up, / tp);
    - lm-head loss chunk: the fused loss never materialises [B, T, V], only
      [B_local, chunk, V / tp] plus its backward double buffer;
    - KV cache (generation): 2 x L x [B_local, P + N, kv_heads, hd] bf16,
      kv heads sharded over tp (at least one head per device)."""
    counts = param_counts(config, lora_rank, lora_targets)
    d, L, T = config.d_model, config.n_layer, seq_len
    # batch shards over BOTH data axes (dp, fsdp); weights are replicated
    # over dp (each dp slice holds the fsdp x tp shard)
    B_local = max(batch_global // (dp * fsdp), 1)
    bf16 = 2

    base_per_chip = counts["base_bytes"] / (fsdp * tp)
    other = counts["lora_bytes"] - counts["lora_a_bytes"] - counts["lora_b_bytes"]
    lora_state = 4 * (counts["lora_a_bytes"] / fsdp + counts["lora_b_bytes"] / tp + other)
    ckpt = L * B_local * T * d * bf16
    qkv = B_local * T * (config.n_head + 2 * config.kv_heads) * config.head_dim * bf16 / tp
    ffn = B_local * T * config.ff_dim * 2 * bf16 / tp  # gate + up
    block_peak = (qkv + ffn + 2 * B_local * T * d * bf16) * 2  # x2 backward residency
    head_chunk = 2 * B_local * logit_chunk * config.vocab_size * 4 / tp
    budget = {
        "base_weights": base_per_chip,
        "lora_adapter_state": lora_state,
        "remat_checkpoints": ckpt,
        "block_recompute_peak": block_peak,
        "lm_head_loss_chunk": head_chunk,
    }
    if gen_batch_global and gen_total_len:
        Bg = max(gen_batch_global // (dp * fsdp), 1)
        kv_heads_local = max(config.kv_heads // tp, 1)
        budget["kv_cache_generation"] = (
            2 * L * Bg * gen_total_len * kv_heads_local * config.head_dim * bf16)
    budget["total"] = sum(budget.values())
    budget["meta"] = {
        "counts": counts, "dp": dp, "fsdp": fsdp, "tp": tp,
        "batch_global": batch_global, "batch_local": B_local, "seq_len": T,
    }
    return budget


def render_budget_md(budget: Dict[str, Any], hbm_gib: Optional[float] = None) -> str:
    """Markdown table of a :func:`grpo_hbm_budget` result against a device's
    memory (``hbm_gib``; default: this card's, :func:`device_memory_gib`)."""
    if hbm_gib is None:
        hbm_gib = device_memory_gib()
    meta = budget["meta"]
    lines = ["| term | per-device GiB |", "|---|---|"]
    for k, v in budget.items():
        if k in ("total", "meta"):
            continue
        lines.append(f"| {k.replace('_', ' ')} | {v / GIB:.2f} |")
    total = budget["total"] / GIB
    lines.append(f"| **total** | **{total:.2f}** |")
    fit = (f"fits, {hbm_gib - total:.1f} GiB headroom" if total < hbm_gib
           else "OVER BUDGET")
    lines.append(f"| memory per device | {hbm_gib:.1f} ({fit}) |")
    dp_part = f"dp={meta['dp']} x " if meta.get("dp", 1) > 1 else ""
    header = (f"mesh {dp_part}fsdp={meta['fsdp']} x tp={meta['tp']}, "
              f"global batch {meta['batch_global']} (local {meta['batch_local']}), "
              f"seq {meta['seq_len']}, "
              f"base params {meta['counts']['base_params'] / 1e9:.2f}B")
    return header + "\n\n" + "\n".join(lines)
