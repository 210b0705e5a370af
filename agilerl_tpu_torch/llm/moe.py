"""Mixture-of-Experts FFN: the port of ``agilerl_tpu/llm/moe.py``.

Switch-style top-k routing with dense, capacity-bucketed dispatch: the routing
is one-hot einsums over static shapes (``[tokens, E, C]`` dispatch and combine
tensors), as in the JAX package, which computes them outside any kernel.
Bucket slots go k-slot major, token minor, so every token's first choice is
placed before any token's second. The Switch load-balance loss (E · Σ_e
fraction_e · mean_prob_e over the top-1 assignment) comes back beside the
output, for the training loss to add ``router_aux_weight * aux``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F


def moe_capacity(num_tokens: int, n_experts: int, top_k: int, capacity_factor: float) -> int:
    """Per-expert capacity bucket size."""
    return max(1, int(math.ceil(top_k * num_tokens / n_experts * capacity_factor)))


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: ties go to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(
    x: torch.Tensor,  # [N, d] tokens (flattened batch*seq)
    router_w: torch.Tensor,  # [d, E]
    w_gate: torch.Tensor,  # [E, d, f] stacked expert SwiGLU gate
    w_up: torch.Tensor,  # [E, d, f]
    w_down: torch.Tensor,  # [E, f, d]
    top_k: int,
    capacity_factor: float = 1.25,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [N, d] in x's dtype, aux loss, an f32 scalar).

    A (token, route) pair past its expert's capacity is dropped; a token whose
    routes are all dropped adds nothing, and passes through the residual."""
    N = x.shape[0]
    E = router_w.shape[-1]
    dtype = x.dtype

    probs = torch.softmax((x @ router_w.to(dtype)).float(), dim=-1)  # [N, E]
    gate_vals, gate_idx = topk_stable(probs, top_k)  # [N, k]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    C = moe_capacity(N, E, top_k, capacity_factor)
    onehot = F.one_hot(gate_idx, E).float()  # [N, k, E]
    flat = onehot.transpose(0, 1).reshape(top_k * N, E)  # k-major order
    pos_flat = flat.cumsum(dim=0) - flat
    pos = (pos_flat * flat).sum(dim=-1).reshape(top_k, N).t()  # [N, k]
    keep = (pos < C).float()
    # one-hot of the slot; a position past the bucket (dropped) has none
    slots = torch.arange(C, device=x.device, dtype=pos.dtype)
    pos_oh = (pos[..., None] == slots).float() * keep[..., None]  # [N, k, C]
    dispatch = torch.einsum("nke,nkc->nec", onehot, pos_oh).to(dtype)
    combine = torch.einsum("nke,nkc,nk->nec", onehot, pos_oh, gate_vals).to(dtype)

    expert_in = torch.einsum("nec,nd->ecd", dispatch, x)  # [E, C, d]
    g = torch.einsum("ecd,edf->ecf", expert_in, w_gate.to(dtype))
    u = torch.einsum("ecd,edf->ecf", expert_in, w_up.to(dtype))
    y = torch.einsum("ecf,efd->ecd", F.silu(g) * u, w_down.to(dtype))
    out = torch.einsum("nec,ecd->nd", combine, y)

    frac = onehot[:, 0, :].mean(dim=0)
    aux = (E * (frac * probs.mean(dim=0)).sum()).float()
    return out, aux
