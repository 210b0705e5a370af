"""Flash attention without the logsumexp: the port of
``agilerl_tpu/ops/flash_attention.py``. The TPU package keeps a second Pallas
kernel for this function; here it is served by the flash kernels of
``ops/flash_attention_vjp.py`` with the logsumexp discarded (and so it is
differentiable too)."""

from __future__ import annotations

from typing import Optional

import torch

from agilerl_tpu_torch.ops.flash_attention_vjp import flash_attention_diff


def flash_attention(
    q: torch.Tensor,  # [B, H, T, d]
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Optional[torch.Tensor] = None,  # [B, T] 1=real token
    causal: bool = True,
) -> torch.Tensor:
    return flash_attention_diff(q, k, v, padding_mask, causal)
