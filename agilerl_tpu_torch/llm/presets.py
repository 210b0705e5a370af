"""Named model presets: the port of ``agilerl_tpu/llm/presets.py``.

Dims match the public architectures exactly. The JAX presets default to
bf16 + remat + flash attention (its TPU training recipe); here they default
to bf16 + flash attention (``remat`` has no counterpart in the port yet).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from agilerl_tpu_torch.llm.model import GPTConfig

_PRESETS: Dict[str, Dict[str, Any]] = {
    "gpt2-small": dict(
        vocab_size=50_257, n_layer=12, n_head=12, n_kv_head=12, d_model=768,
        d_ff=3_072, max_seq_len=1_024, rope_theta=10_000.0,
    ),
    "llama2-7b": dict(
        vocab_size=32_000, n_layer=32, n_head=32, n_kv_head=32, d_model=4_096,
        d_ff=11_008, max_seq_len=4_096, rope_theta=10_000.0,
        tie_embeddings=False,
    ),
    "llama3-8b": dict(
        vocab_size=128_256, n_layer=32, n_head=32, n_kv_head=8, d_model=4_096,
        d_ff=14_336, max_seq_len=8_192, rope_theta=500_000.0,
        tie_embeddings=False,
    ),
    "qwen2-7b": dict(
        vocab_size=152_064, n_layer=28, n_head=28, n_kv_head=4, d_model=3_584,
        d_ff=18_944, max_seq_len=32_768, rope_theta=1_000_000.0,
        tie_embeddings=False, qkv_bias=True,
    ),
}


def preset_names():
    return sorted(_PRESETS)


def preset(name: str, **overrides: Any) -> GPTConfig:
    """A GPTConfig for a named architecture; overrides win."""
    if name not in _PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {preset_names()}")
    kw: Dict[str, Any] = dict(_PRESETS[name])
    kw.setdefault("dtype", torch.bfloat16)
    kw.setdefault("use_flash_attention", True)
    kw.update(overrides)
    return GPTConfig(**kw)
