"""PyTorch/CUDA port of agilerl_tpu, built slice by slice.

The JAX package ``agilerl_tpu`` stays the reference: every module here mirrors
its module path and function names, works on plain tensors over nested
``dict`` parameters with the same keys, and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports neither ``jax``
nor ``agilerl_tpu``.

Slice 1 (this tree): the LLM rollout + GRPO scoring pass —
``llm.model`` (dense Llama-class decoder, LoRA, KV cache), ``llm.generate``,
``llm.presets``, ``llm.convert`` (weights from the JAX tree through numpy), and
the two forward kernels written for Hopper under ``csrc/``: flash attention
(``ops.flash_attention_vjp``) and the fused lm-head log-probability
(``ops.fused_loss``).
"""

__all__ = ["llm", "ops"]
