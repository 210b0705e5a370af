"""PyTorch/CUDA port of agilerl_tpu, built slice by slice.

The JAX package ``agilerl_tpu`` stays the reference: every module here mirrors
its module path and function names, works on plain tensors over nested
``dict`` parameters with the same keys, and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports neither ``jax``
nor ``agilerl_tpu``.

Slice 1: the LLM rollout + GRPO scoring pass (``llm.model``, ``llm.generate``,
``llm.presets``, ``llm.convert``). Slice 2: GRPO training and evolution
(``algorithms``, ``hpo``, ``utils``, ``data``, ``training``). The kernels
written for Hopper live under ``csrc/`` behind ``ops.flash_attention_vjp``
(flash attention forward, dQ, dK/dV) and ``ops.fused_loss`` (fused lm-head
log-probability forward, dH, dW).
"""

__all__ = ["algorithms", "data", "hpo", "llm", "ops", "training", "utils"]
