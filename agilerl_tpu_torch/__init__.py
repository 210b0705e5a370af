"""PyTorch/CUDA port of agilerl_tpu, built slice by slice.

The JAX package ``agilerl_tpu`` stays the reference: every module here mirrors
its module path and function names, works on plain tensors over nested
``dict`` parameters with the same keys, and is held against it by the
``tests/test_torch_*.py`` parity tests. This package imports neither ``jax``
nor ``agilerl_tpu``.

Slice 1: the LLM rollout + GRPO scoring pass (``llm.model``, ``llm.generate``,
``llm.presets``, ``llm.convert``). Slice 2: GRPO training and evolution
(``algorithms``, ``hpo``, ``utils``, ``data``, ``training``). Slice 3: the rest
of the LLM stack: DPO (``algorithms.dpo``, ``utils.llm_utils.PreferenceGym``,
``training.train_llm.finetune_llm_preference``), ILQL and BC_LM
(``algorithms.ilql``, ``modules.layers``, ``data.rl_data``), MoE layers
(``llm.moe``) and the HF checkpoint loader (``llm.hf``). Slice 4a: the
single-replica serving tier (``llm.serving``, ``llm.speculate``, the paged
KV cache; ``observability`` registry and tracing). Slice 4b: the serving
fleet and the online GRPO flywheel (``llm.router``, ``llm.fleet``,
``llm.autoscale``, ``llm.flywheel``, ``training.train_llm_online``,
``resilience``, the rest of ``observability``). Slice 5a: evolutionary PPO
(``typing``, ``utils.spaces``, ``modules.{base,mlp,configs}``, ``networks``,
``components.rollout_buffer``, ``envs``, ``rollouts``, ``algorithms.ppo``,
the architecture and parameter mutations, ``training.train_on_policy``).
Later slices add the off-policy, offline and multi-agent families, the
evolvable transformers (``modules.gpt``, ``modules.bert``), the contextual
bandits (``algorithms.neural_ucb_bandit``, ``training.train_bandits``) and
the PettingZoo vector envs and agent wrappers (``vector``, ``wrappers``).
The kernels
written for Hopper live under ``csrc/`` behind ``ops.flash_attention_vjp``
(flash attention forward, dQ, dK/dV) and ``ops.fused_loss`` (fused lm-head
log-probability forward, dH, dW).
"""

__all__ = ["algorithms", "components", "data", "envs", "hpo", "llm", "modules", "networks",
           "observability", "ops", "resilience", "rollouts", "training", "utils", "vector",
           "wrappers"]
