"""DPO, direct preference optimisation: the port of
``agilerl_tpu/algorithms/dpo.py``.

The same LoRA actor and reference adapters over one frozen base model as GRPO.
``learn`` takes a ``PreferenceGym`` batch (chosen and rejected sequences with
completion loss masks): the reference adapter's two sequence-logprob passes
run without gradients, then the policy's two passes are differentiated into
the actor adapter through the sigmoid DPO loss with label smoothing, and AdamW
(after GRPO's global-norm clip) takes one step. The JAX package's one jitted
update is two callables here, the reference passes (``_dpo_reference_fn``) and
the policy step (``_dpo_update_fn``), so each can be timed alone.

Every pass goes through ``token_logprobs(use_fused=True, flash=True)``: on
CUDA tensors the flash forward, dQ and dK/dV kernels and the fused forward and
dH kernels (the head is frozen, so dW is never launched); on CPU tensors their
plain versions.

As in the JAX package, the training passes leave ``lora_scale`` at
``token_logprobs``' default (2.0), while ``test`` scores through GRPO's
``_logprob_fn`` with the agent's ``lora_scale``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agilerl_tpu_torch.algorithms.core.optimizer import grad_step
from agilerl_tpu_torch.algorithms.core.registry import HyperparameterConfig, RLParameter
from agilerl_tpu_torch.algorithms.grpo import GRPO
from agilerl_tpu_torch.llm import model as M


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-8, max=1e-4, dtype=float),
        beta=RLParameter(min=0.01, max=1.0, dtype=float),
    )


def _dpo_loss(pol_c, pol_r, ref_c, ref_r, beta, smooth):
    """Sigmoid DPO loss with label smoothing. Returns (loss, preference
    accuracy, mean implicit-reward margin)."""
    logits = beta * ((pol_c - ref_c) - (pol_r - ref_r))
    loss = (-F.logsigmoid(logits) * (1 - smooth) - F.logsigmoid(-logits) * smooth).mean()
    return loss, (logits > 0).float().mean(), logits.mean()


class DPO(GRPO):
    def __init__(self, *args, beta: float = 0.1, label_smoothing: float = 0.0, **kwargs):
        kwargs.setdefault("hp_config", default_hp_config())
        super().__init__(*args, beta=beta, **kwargs)
        self.label_smoothing = float(label_smoothing)

    @property
    def init_dict(self) -> Dict[str, Any]:
        d = super().init_dict
        d["label_smoothing"] = self.label_smoothing
        return d

    # ------------------------------------------------------------------ #
    def _seq_logprob_fn(self):
        config, base = self.model_config, self.base_params

        def seq_logprob(lora, batch, side):
            lp = M.token_logprobs(config, base, batch[f"{side}_ids"],
                                  attention_mask=batch[f"{side}_mask"], lora=lora,
                                  use_fused=True, flash=True)
            return (lp * batch[f"{side}_loss_mask"]).sum(dim=-1)

        return seq_logprob

    def _dpo_reference_fn(self):
        """(ref_lora, batch) -> the reference adapter's chosen and rejected
        sequence logprobs, without gradients."""
        seq_logprob = self._seq_logprob_fn()

        @torch.no_grad()
        def reference(ref_lora, batch):
            return seq_logprob(ref_lora, batch, "chosen"), seq_logprob(ref_lora, batch, "rejected")

        return reference

    def _dpo_update_fn(self):
        """(lora, opt_state, batch, ref_c, ref_r, beta) -> (lora, opt_state,
        loss, (accuracy, mean margin)): the policy's two passes
        differentiated into the adapter, then one optimizer step."""
        seq_logprob = self._seq_logprob_fn()
        tx = self.optimizer.tx
        smooth = self.label_smoothing

        def update(lora, opt_state, batch, ref_c, ref_r, beta):
            def loss_of(lo):
                loss, acc, margin = _dpo_loss(seq_logprob(lo, batch, "chosen"),
                                              seq_logprob(lo, batch, "rejected"),
                                              ref_c, ref_r, beta, smooth)
                return loss, (acc, margin)

            return grad_step(loss_of, lora, tx, opt_state)

        return update

    def _dpo_batch(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A PreferenceGym batch as tensors on the agent's device."""
        def dtype(key):
            if key.endswith("_loss_mask"):
                return torch.float32
            return torch.long if key.endswith("_ids") else torch.int32

        return {k: self._as_tensor(v, dtype(k)) for k, v in raw.items()}

    def learn(self, experiences: Dict[str, np.ndarray]) -> Tuple[float, float]:
        """experiences: a ``PreferenceGym.reset()`` batch. Returns (loss,
        preference accuracy)."""
        batch = self._dpo_batch(experiences)
        reference = self.jit_fn("dpo_reference", self._dpo_reference_fn)
        update = self.jit_fn("dpo_update", self._dpo_update_fn)
        ref_c, ref_r = reference(self.reference.params, batch)
        lora, opt_state, loss, (acc, _) = update(self.actor.params, self.optimizer.opt_state,
                                                 batch, ref_c, ref_r, self.beta)
        if not np.isfinite(float(loss)):
            raise RuntimeError(f"Non-finite DPO loss {float(loss)}")
        self.actor.params = lora
        self.optimizer.opt_state = opt_state
        return float(loss), float(acc)

    def test(self, env) -> float:
        """Preference accuracy (share of pairs with a positive margin) over the
        whole eval split, scored through ``_logprob_fn``."""
        logprobs = self.jit_fn("logprobs", self._logprob_fn)

        def seq_lp(lora, ids, mask, loss_mask):
            return (logprobs(lora, ids, mask) * loss_mask).sum(dim=-1)

        batches = env.eval_batches() if hasattr(env, "eval_batches") else [
            env.reset(eval_mode=True)]
        correct, total = 0, 0
        for raw in batches:
            b = self._dpo_batch(raw)
            chosen = (b["chosen_ids"], b["chosen_mask"], b["chosen_loss_mask"])
            rejected = (b["rejected_ids"], b["rejected_mask"], b["rejected_loss_mask"])
            margin = ((seq_lp(self.actor.params, *chosen) - seq_lp(self.reference.params, *chosen))
                      - (seq_lp(self.actor.params, *rejected)
                         - seq_lp(self.reference.params, *rejected)))
            correct += int((margin > 0).sum())
            total += int(margin.shape[0])
        fitness = correct / max(total, 1)
        self.fitness.append(fitness)
        return fitness
