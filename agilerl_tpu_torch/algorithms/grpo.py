"""GRPO, group-relative policy optimisation for LLM finetuning: the port of
``agilerl_tpu/algorithms/grpo.py``.

Actor and reference are two LoRA adapters over one frozen base model
(``llm/model.py``). ``learn`` runs two no-grad log-probability passes (old and
reference policy), then minibatch epochs of the clipped-ratio + k3-KL loss
(``_grpo_loss_core``) differentiated through ``token_logprobs`` into the actor
adapter, stepped by AdamW after a global-norm clip (``core/optimizer.py``).
Every log-probability pass goes through the flash attention and fused
log-probability paths: on CUDA tensors their hand-written kernels, forward
and backward; on CPU tensors their plain versions.

Rollouts route as in the JAX package: through ``llm/serving.BucketedGenerator``
by default (``bucketed_decode``; decode stops within one chunk of every row
hitting EOS), through ``llm/serving.ContinuousGenerator`` on opt-in
(``continuous_decode``, with ``speculative_decode`` and ``capture_logprobs``;
group repeats of a prompt prefill once through the prefix cache), and
through the dense ``generate`` when the batch does not fit the bucket grid
(or, for the continuous tier, a row is all pad). Env
``AGILERL_TPU_DISABLE_BUCKETED_DECODE=1`` turns both serving routes off;
``AGILERL_TPU_CONTINUOUS_DECODE=1`` opts into the continuous one.
``attach_rollout_fleet`` routes continuous rollouts through a
``llm/fleet.ServingFleet`` (the online flywheel's rollout tier).

Not ported yet: the sequence-parallel learn (``sequence_parallel_axis``)
raises ``NotImplementedError``; ``to_mesh`` (sharding plans) comes with the
distribution slice.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.core.base import EvolvableAlgorithm
from agilerl_tpu_torch.algorithms.core.optimizer import (
    CosineLRScheduleConfig,
    OptimizerWrapper,
    Transform,
    grad_step,
)
from agilerl_tpu_torch.algorithms.core.registry import (
    HyperparameterConfig,
    NetworkGroup,
    OptimizerConfig,
    RLParameter,
)
from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.llm.generate import generate
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.tree import tree_copy, tree_from_numpy, tree_map, tree_to_numpy


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes")


def default_hp_config() -> HyperparameterConfig:
    return HyperparameterConfig(
        lr=RLParameter(min=1e-8, max=1e-4, dtype=float),
        beta=RLParameter(min=1e-4, max=0.1, dtype=float),
        group_size=RLParameter(min=2, max=16, dtype=int),
    )


def _grpo_loss_core(lp, batch, clip, beta):
    """Clipped-ratio + k3-KL GRPO loss from per-token logprobs. Returns
    (loss, mean k3 KL). ``batch["rho"]``, when present, is the truncated
    per-token importance weight of an off-policy batch; it multiplies the
    policy-gradient term (a constant under differentiation, as ``old_lp``)."""
    lp = lp * batch["loss_mask"]
    ratio = torch.exp(lp - batch["old_lp"])
    adv = batch["advantage"][:, None]
    s1 = ratio * adv
    s2 = torch.clamp(ratio, 1 - clip, 1 + clip) * adv
    pg = -torch.minimum(s1, s2)
    rho = batch.get("rho")
    if rho is not None:
        pg = pg * rho
    log_ratio_ref = batch["ref_lp"] - lp
    kl = torch.exp(log_ratio_ref) - log_ratio_ref - 1.0
    denom = batch["loss_mask"].sum().clamp_min(1.0)
    loss = ((pg + beta * kl) * batch["loss_mask"]).sum() / denom
    kl_mean = (kl * batch["loss_mask"]).sum() / denom
    return loss, kl_mean


def base_to_host(params: Any) -> Dict[str, Any]:
    """A frozen base as host numpy: every leaf's array (a bf16 leaf as its
    ``uint16`` bits) and dtype name, as two trees."""
    from agilerl_tpu_torch.llm.convert import tensor_to_host

    return {"host_arrays": tree_map(lambda t: tensor_to_host(t)[0], params),
            "dtypes": tree_map(lambda t: str(t.dtype).replace("torch.", ""), params)}


def base_from_host(blob: Dict[str, Any], device) -> Any:
    """The inverse of ``base_to_host``, on ``device``."""
    from agilerl_tpu_torch.llm.convert import tensor_from_host

    return tree_map(lambda a, d: tensor_from_host(a, d, device), blob["host_arrays"],
                    blob["dtypes"])


class _LoraNet:
    """Network-shaped holder so the registry/clone machinery sees the adapter
    as an evolvable attribute (LLM configs never mutate)."""

    def __init__(self, config, params):
        self.config = config
        self.params = params


def make_update_fn(config, tx: Transform, lora_scale: float, use_flash: bool = True,
                   use_fused_loss: Optional[bool] = None):
    """The GRPO update as a function of (base, lora, opt_state, batch, clip,
    beta) -> (lora, opt_state, loss, kl): the loss differentiated into the
    adapter only (the base and the head need no gradient, so the fused
    backward skips dW), then one optimizer step. ``use_fused_loss`` (default:
    follow ``use_flash``) routes the lm head through the fused path."""
    if use_fused_loss is None:
        use_fused_loss = use_flash

    def update(base, lora, opt_state, batch, clip, beta):
        def loss_of(lo):
            lp = M.token_logprobs(
                config, base, batch["tokens"], attention_mask=batch["mask"],
                lora=lo, lora_scale=lora_scale, flash=use_flash, use_fused=use_fused_loss,
            )
            return _grpo_loss_core(lp, batch, clip, beta)

        return grad_step(loss_of, lora, tx, opt_state)

    return update


class GRPO(EvolvableAlgorithm):
    supports_activation_mutation = False

    def __init__(
        self,
        config: M.GPTConfig,
        base_params: Any = None,
        pad_token_id: int = 0,
        eos_token_id: Optional[int] = None,
        index: int = 0,
        hp_config: Optional[HyperparameterConfig] = None,
        batch_size: int = 8,
        beta: float = 0.04,
        lr: float = 5e-6,
        clip_coef: float = 0.2,
        max_grad_norm: float = 0.1,
        update_epochs: int = 1,
        group_size: int = 8,
        temperature: float = 0.9,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        max_output_tokens: int = 64,
        min_output_tokens: Optional[int] = None,
        cosine_lr_schedule_config: Optional[CosineLRScheduleConfig] = None,
        lora_rank: int = 8,
        lora_targets: Tuple[str, ...] = ("wq", "wv"),
        lora_scale: float = 2.0,
        sequence_parallel_axis: Optional[str] = None,
        bucketed_decode: bool = True,
        continuous_decode: bool = False,
        speculative_decode=None,
        capture_logprobs: bool = False,
        device: DeviceLike = None,
        **kwargs,
    ):
        if sequence_parallel_axis:
            raise NotImplementedError("GRPO sequence_parallel_axis is not ported yet")
        super().__init__(index=index, hp_config=hp_config or default_hp_config(),
                         device=device, **kwargs)
        self.dev = resolve_device(device)
        self.model_config = config
        self.pad_token_id = int(pad_token_id)
        self.eos_token_id = eos_token_id
        self.batch_size = int(batch_size)
        self.beta = float(beta)
        self.lr = float(lr)
        self.clip_coef = float(clip_coef)
        self.max_grad_norm = float(max_grad_norm)
        self.update_epochs = int(update_epochs)
        self.group_size = int(group_size)
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.max_output_tokens = int(max_output_tokens)
        self.min_output_tokens = min_output_tokens
        self.cosine_lr_schedule_config = cosine_lr_schedule_config
        self.lora_rank = int(lora_rank)
        self.lora_targets = tuple(lora_targets)
        self.lora_scale = float(lora_scale)
        # AGILERL_TPU_DISABLE_BUCKETED_DECODE turns BOTH serving routes off;
        # the two flags are otherwise independent (continuous-only is valid)
        serving_killed = _env_flag("AGILERL_TPU_DISABLE_BUCKETED_DECODE")
        self.bucketed_decode = bool(bucketed_decode) and not serving_killed
        # opt-in: rollouts through the continuous/paged tier
        self.continuous_decode = (
            bool(continuous_decode) or _env_flag("AGILERL_TPU_CONTINUOUS_DECODE")
        ) and not serving_killed
        # continuous-tier extras (not part of _serving_knobs: the bucketed
        # generator takes neither)
        self.speculative_decode = speculative_decode
        self.capture_logprobs = bool(capture_logprobs)
        self._bucketed_gen = None
        self._bucketed_gen_knobs = None
        self._continuous_gen = None
        self._continuous_gen_knobs = None
        self.last_generation_info = None
        # a ServingFleet routing continuous rollouts (attach_rollout_fleet);
        # not part of init_dict: a clone decodes on its own generators
        self.rollout_fleet = None

        if base_params is None:
            base_params = M.init_params(self.next_key(self.dev), config, device=self.dev)
        self.base_params = base_params  # frozen
        # actor adapter (trainable) + reference adapter (frozen snapshot)
        self.actor = _LoraNet(config, M.init_lora(
            self.next_key(self.dev), config, lora_rank, self.lora_targets, device=self.dev))
        self.reference = _LoraNet(config, tree_copy(self.actor.params))
        self.optimizer = OptimizerWrapper(
            optimizer="adamw", lr=self.lr, max_grad_norm=self.max_grad_norm,
            lr_schedule=cosine_lr_schedule_config,
        )
        self.register_network_group(NetworkGroup(eval="actor", policy=True))
        self.register_optimizer(OptimizerConfig(name="optimizer", networks=["actor"], lr="lr"))
        self.finalize_registry()
        self._reference_epoch = -1

    # ------------------------------------------------------------------ #
    @property
    def init_dict(self) -> Dict[str, Any]:
        return {
            "config": self.model_config,
            "base_params": self.base_params,  # shared reference, not copied
            "pad_token_id": self.pad_token_id,
            "eos_token_id": self.eos_token_id,
            "index": self.index,
            "batch_size": self.batch_size,
            "beta": self.beta,
            "lr": self.lr,
            "clip_coef": self.clip_coef,
            "max_grad_norm": self.max_grad_norm,
            "update_epochs": self.update_epochs,
            "group_size": self.group_size,
            "temperature": self.temperature,
            "top_k": self.top_k,
            "top_p": self.top_p,
            "max_output_tokens": self.max_output_tokens,
            "min_output_tokens": self.min_output_tokens,
            "cosine_lr_schedule_config": self.cosine_lr_schedule_config,
            "lora_rank": self.lora_rank,
            "lora_targets": self.lora_targets,
            "lora_scale": self.lora_scale,
            "bucketed_decode": self.bucketed_decode,
            "continuous_decode": self.continuous_decode,
            "speculative_decode": self.speculative_decode,
            "capture_logprobs": self.capture_logprobs,
            "device": self.device,
        }

    def _on_clone(self, parent) -> None:
        self.reference.params = tree_copy(parent.reference.params)
        self._reference_epoch = parent._reference_epoch

    # -- checkpoints ----------------------------------------------------- #
    def checkpoint_dict(self, include_base: bool = True) -> Dict[str, Any]:
        """The base class's checkpoint plus the reference adapter and the
        dataset epoch it was taken at, so a restored agent keeps the
        reference of its epoch's start (the JAX package keeps neither, and
        its resumed agent re-copies the restored actor into the reference
        at its next ``set_reference_policy``). ``init_dict``'s frozen base
        is host numpy (bf16 as its ``uint16`` bits), so ``load`` rebuilds the
        agent from the file alone; ``include_base=False`` leaves it out
        (``None``), as a whole-run snapshot does."""
        ckpt = super().checkpoint_dict()
        ckpt["init_dict"] = dict(ckpt["init_dict"], base_params=(
            base_to_host(self.base_params) if include_base else None))
        ckpt["reference"] = {"params": tree_to_numpy(self.reference.params),
                             "epoch": int(self._reference_epoch)}
        return ckpt

    def _restore(self, ckpt: Dict[str, Any]) -> None:
        super()._restore(ckpt)
        ref = ckpt.get("reference")
        if ref is not None:
            self.reference.params = tree_from_numpy(ref["params"], self.dev)
            self._reference_epoch = int(ref["epoch"])

    @classmethod
    def _init_from_checkpoint(cls, init: Dict[str, Any], device) -> Dict[str, Any]:
        if isinstance(init.get("base_params"), dict) and "host_arrays" in init["base_params"]:
            init["base_params"] = base_from_host(init["base_params"], resolve_device(device))
        return init

    def set_reference_policy(self, epoch: int) -> None:
        """Refresh the reference adapter from the actor once per dataset epoch."""
        if epoch != self._reference_epoch:
            self.reference.params = tree_copy(self.actor.params)
            self._reference_epoch = epoch

    def _serving_knobs(self):
        """The ONE sampling recipe both serving generators are built from."""
        return dict(
            max_new_tokens=self.max_output_tokens,
            pad_id=self.pad_token_id, eos_id=self.eos_token_id,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, min_new_tokens=self.min_output_tokens,
            lora_scale=self.lora_scale,
        )

    def _get_bucketed_generator(self):
        """Lazily build (and rebuild on a knob change) the bucketed generator."""
        from agilerl_tpu_torch.llm.serving import BucketedGenerator

        knobs = self._serving_knobs()
        if self._bucketed_gen is None or self._bucketed_gen_knobs != knobs:
            self._bucketed_gen = BucketedGenerator(self.model_config, device=self.dev, **knobs)
            self._bucketed_gen_knobs = knobs
        return self._bucketed_gen

    def _get_continuous_generator(self):
        """Lazily build (and rebuild on a knob change) the continuous
        generator. GRPO rollouts are the no-shed path: every row comes back."""
        from agilerl_tpu_torch.llm.serving import ContinuousGenerator

        knobs = dict(self._serving_knobs(), speculate=self.speculative_decode,
                     capture_logprobs=self.capture_logprobs)
        if self._continuous_gen is None or self._continuous_gen_knobs != knobs:
            self._continuous_gen = ContinuousGenerator(self.model_config, device=self.dev,
                                                       **knobs)
            self._continuous_gen_knobs = knobs
        return self._continuous_gen

    def attach_rollout_fleet(self, fleet) -> None:
        """Route continuous rollouts through a ``llm/fleet.ServingFleet``:
        prefix-affinity routing over N replicas instead of a private
        generator. The fleet's sampling recipe must match this agent's (same
        ``generate`` key-fold contract, so a fleet and a bare generator given
        the same key produce identical streams); a mismatch would silently
        change the rollout distribution, so it is rejected. Sets
        ``continuous_decode``. ``None`` detaches and restores the pre-attach
        ``continuous_decode``."""
        if fleet is None:
            if self.rollout_fleet is not None:
                self.continuous_decode = self._pre_fleet_continuous_decode
            self.rollout_fleet = None
            return
        ref = fleet._grid_ref()
        theirs = dict(
            max_new_tokens=ref.max_new_tokens, pad_id=ref.pad_id,
            eos_id=ref.eos_id, temperature=ref.temperature,
            top_k=ref.top_k, top_p=ref.top_p,
            min_new_tokens=ref.min_new_tokens, lora_scale=ref.lora_scale,
        )
        mine = self._serving_knobs()
        if theirs != mine:
            raise ValueError(
                f"fleet sampling recipe {theirs} does not match this "
                f"agent's serving knobs {mine}; build the fleet from the "
                "same recipe (ContinuousGenerator kwargs) as the agent")
        if self.rollout_fleet is None:
            self._pre_fleet_continuous_decode = self.continuous_decode
        self.rollout_fleet = fleet
        self.continuous_decode = True

    # ------------------------------------------------------------------ #
    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.dev, dtype=dtype)

    def get_action(self, prompts: Dict[str, np.ndarray], training: bool = True):
        """Generate group_size completions per prompt. prompts: {"input_ids":
        [B, P], "attention_mask"}. Returns (completion_ids [B*G, N],
        completion_mask [B*G, N]) as numpy. Routes through the bucketed
        generator (default) or the continuous one (opt-in), else the dense
        path; an attached fleet takes the continuous route. The serving
        tiers' telemetry lands in ``last_generation_info`` (None after a
        dense rollout)."""
        ids_np = np.asarray(prompts["input_ids"])
        mask_np = np.asarray(prompts["attention_mask"])
        g = self.group_size if training else 1
        ids_np = np.repeat(ids_np, g, axis=0)
        mask_np = np.repeat(mask_np, g, axis=0)
        if ids_np.shape[0] == 0:
            N = self.max_output_tokens
            self.last_generation_info = None
            return np.zeros((0, N), np.int32), np.zeros((0, N), np.int32)
        row_lens = mask_np.sum(axis=1)
        longest = int(row_lens.max())
        gen = None
        if self.continuous_decode:
            gen = (self.rollout_fleet if self.rollout_fleet is not None
                   else self._get_continuous_generator())
            # an all-pad row has no prompt to admit: the dense path takes it
            if int(row_lens.min()) == 0 or not gen.fits(ids_np.shape[0], longest):
                gen = None
        elif self.bucketed_decode:
            gen = self._get_bucketed_generator()
            if not gen.fits(ids_np.shape[0], longest):
                gen = None
        if gen is not None:
            # the continuous tier seeds its per-request keys on the host
            key = self.next_key(self.dev if gen is self._bucketed_gen else "cpu")
            seqs = [row[m.astype(bool)] for row, m in zip(ids_np, mask_np)]
            comp, cmask, self.last_generation_info = gen.generate(
                seqs, key, self.base_params, lora=self.actor.params, greedy=not training)
            return comp, cmask
        self.last_generation_info = None  # no stale serving telemetry
        comp, cmask = generate(
            self.model_config, self.base_params, self._as_tensor(ids_np, torch.long),
            self._as_tensor(mask_np, torch.int32), self.next_key(self.dev),
            max_new_tokens=self.max_output_tokens, lora=self.actor.params,
            lora_scale=self.lora_scale,
            temperature=self.temperature if training else 0.0,
            top_k=self.top_k, top_p=self.top_p,
            min_new_tokens=self.min_output_tokens,
            eos_id=self.eos_token_id, pad_id=self.pad_token_id,
        )
        return comp.cpu().numpy().astype(np.int32), cmask.cpu().numpy()

    # ------------------------------------------------------------------ #
    @staticmethod
    def _calculate_advantage(rewards: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
        """Group z-score. rewards [B, G] -> [B*G]."""
        mean = rewards.mean(dim=1, keepdim=True)
        std = rewards.std(dim=1, keepdim=True, correction=0)
        return ((rewards - mean) / (std + eps)).reshape(-1)

    def _logprob_fn(self):
        config, base, scale = self.model_config, self.base_params, self.lora_scale

        @torch.no_grad()
        def logprobs(lora, tokens, mask):
            return M.token_logprobs(config, base, tokens, attention_mask=mask, lora=lora,
                                    lora_scale=scale, use_fused=True, flash=True)

        return logprobs

    def _update_fn(self):
        base = self.base_params
        update = make_update_fn(self.model_config, self.optimizer.tx, self.lora_scale,
                                use_flash=True)

        def bound(lora, opt_state, batch, clip, beta):
            return update(base, lora, opt_state, batch, clip, beta)

        return bound

    def _learn_fns(self):
        return self.jit_fn("logprobs", self._logprob_fn), self.jit_fn("update", self._update_fn)

    def learn(self, experiences: Tuple) -> Tuple[float, float]:
        """experiences = (ids, action_masks, rewards[, attention_mask]):
        ids [B*G, P+N] full prompt+completion sequences, action_masks
        [B*G, P+N-1] marking completion-token predictions, rewards [B, G]; pass
        the optional 4th element when pad_token_id collides with a real
        vocabulary token (otherwise attention defaults to ids != pad_token_id).
        Returns (mean loss, mean k3 KL vs reference)."""
        if len(experiences) == 4:
            ids, action_masks, rewards, attn = experiences
        else:
            ids, action_masks, rewards = experiences
            attn = None
        ids, mask, loss_mask = self._learn_masks(ids, action_masks, attn)
        advantage = self._calculate_advantage(self._as_tensor(rewards, torch.float32))
        logprobs, update = self._learn_fns()
        old_lp = logprobs(self.actor.params, ids, mask) * loss_mask
        ref_lp = logprobs(self.reference.params, ids, mask) * loss_mask
        return self._run_update_epochs(update, ids, mask, loss_mask, old_lp, ref_lp, advantage)

    def _run_update_epochs(self, update, ids, mask, loss_mask, old_lp, ref_lp, advantage,
                           rho=None):
        """The minibatch-epoch engine behind ``learn`` and
        ``learn_from_trajectory``: permutation order (``torch.randperm`` on the
        agent's generator), the NaN guard, and the running means."""
        lora, opt_state = self.actor.params, self.optimizer.opt_state
        n_rows = ids.shape[0]
        total, total_kl, n_updates = 0.0, 0.0, 0
        for _ in range(self.update_epochs):
            perm = torch.randperm(n_rows, generator=self._key).to(self.dev)
            for s in range(0, n_rows, self.batch_size):
                idx = perm[s:s + self.batch_size]
                batch = {
                    "tokens": ids[idx],
                    "mask": mask[idx],
                    "loss_mask": loss_mask[idx],
                    "old_lp": old_lp[idx],
                    "ref_lp": ref_lp[idx],
                    "advantage": advantage[idx],
                }
                if rho is not None:
                    batch["rho"] = rho[idx]
                lora, opt_state, loss, kl = update(lora, opt_state, batch, self.clip_coef,
                                                   self.beta)
                if not np.isfinite(float(loss)):
                    # keep the returned state so the agent stays usable
                    self.actor.params = lora
                    self.optimizer.opt_state = opt_state
                    raise RuntimeError(f"Non-finite GRPO loss {float(loss)}: aborting")
                total += float(loss)
                total_kl += float(kl)
                n_updates += 1
        self.actor.params = lora
        self.optimizer.opt_state = opt_state
        n = max(n_updates, 1)
        return total / n, total_kl / n

    def _learn_masks(self, ids, action_masks, attention_mask):
        """(ids, attention mask, loss mask) as tensors on the agent's device."""
        ids = self._as_tensor(ids, torch.long)
        if attention_mask is not None:
            mask = self._as_tensor(attention_mask, torch.int32)
        else:
            mask = (ids != self.pad_token_id).to(torch.int32)
        return ids, mask, self._as_tensor(action_masks, torch.float32)

    def behavior_logprobs(self, ids, action_masks, attention_mask=None) -> np.ndarray:
        """Per-token logprobs of ``ids`` under the current actor adapter,
        masked to completion predictions (the behavior-policy record)."""
        ids, mask, loss_mask = self._learn_masks(ids, action_masks, attention_mask)
        logprobs, _ = self._learn_fns()
        return (logprobs(self.actor.params, ids, mask) * loss_mask).cpu().numpy()

    def learn_from_trajectory(self, ids, action_masks, rewards, behavior_lp,
                              attention_mask=None,
                              rho_clip: Optional[float] = 2.0) -> Tuple[float, float]:
        """Staleness-aware off-policy GRPO update. ``old_lp`` stays the current
        adapter's logprobs at learn start; unless ``rho_clip`` is None, the
        staleness is corrected once by ``rho = min(exp(old_lp - behavior_lp),
        rho_clip)`` on the policy-gradient term."""
        ids, mask, loss_mask = self._learn_masks(ids, action_masks, attention_mask)
        advantage = self._calculate_advantage(self._as_tensor(rewards, torch.float32))
        logprobs, update = self._learn_fns()
        old_lp = logprobs(self.actor.params, ids, mask) * loss_mask
        ref_lp = logprobs(self.reference.params, ids, mask) * loss_mask
        rho = None
        if rho_clip is not None:
            behavior = self._as_tensor(behavior_lp, torch.float32) * loss_mask
            rho = torch.exp(old_lp - behavior).clamp_max(float(rho_clip))
        return self._run_update_epochs(update, ids, mask, loss_mask, old_lp, ref_lp,
                                       advantage, rho=rho)

    # ------------------------------------------------------------------ #
    def test(self, env) -> float:
        """Greedy-decode the full eval split and average the reward."""
        all_rewards = []
        batches = env.eval_batches() if hasattr(env, "eval_batches") else [
            env.reset(eval_mode=True)]
        for prompts in batches:
            comp, cmask = self.get_action(prompts, training=False)
            _, rewards = env.step_eval(comp, cmask)
            all_rewards.append(np.ravel(np.asarray(rewards)))
        fitness = float(np.mean(np.concatenate(all_rewards)))
        self.fitness.append(fitness)
        return fitness
