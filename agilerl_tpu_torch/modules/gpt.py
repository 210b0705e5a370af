"""EvolvableGPT: the port of ``agilerl_tpu/modules/gpt.py``.

The evolvable wrapper over the decoder of ``llm/model.py``: a layer mutation
adds or removes a block (blocks are name-keyed, ``params["blocks"][str(i)]``,
so weight preservation is tree surgery), a node mutation grows or shrinks
``d_model`` by ``n_head`` times 4, 8 or 16 with slab-wise weight transfer,
and on an MoE model an expert mutation adds or removes one expert (the
stacked ``[E, ...]`` weights keep their leading slabs; ``remove_expert``
clamps ``expert_top_k``). Every mutation re-initialises the whole tree from
the module's generator and copies the old weights' overlapping slabs in
(``modules/base.py``), as the JAX package does.

``config.use_flash_attention`` routes the non-cached attention through the
flash kernels (``ops/flash_attention_vjp.py``: forward, dQ and dK/dV on CUDA
tensors); a node mutation moves the head dim (``d_model / n_head``), and the
kernels take every head dim up to 256. Parameters live on ``device`` (the
card when None, raising without one), block weights in ``config.dtype``,
the head in f32 (``llm/model.init_params``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.llm import model as M
from agilerl_tpu_torch.modules.base import EvolvableModule, mutation
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.profiling import estimate_mfu as _estimate_mfu
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


class EvolvableGPT(EvolvableModule):
    Config = M.GPTConfig

    def __init__(
        self,
        vocab_size: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        config: Optional[M.GPTConfig] = None,
        min_layers: int = 1,
        max_layers: int = 12,
        min_d_model: int = 64,
        max_d_model: int = 1024,
        min_experts: int = 2,
        max_experts: int = 16,
        device=None,
        **kwargs,
    ):
        if config is None:
            config = M.GPTConfig(vocab_size=vocab_size, **kwargs)
        self.min_layers = min_layers
        self.max_layers = max_layers
        self.min_d_model = min_d_model
        self.max_d_model = max_d_model
        self.min_experts = min_experts
        self.max_experts = max_experts
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: M.GPTConfig) -> Dict:
        return M.init_params(gen, config, device=gen.device)

    @staticmethod
    def apply(config: M.GPTConfig, params: Dict, tokens: torch.Tensor, **kw):
        """Logits [B, T, V] (f32); with a cache also the new cache, and with
        ``return_aux=True`` also the MoE load-balance loss, last."""
        if kw.get("return_aux"):
            logits, caches, aux = M.apply(config, params, tokens, **kw)
            return (logits, aux) if caches is None else (logits, caches, aux)
        logits, caches = M.apply(config, params, tokens, **kw)
        return logits if caches is None else (logits, caches)

    def estimate_mfu(self, tokens_per_step: int, dt: float,
                     peak_flops: Optional[float] = None) -> Optional[float]:
        """Model FLOPs utilisation of a step of ``tokens_per_step`` tokens
        taking ``dt`` seconds, against ``peak_flops`` (the card's published
        bf16 peak when None; None on a device without one)."""
        return _estimate_mfu(self.config, tokens_per_step, dt, peak_flops)

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.n_layer >= self.max_layers:
            return self.add_node(rng=rng)
        self._morph(dataclasses.replace(cfg, n_layer=cfg.n_layer + 1))
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.n_layer <= self.min_layers:
            return self.add_node(rng=rng)
        self._morph(dataclasses.replace(cfg, n_layer=cfg.n_layer - 1))
        return {}

    @mutation(MutationType.NODE)
    def add_node(self, numb_new_nodes: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if numb_new_nodes is None:
            numb_new_nodes = cfg.n_head * int(rng.choice([4, 8, 16]))
        new_d = min(cfg.d_model + numb_new_nodes, self.max_d_model)
        new_d -= new_d % cfg.n_head  # the head dim stays integral
        self._morph(dataclasses.replace(cfg, d_model=new_d, d_ff=None))
        return {"numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_node(self, numb_new_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        if numb_new_nodes is None:
            numb_new_nodes = cfg.n_head * int(rng.choice([4, 8, 16]))
        new_d = max(cfg.d_model - numb_new_nodes, self.min_d_model)
        new_d -= new_d % cfg.n_head
        self._morph(dataclasses.replace(cfg, d_model=new_d, d_ff=None))
        return {"numb_new_nodes": numb_new_nodes}

    # -- expert mutations (MoE models; a dense model takes a node mutation) #
    @mutation(MutationType.NODE)
    def add_expert(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.n_experts == 0 or cfg.n_experts >= self.max_experts:
            return self.add_node(rng=rng)
        self._morph(dataclasses.replace(cfg, n_experts=cfg.n_experts + 1))
        return {"n_experts": cfg.n_experts + 1}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_expert(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.n_experts == 0 or cfg.n_experts <= self.min_experts:
            return self.add_node(rng=rng)
        new_e = cfg.n_experts - 1
        top_k = min(cfg.expert_top_k, new_e)  # top_k stays <= n_experts
        self._morph(dataclasses.replace(cfg, n_experts=new_e, expert_top_k=top_k))
        return {"n_experts": new_e}
