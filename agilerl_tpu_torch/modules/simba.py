"""Evolvable SimBa encoder: the port of ``agilerl_tpu/modules/simba.py``. An
input projection, residual blocks (LayerNorm -> Dense(scale * h) -> ReLU
-> Dense(h) + skip), a final LayerNorm and a dense output. Mutations: add /
remove a block, add / remove nodes of the hidden width."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, config_replace, mutation
from agilerl_tpu_torch.modules.custom_components import (
    simba_residual_block_apply,
    simba_residual_block_init,
)
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


@dataclasses.dataclass(frozen=True)
class SimBaConfig:
    num_inputs: int
    num_outputs: int
    hidden_size: int = 128
    num_blocks: int = 2
    min_blocks: int = 1
    max_blocks: int = 4
    min_nodes: int = 64
    max_nodes: int = 500
    output_activation: Optional[str] = None
    scale_factor: int = 4


class EvolvableSimBa(EvolvableModule):
    Config = SimBaConfig

    def __init__(self, num_inputs: Optional[int] = None, num_outputs: Optional[int] = None,
                 key: Optional[torch.Generator] = None, config: Optional[SimBaConfig] = None,
                 device=None, **kwargs):
        if config is None:
            config = SimBaConfig(num_inputs=num_inputs, num_outputs=num_outputs, **kwargs)
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: SimBaConfig) -> Dict:
        params: Dict = {"proj": L.dense_init(gen, config.num_inputs, config.hidden_size)}
        for i in range(config.num_blocks):
            params[f"block_{i}"] = simba_residual_block_init(gen, config.hidden_size,
                                                             config.scale_factor)
        params["norm_out"] = L.layer_norm_init(config.hidden_size, gen.device)
        params["output"] = L.dense_init(gen, config.hidden_size, config.num_outputs)
        return params

    @staticmethod
    def apply(config: SimBaConfig, params: Dict, x: torch.Tensor, **_) -> torch.Tensor:
        h = L.dense_apply(params["proj"], x.float())
        for i in range(config.num_blocks):
            h = simba_residual_block_apply(params[f"block_{i}"], h)
        h = L.layer_norm_apply(params["norm_out"], h)
        out = L.dense_apply(params["output"], h)
        return L.get_activation(config.output_activation)(out)

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_block(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_blocks >= cfg.max_blocks:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, num_blocks=cfg.num_blocks + 1))
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_block(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_blocks <= cfg.min_blocks:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, num_blocks=cfg.num_blocks - 1))
        return {}

    @mutation(MutationType.NODE)
    def add_node(self, numb_new_nodes: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([16, 32, 64]))
        cfg = self.config
        self._morph(config_replace(cfg, hidden_size=min(cfg.hidden_size + numb_new_nodes,
                                                        cfg.max_nodes)))
        return {"numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_node(self, numb_new_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([16, 32, 64]))
        cfg = self.config
        self._morph(config_replace(cfg, hidden_size=max(cfg.hidden_size - numb_new_nodes,
                                                        cfg.min_nodes)))
        return {"numb_new_nodes": numb_new_nodes}
