"""Evolvable MLP: the port of ``agilerl_tpu/modules/mlp.py`` (``MLPConfig``,
``EvolvableMLP`` with layer norm, output layer norm, noisy layers and the
``add_layer`` / ``remove_layer`` / ``add_node`` / ``remove_node``
mutations). Parameters use the JAX package's keys (``layer_i``, ``norm_i``,
``output``, ``norm_out``) over ``modules/layers.py``'s dense and noisy
dense layers, so weights carry across through numpy unchanged."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, config_replace, mutation, tuple_set
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    num_inputs: int
    num_outputs: int
    hidden_size: Tuple[int, ...] = (64, 64)
    activation: str = "ReLU"
    output_activation: Optional[str] = None
    min_hidden_layers: int = 1
    max_hidden_layers: int = 3
    min_mlp_nodes: int = 64
    max_mlp_nodes: int = 500
    layer_norm: bool = True
    output_layernorm: bool = False
    output_vanish: bool = True
    init_layers: bool = True
    noisy: bool = False
    noise_std: float = 0.5

    def __post_init__(self):
        assert len(self.hidden_size) >= 1, "MLP needs at least one hidden layer"
        assert self.num_inputs > 0 and self.num_outputs > 0


class EvolvableMLP(EvolvableModule):
    Config = MLPConfig

    def __init__(
        self,
        num_inputs: Optional[int] = None,
        num_outputs: Optional[int] = None,
        key: Optional[torch.Generator] = None,
        config: Optional[MLPConfig] = None,
        device=None,
        **kwargs,
    ):
        if config is None:
            config = MLPConfig(num_inputs=num_inputs, num_outputs=num_outputs, **kwargs)
        if key is None:
            key = derive_key()
        super().__init__(config, key, device)

    # ------------------------------------------------------------------ #
    @staticmethod
    def init_params(gen: torch.Generator, config: MLPConfig) -> Dict:
        sizes = (config.num_inputs,) + tuple(config.hidden_size)
        if config.noisy:
            def make(i, o):
                return L.noisy_dense_init(gen, i, o, config.noise_std)
        else:
            def make(i, o):
                return L.dense_init(gen, i, o)
        params: Dict = {}
        for i in range(len(config.hidden_size)):
            params[f"layer_{i}"] = make(sizes[i], sizes[i + 1])
            if config.layer_norm:
                params[f"norm_{i}"] = L.layer_norm_init(sizes[i + 1], gen.device)
        out = make(sizes[-1], config.num_outputs)
        if config.output_vanish and not config.noisy:
            out = {k: v * 0.1 for k, v in out.items()}
        params["output"] = out
        if config.output_layernorm:
            params["norm_out"] = L.layer_norm_init(config.num_outputs, gen.device)
        return params

    @staticmethod
    def apply(config: MLPConfig, params: Dict, x: torch.Tensor,
              key: Optional[torch.Generator] = None, **_) -> torch.Tensor:
        """``key`` draws the noisy layers' noise (None: their mean weights)."""
        act = L.get_activation(config.activation)
        out_act = L.get_activation(config.output_activation)
        if config.noisy:
            def dense(p, h):
                return L.noisy_dense_apply(p, h, key)
        else:
            dense = L.dense_apply
        h = x.float()
        for i in range(len(config.hidden_size)):
            h = dense(params[f"layer_{i}"], h)
            if config.layer_norm:
                h = L.layer_norm_apply(params[f"norm_{i}"], h)
            h = act(h)
        h = dense(params["output"], h)
        if config.output_layernorm:
            h = L.layer_norm_apply(params["norm_out"], h)
        return out_act(h)

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """Append a hidden layer as wide as the last one (a node mutation
        when at ``max_hidden_layers``)."""
        cfg = self.config
        if len(cfg.hidden_size) >= cfg.max_hidden_layers:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, hidden_size=cfg.hidden_size + (cfg.hidden_size[-1],)))
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """Drop the last hidden layer (a node mutation at ``min_hidden_layers``)."""
        cfg = self.config
        if len(cfg.hidden_size) <= cfg.min_hidden_layers:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, hidden_size=cfg.hidden_size[:-1]))
        return {}

    def _pick(self, hidden_layer, numb_new_nodes, rng):
        rng = derive_rng(rng)
        cfg = self.config
        if hidden_layer is None:
            hidden_layer = int(rng.integers(0, len(cfg.hidden_size)))
        hidden_layer = min(hidden_layer, len(cfg.hidden_size) - 1)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([16, 32, 64]))
        return hidden_layer, numb_new_nodes

    @mutation(MutationType.NODE)
    def add_node(self, hidden_layer: Optional[int] = None, numb_new_nodes: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        """Grow a random hidden layer by {16, 32, 64} nodes."""
        hidden_layer, numb_new_nodes = self._pick(hidden_layer, numb_new_nodes, rng)
        cfg = self.config
        new_size = min(cfg.hidden_size[hidden_layer] + numb_new_nodes, cfg.max_mlp_nodes)
        self._morph(config_replace(
            cfg, hidden_size=tuple_set(cfg.hidden_size, hidden_layer, new_size)))
        return {"hidden_layer": hidden_layer, "numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_node(self, hidden_layer: Optional[int] = None, numb_new_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        """Shrink a random hidden layer by {16, 32, 64} nodes."""
        hidden_layer, numb_new_nodes = self._pick(hidden_layer, numb_new_nodes, rng)
        cfg = self.config
        new_size = max(cfg.hidden_size[hidden_layer] - numb_new_nodes, cfg.min_mlp_nodes)
        self._morph(config_replace(
            cfg, hidden_size=tuple_set(cfg.hidden_size, hidden_layer, new_size)))
        return {"hidden_layer": hidden_layer, "numb_new_nodes": numb_new_nodes}
