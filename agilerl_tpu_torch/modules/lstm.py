"""Evolvable LSTM encoder: the port of ``agilerl_tpu/modules/lstm.py``. The
recurrence is ``layers.lstm_scan`` over time, layer by layer; the hidden
state is an explicit ``{"h", "c"}`` tree of ``[L, B, H]`` tensors that the
caller threads. Mutations: add / remove a layer, add / remove nodes of the
hidden width."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, config_replace, mutation
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    num_inputs: int
    num_outputs: int
    hidden_size: int = 64
    num_layers: int = 1
    min_hidden_size: int = 16
    max_hidden_size: int = 500
    min_layers: int = 1
    max_layers: int = 3
    output_activation: Optional[str] = None

    def __post_init__(self):
        assert self.num_inputs > 0 and self.num_outputs > 0
        assert self.min_layers <= self.num_layers <= self.max_layers


class EvolvableLSTM(EvolvableModule):
    Config = LSTMConfig

    def __init__(self, num_inputs: Optional[int] = None, num_outputs: Optional[int] = None,
                 key: Optional[torch.Generator] = None, config: Optional[LSTMConfig] = None,
                 device=None, **kwargs):
        if config is None:
            config = LSTMConfig(num_inputs=num_inputs, num_outputs=num_outputs, **kwargs)
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: LSTMConfig) -> Dict:
        params: Dict = {}
        in_dim = config.num_inputs
        for i in range(config.num_layers):
            params[f"lstm_{i}"] = L.lstm_cell_init(gen, in_dim, config.hidden_size)
            in_dim = config.hidden_size
        params["output"] = L.dense_init(gen, config.hidden_size, config.num_outputs)
        return params

    @staticmethod
    def initial_hidden(config: LSTMConfig, batch: int, device=None) -> Dict[str, torch.Tensor]:
        """The zero hidden state ``{"h", "c"}``, each ``[L, B, H]``."""
        shape = (config.num_layers, batch, config.hidden_size)
        return {"h": torch.zeros(shape, device=device), "c": torch.zeros(shape, device=device)}

    @staticmethod
    def apply(config: LSTMConfig, params: Dict, x: torch.Tensor,
              hidden: Optional[Dict[str, torch.Tensor]] = None, return_hidden: bool = False,
              **_):
        """x: [B, D] one step or [T, B, D] a sequence. Returns the output at
        the last step (and the new hidden state when ``return_hidden``)."""
        if x.dim() == 2:
            x = x[None]
        if hidden is None:
            hidden = EvolvableLSTM.initial_hidden(config, x.shape[1], x.device)
        hs, cs = [], []
        seq = x.float()
        for i in range(config.num_layers):
            seq, (h, c) = L.lstm_scan(params[f"lstm_{i}"], seq, hidden["h"][i], hidden["c"][i])
            hs.append(h)
            cs.append(c)
        out = L.get_activation(config.output_activation)(L.dense_apply(params["output"], seq[-1]))
        if return_hidden:
            return out, {"h": torch.stack(hs), "c": torch.stack(cs)}
        return out

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_layers >= cfg.max_layers:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, num_layers=cfg.num_layers + 1))
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_layers <= cfg.min_layers:
            return self.add_node(rng=rng)
        self._morph(config_replace(cfg, num_layers=cfg.num_layers - 1))
        return {}

    @mutation(MutationType.NODE)
    def add_node(self, numb_new_nodes: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([16, 32, 64]))
        cfg = self.config
        self._morph(config_replace(cfg, hidden_size=min(cfg.hidden_size + numb_new_nodes,
                                                        cfg.max_hidden_size)))
        return {"numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_node(self, numb_new_nodes: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([16, 32, 64]))
        cfg = self.config
        self._morph(config_replace(cfg, hidden_size=max(cfg.hidden_size - numb_new_nodes,
                                                        cfg.min_hidden_size)))
        return {"numb_new_nodes": numb_new_nodes}
