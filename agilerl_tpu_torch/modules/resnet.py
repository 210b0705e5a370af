"""Evolvable ResNet image encoder: the port of ``agilerl_tpu/modules/resnet.py``.
NHWC, a SAME 3x3 stem, residual blocks of two SAME 3x3 convs each with a
layer norm over channels (so a block-count mutation never changes the
spatial dims), global average pooling and a dense output. Mutations: add /
remove a block, add / remove channels."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, config_replace, mutation
from agilerl_tpu_torch.modules.custom_components import (
    residual_block_apply,
    residual_block_init,
)
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    input_shape: Tuple[int, ...]  # (H, W, C)
    num_outputs: int
    channel_size: int = 32
    num_blocks: int = 2
    min_blocks: int = 1
    max_blocks: int = 4
    min_channel_size: int = 16
    max_channel_size: int = 128
    output_activation: Optional[str] = None

    def __post_init__(self):
        assert len(self.input_shape) == 3


class EvolvableResNet(EvolvableModule):
    Config = ResNetConfig

    def __init__(self, input_shape: Optional[Tuple[int, ...]] = None,
                 num_outputs: Optional[int] = None, key: Optional[torch.Generator] = None,
                 config: Optional[ResNetConfig] = None, device=None, **kwargs):
        if config is None:
            config = ResNetConfig(input_shape=tuple(input_shape), num_outputs=num_outputs,
                                  **kwargs)
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: ResNetConfig) -> Dict:
        c = config.channel_size
        params: Dict = {"stem": L.conv2d_init(gen, 3, 3, config.input_shape[-1], c)}
        for i in range(config.num_blocks):
            params[f"block_{i}"] = residual_block_init(gen, c)
        params["output"] = L.dense_init(gen, c, config.num_outputs)
        return params

    @staticmethod
    def apply(config: ResNetConfig, params: Dict, x: torch.Tensor, **_) -> torch.Tensor:
        h = L.maybe_rescale_image(x)
        squeeze = h.dim() == 3
        if squeeze:
            h = h[None]
        h = L.conv2d_apply(params["stem"], h, stride=1, padding="SAME")
        for i in range(config.num_blocks):
            h = residual_block_apply(params[f"block_{i}"], h)
        h = h.mean(dim=(1, 2))  # global average pool
        out = L.get_activation(config.output_activation)(L.dense_apply(params["output"], h))
        return out[0] if squeeze else out

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_block(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_blocks >= cfg.max_blocks:
            return self.add_channel(rng=rng)
        self._morph(config_replace(cfg, num_blocks=cfg.num_blocks + 1))
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_block(self, rng: Optional[np.random.Generator] = None) -> Dict:
        cfg = self.config
        if cfg.num_blocks <= cfg.min_blocks:
            return self.add_channel(rng=rng)
        self._morph(config_replace(cfg, num_blocks=cfg.num_blocks - 1))
        return {}

    @mutation(MutationType.NODE)
    def add_channel(self, numb_new_channels: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_channels is None:
            numb_new_channels = int(rng.choice([8, 16, 32]))
        cfg = self.config
        self._morph(config_replace(cfg, channel_size=min(cfg.channel_size + numb_new_channels,
                                                         cfg.max_channel_size)))
        return {"numb_new_channels": numb_new_channels}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_channel(self, numb_new_channels: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None) -> Dict:
        rng = derive_rng(rng)
        if numb_new_channels is None:
            numb_new_channels = int(rng.choice([8, 16, 32]))
        cfg = self.config
        self._morph(config_replace(cfg, channel_size=max(cfg.channel_size - numb_new_channels,
                                                         cfg.min_channel_size)))
        return {"numb_new_channels": numb_new_channels}
