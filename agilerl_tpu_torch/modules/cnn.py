"""Evolvable CNN: the port of ``agilerl_tpu/modules/cnn.py``. NHWC inputs
and HWIO kernels, as the JAX package lays them out, so the flatten before
``output`` (h, w, c order) and carried weights need no permutation; uint8
observations are rescaled on the device. Mutations: add / remove a conv
layer, add / remove channels, change a kernel size; weights are kept slab
by slab per conv layer. A layer or kernel mutation whose stack would
collapse the spatial dims falls back (to ``add_channel``, or to no change
of kernel) where the JAX package's config check raises first."""

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
class CNNConfig:
    input_shape: Tuple[int, ...]  # (H, W, C): NHWC
    num_outputs: int
    channel_size: Tuple[int, ...] = (32, 32)
    kernel_size: Tuple[int, ...] = (3, 3)
    stride_size: Tuple[int, ...] = (1, 1)
    activation: str = "ReLU"
    output_activation: Optional[str] = None
    min_hidden_layers: int = 1
    max_hidden_layers: int = 6
    min_channel_size: int = 16
    max_channel_size: int = 256
    layer_norm: bool = True
    init_layers: bool = True

    def __post_init__(self):
        assert len(self.input_shape) == 3, "CNN input must be (H, W, C)"
        assert (len(self.channel_size) == len(self.kernel_size) == len(self.stride_size)), \
            "channel/kernel/stride must align"
        # a stack that collapses the spatial dims to zero would degenerate to
        # an input-independent, bias-only network
        h, w = _spatial_dims(self)
        if h < 1 or w < 1:
            raise ValueError(
                f"CNN arch collapses {self.input_shape[:2]} spatial dims to ({h}, {w}): reduce "
                f"kernel/stride or layer count (kernels {self.kernel_size}, strides "
                f"{self.stride_size})")


def _spatial_dims(config: CNNConfig) -> Tuple[int, int]:
    h, w, _ = config.input_shape
    for k, s in zip(config.kernel_size, config.stride_size):
        h = L.conv_out_size(h, k, s)
        w = L.conv_out_size(w, k, s)
    return h, w


class EvolvableCNN(EvolvableModule):
    Config = CNNConfig

    def __init__(self, input_shape: Optional[Tuple[int, ...]] = None,
                 num_outputs: Optional[int] = None, key: Optional[torch.Generator] = None,
                 config: Optional[CNNConfig] = None, device=None, **kwargs):
        if config is None:
            config = CNNConfig(input_shape=tuple(input_shape), num_outputs=num_outputs, **kwargs)
        super().__init__(config, derive_key(key), device)

    # ------------------------------------------------------------------ #
    @staticmethod
    def init_params(gen: torch.Generator, config: CNNConfig) -> Dict:
        params: Dict = {}
        chans = (config.input_shape[-1],) + tuple(config.channel_size)
        for i, k in enumerate(config.kernel_size):
            params[f"conv_{i}"] = L.conv2d_init(gen, k, k, chans[i], chans[i + 1])
            if config.layer_norm:
                params[f"norm_{i}"] = L.layer_norm_init(chans[i + 1], gen.device)
        h, w = _spatial_dims(config)
        params["output"] = L.dense_init(gen, h * w * config.channel_size[-1], config.num_outputs)
        return params

    @staticmethod
    def apply(config: CNNConfig, params: Dict, x: torch.Tensor, **_) -> torch.Tensor:
        act = L.get_activation(config.activation)
        out_act = L.get_activation(config.output_activation)
        h = L.maybe_rescale_image(x)
        squeeze = h.dim() == 3  # unbatched
        if squeeze:
            h = h[None]
        for i, s in enumerate(config.stride_size):
            h = L.conv2d_apply(params[f"conv_{i}"], h, stride=s)
            if config.layer_norm:
                h = L.layer_norm_apply(params[f"norm_{i}"], h)
            h = act(h)
        h = out_act(L.dense_apply(params["output"], h.reshape(h.shape[0], -1)))
        return h[0] if squeeze else h

    # -- mutations ------------------------------------------------------ #
    @mutation(MutationType.LAYER)
    def add_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """Append a 3x3, stride-1 conv layer as wide as the last one."""
        cfg = self.config
        if len(cfg.channel_size) >= cfg.max_hidden_layers:
            return self.add_channel(rng=rng)
        try:
            new = config_replace(cfg, channel_size=cfg.channel_size + (cfg.channel_size[-1],),
                                 kernel_size=cfg.kernel_size + (3,),
                                 stride_size=cfg.stride_size + (1,))
        except ValueError:
            return self.add_channel(rng=rng)
        self._morph(new)
        return {}

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """Drop the last conv layer."""
        cfg = self.config
        if len(cfg.channel_size) <= cfg.min_hidden_layers:
            return self.add_channel(rng=rng)
        self._morph(config_replace(cfg, channel_size=cfg.channel_size[:-1],
                                   kernel_size=cfg.kernel_size[:-1],
                                   stride_size=cfg.stride_size[:-1]))
        return {}

    def _pick(self, hidden_layer, numb_new_channels, rng):
        rng = derive_rng(rng)
        cfg = self.config
        if hidden_layer is None:
            hidden_layer = int(rng.integers(0, len(cfg.channel_size)))
        hidden_layer = min(hidden_layer, len(cfg.channel_size) - 1)
        if numb_new_channels is None:
            numb_new_channels = int(rng.choice([8, 16, 32]))
        return hidden_layer, numb_new_channels

    @mutation(MutationType.NODE)
    def add_channel(self, hidden_layer: Optional[int] = None,
                    numb_new_channels: Optional[int] = None,
                    rng: Optional[np.random.Generator] = None) -> Dict:
        """Grow a random conv layer by {8, 16, 32} channels."""
        hidden_layer, numb_new_channels = self._pick(hidden_layer, numb_new_channels, rng)
        cfg = self.config
        new_c = min(cfg.channel_size[hidden_layer] + numb_new_channels, cfg.max_channel_size)
        self._morph(config_replace(cfg, channel_size=tuple_set(cfg.channel_size, hidden_layer,
                                                               new_c)))
        return {"hidden_layer": hidden_layer, "numb_new_channels": numb_new_channels}

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_channel(self, hidden_layer: Optional[int] = None,
                       numb_new_channels: Optional[int] = None,
                       rng: Optional[np.random.Generator] = None) -> Dict:
        """Shrink a random conv layer by {8, 16, 32} channels."""
        hidden_layer, numb_new_channels = self._pick(hidden_layer, numb_new_channels, rng)
        cfg = self.config
        new_c = max(cfg.channel_size[hidden_layer] - numb_new_channels, cfg.min_channel_size)
        self._morph(config_replace(cfg, channel_size=tuple_set(cfg.channel_size, hidden_layer,
                                                               new_c)))
        return {"hidden_layer": hidden_layer, "numb_new_channels": numb_new_channels}

    @mutation(MutationType.NODE)
    def change_kernel(self, kernel_size: Optional[int] = None, hidden_layer: Optional[int] = None,
                      rng: Optional[np.random.Generator] = None) -> Dict:
        """Set a kernel size (of a layer after the first, when there are
        several) to one of {3, 4, 5, 7}; a size that would collapse the
        spatial dims leaves the config as it is."""
        rng = derive_rng(rng)
        cfg = self.config
        if len(cfg.channel_size) > 1:
            if hidden_layer is None:
                hidden_layer = int(rng.integers(1, len(cfg.channel_size)))
        else:
            hidden_layer = 0
        hidden_layer = min(hidden_layer, len(cfg.channel_size) - 1)
        if kernel_size is None:
            kernel_size = int(rng.choice([3, 4, 5, 7]))
        try:
            new = config_replace(cfg, kernel_size=tuple_set(cfg.kernel_size, hidden_layer,
                                                            kernel_size))
        except ValueError:
            return {"hidden_layer": hidden_layer, "kernel_size": cfg.kernel_size[hidden_layer]}
        self._morph(new)
        return {"hidden_layer": hidden_layer, "kernel_size": kernel_size}
