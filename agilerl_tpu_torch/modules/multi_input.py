"""Evolvable multi-input encoder for Dict / Tuple observation spaces: the
port of ``agilerl_tpu/modules/multi_input.py``. One feature extractor per
key (a CNN for an image subspace, an MLP otherwise), concatenated into a
dense fusion layer, then a dense output. The fusion's latent width
mutates here; the layer mutations recurse into a randomly chosen
sub-extractor."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agilerl_tpu_torch.modules import layers as L
from agilerl_tpu_torch.modules.base import EvolvableModule, config_replace, mutation
from agilerl_tpu_torch.modules.cnn import CNNConfig, EvolvableCNN
from agilerl_tpu_torch.modules.mlp import EvolvableMLP, MLPConfig
from agilerl_tpu_torch.typing import MutationType
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng
from agilerl_tpu_torch.utils.spaces import image_shape_nhwc, is_image_space, obs_dim, space_kind

# (obs key, "cnn" | "mlp", sub config): a tuple keeps the whole config hashable
SubCfg = Tuple[str, str, Any]


@dataclasses.dataclass(frozen=True)
class MultiInputConfig:
    sub_configs: Tuple[SubCfg, ...]
    num_outputs: int
    latent_dim: int = 64
    vector_spaces_mlp: bool = True
    output_activation: Optional[str] = None
    min_latent_dim: int = 16
    max_latent_dim: int = 256


def _build_sub_configs(observation_space, feature_dim: int = 64) -> Tuple[SubCfg, ...]:
    """Per-key extractor configs of a Dict / Tuple space (the port's spaces or
    gymnasium's)."""
    if space_kind(observation_space) == "dict":
        items = list(observation_space.spaces.items())
    else:
        items = [(str(i), s) for i, s in enumerate(observation_space.spaces)]
    subs = []
    for key, space in items:
        if is_image_space(space):
            h, w, _ = image_shape_nhwc(space)
            # small images need kernel <= min(h, w) and stride 1
            if min(h, w) >= 8:
                channel, kernel, stride = (16, 16), (3, 3), (2, 2)
            else:
                channel, kernel, stride = (8,), (min(2, h, w),), (1,)
            subs.append((key, "cnn", CNNConfig(input_shape=image_shape_nhwc(space),
                                               num_outputs=feature_dim, channel_size=channel,
                                               kernel_size=kernel, stride_size=stride)))
        else:
            subs.append((key, "mlp", MLPConfig(num_inputs=obs_dim(space), num_outputs=feature_dim,
                                               hidden_size=(64,), output_vanish=False)))
    return tuple(subs)


_SUB_TYPES = {"cnn": EvolvableCNN, "mlp": EvolvableMLP}


class EvolvableMultiInput(EvolvableModule):
    Config = MultiInputConfig

    def __init__(self, observation_space=None, num_outputs: Optional[int] = None,
                 key: Optional[torch.Generator] = None, config: Optional[MultiInputConfig] = None,
                 device=None, **kwargs):
        if config is None:
            config = MultiInputConfig(sub_configs=_build_sub_configs(observation_space),
                                      num_outputs=num_outputs, **kwargs)
        super().__init__(config, derive_key(key), device)

    @staticmethod
    def init_params(gen: torch.Generator, config: MultiInputConfig) -> Dict:
        params: Dict = {}
        total = 0
        for name, kind, sub_cfg in config.sub_configs:
            params[f"sub_{name}"] = _SUB_TYPES[kind].init_params(gen, sub_cfg)
            total += sub_cfg.num_outputs
        params["fusion"] = L.dense_init(gen, total, config.latent_dim)
        params["output"] = L.dense_init(gen, config.latent_dim, config.num_outputs)
        return params

    @staticmethod
    def apply(config: MultiInputConfig, params: Dict, x: Any, **_) -> torch.Tensor:
        feats = []
        for name, kind, sub_cfg in config.sub_configs:
            obs = x[name] if isinstance(x, dict) else x[int(name)]
            feats.append(_SUB_TYPES[kind].apply(sub_cfg, params[f"sub_{name}"], obs).float())
        h = F.relu(L.dense_apply(params["fusion"], torch.cat(feats, dim=-1)))
        out = L.dense_apply(params["output"], h)
        return L.get_activation(config.output_activation)(out)

    # -- mutations ------------------------------------------------------ #
    def _latent_change(self, numb_new_nodes, rng, sign: int) -> Dict:
        rng = derive_rng(rng)
        if numb_new_nodes is None:
            numb_new_nodes = int(rng.choice([8, 16, 32]))
        cfg = self.config
        latent = int(np.clip(cfg.latent_dim + sign * numb_new_nodes, cfg.min_latent_dim,
                             cfg.max_latent_dim))
        self._morph(config_replace(cfg, latent_dim=latent))
        return {"numb_new_nodes": numb_new_nodes}

    @mutation(MutationType.NODE)
    def add_latent_node(self, numb_new_nodes: Optional[int] = None,
                        rng: Optional[np.random.Generator] = None) -> Dict:
        """Grow the fusion latent width by {8, 16, 32}."""
        return self._latent_change(numb_new_nodes, rng, +1)

    @mutation(MutationType.NODE, shrink_params=True)
    def remove_latent_node(self, numb_new_nodes: Optional[int] = None,
                           rng: Optional[np.random.Generator] = None) -> Dict:
        """Shrink the fusion latent width by {8, 16, 32}."""
        return self._latent_change(numb_new_nodes, rng, -1)

    @mutation(MutationType.LAYER)
    def add_sub_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """``add_layer`` on a random sub-extractor."""
        return self._mutate_sub("add_layer", rng)

    @mutation(MutationType.LAYER, shrink_params=True)
    def remove_sub_layer(self, rng: Optional[np.random.Generator] = None) -> Dict:
        """``remove_layer`` on a random sub-extractor."""
        return self._mutate_sub("remove_layer", rng)

    def _mutate_sub(self, method: str, rng) -> Dict:
        rng = derive_rng(rng)
        cfg = self.config
        idx = int(rng.integers(0, len(cfg.sub_configs)))
        name, kind, sub_cfg = cfg.sub_configs[idx]
        sub = object.__new__(_SUB_TYPES[kind])
        sub.config = sub_cfg
        sub._key = self._key
        sub.device = self.device
        sub.params = self.params[f"sub_{name}"]
        sub.last_mutation_attr = None
        sub.last_mutation = {}
        getattr(sub, method)(rng=rng)
        subs = list(cfg.sub_configs)
        subs[idx] = (name, kind, sub.config)
        self.params[f"sub_{name}"] = sub.params
        self.config = config_replace(cfg, sub_configs=tuple(subs))
        return {"sub": name, "method": method}
