"""EvolvableNetwork: the port of ``agilerl_tpu/networks/base.py``.

A network is (frozen ``NetworkConfig``, params ``{"encoder", "head"}``),
encoder -> latent -> head, with the JAX package's flat mutation namespace
("add_latent_node", "encoder.add_layer", "head.add_node", ...), so the HPO
engine samples a method on the policy and replays the same name on the
other networks. The encoder follows the observation space: a multi-input
encoder for Dict / Tuple spaces, a CNN (or, with ``resnet``, a ResNet) for
images, else an LSTM with ``recurrent``, a SimBa with ``simba`` or an MLP.

``params_from_numpy`` carries a JAX network's parameters (numpy trees) into
the port, checked path by path and shape by shape against the config's own
init.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.modules.base import (
    EvolvableModule,
    _flatten_with_paths,
    config_replace,
    copy_key,
    preserve_params,
    split_key,
)
from agilerl_tpu_torch.modules.cnn import CNNConfig, EvolvableCNN
from agilerl_tpu_torch.modules.lstm import EvolvableLSTM, LSTMConfig
from agilerl_tpu_torch.modules.mlp import EvolvableMLP, MLPConfig
from agilerl_tpu_torch.modules.multi_input import (
    EvolvableMultiInput,
    MultiInputConfig,
    _build_sub_configs,
)
from agilerl_tpu_torch.modules.resnet import EvolvableResNet, ResNetConfig
from agilerl_tpu_torch.modules.simba import EvolvableSimBa, SimBaConfig
from agilerl_tpu_torch.ops import resolve_device
from agilerl_tpu_torch.utils.rng import derive_key, derive_rng
from agilerl_tpu_torch.utils.spaces import image_shape_nhwc, is_image_space, obs_dim, space_kind
from agilerl_tpu_torch.utils.tree import tree_copy

ENCODER_TYPES = {
    "mlp": EvolvableMLP,
    "cnn": EvolvableCNN,
    "multi_input": EvolvableMultiInput,
    "lstm": EvolvableLSTM,
    "simba": EvolvableSimBa,
    "resnet": EvolvableResNet,
}


def default_encoder_config(
    observation_space: Any,
    latent_dim: int,
    simba: bool = False,
    recurrent: bool = False,
    resnet: bool = False,
    encoder_config: Optional[dict] = None,
) -> Tuple[str, Any]:
    """Encoder kind + config for the observation space."""
    encoder_config = dict(encoder_config or {})
    if space_kind(observation_space) in ("dict", "tuple"):
        return "multi_input", MultiInputConfig(
            sub_configs=_build_sub_configs(observation_space), num_outputs=latent_dim,
            **encoder_config)
    if resnet and is_image_space(observation_space):
        return "resnet", ResNetConfig(input_shape=image_shape_nhwc(observation_space),
                                      num_outputs=latent_dim, **encoder_config)
    if is_image_space(observation_space):
        # defaults scaled to the image: the Atari-style (8, 4) / (4, 2) stack
        # collapses anything under ~36 px to zero spatial dims
        h, w, _ = image_shape_nhwc(observation_space)
        if min(h, w) >= 36:
            defaults = ((32, 32), (8, 4), (4, 2))
        elif min(h, w) >= 8:
            defaults = ((32, 32), (3, 3), (2, 2))
        else:
            defaults = ((16,), (min(2, h, w),), (1,))
        for k, v in zip(("channel_size", "kernel_size", "stride_size"), defaults):
            encoder_config.setdefault(k, v)
        return "cnn", CNNConfig(input_shape=image_shape_nhwc(observation_space),
                                num_outputs=latent_dim, **encoder_config)
    dim = obs_dim(observation_space)
    if recurrent:
        return "lstm", LSTMConfig(num_inputs=dim, num_outputs=latent_dim, **encoder_config)
    if simba:
        return "simba", SimBaConfig(num_inputs=dim, num_outputs=latent_dim, **encoder_config)
    encoder_config.setdefault("hidden_size", (64,))
    encoder_config.setdefault("output_vanish", False)
    return "mlp", MLPConfig(num_inputs=dim, num_outputs=latent_dim, **encoder_config)


def filter_encoder_config(
    observation_space: Any,
    encoder_config: Optional[dict],
    latent_dim: int = 32,
    simba: bool = False,
    recurrent: bool = False,
    resnet: bool = False,
) -> dict:
    """Only the encoder_config keys the space's encoder family accepts."""
    encoder_config = dict(encoder_config or {})
    if not encoder_config:
        return encoder_config
    _, probe = default_encoder_config(observation_space, latent_dim, simba, recurrent, resnet)
    valid = {f.name for f in dataclasses.fields(type(probe))}
    return {k: v for k, v in encoder_config.items() if k in valid}


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    encoder_kind: str
    encoder: Any  # encoder config dataclass
    head: MLPConfig
    latent_dim: int = 32
    min_latent_dim: int = 8
    max_latent_dim: int = 128


def _encoder_cls(kind: str):
    return ENCODER_TYPES[kind]


class EvolvableNetwork:
    """Composite evolvable net = encoder -> latent -> head. Its parameters
    live on ``device`` (the card when None, raising without one)."""

    def __init__(
        self,
        observation_space: Any,
        num_outputs: int,
        key: Optional[torch.Generator] = None,
        latent_dim: int = 32,
        simba: bool = False,
        recurrent: bool = False,
        resnet: bool = False,
        encoder_config: Optional[dict] = None,
        head_config: Optional[dict] = None,
        config: Optional[NetworkConfig] = None,
        device=None,
    ):
        self._key = key if key is not None else derive_key()
        self.device = resolve_device(device)
        self.observation_space = observation_space
        if config is None:
            kind, enc_cfg = default_encoder_config(
                observation_space, latent_dim, simba, recurrent, resnet, encoder_config)
            head_kwargs = dict(head_config or {})
            head_kwargs.setdefault("hidden_size", (64,))
            head = MLPConfig(num_inputs=latent_dim, num_outputs=num_outputs, **head_kwargs)
            config = NetworkConfig(encoder_kind=kind, encoder=enc_cfg, head=head,
                                   latent_dim=latent_dim)
        self.config = config
        self.params = self.init_params(self._next_key(), config)
        self.last_mutation_attr: Optional[str] = None
        self.last_mutation: Dict[str, Any] = {}

    # ------------------------------------------------------------------ #
    def _next_key(self) -> torch.Generator:
        return split_key(self._key, self.device)

    @staticmethod
    def init_params(gen: torch.Generator, config: NetworkConfig) -> Dict:
        return {
            "encoder": _encoder_cls(config.encoder_kind).init_params(gen, config.encoder),
            "head": EvolvableMLP.init_params(gen, config.head),
        }

    @staticmethod
    def encode(config: NetworkConfig, params: Dict, obs: Any, **kw) -> torch.Tensor:
        return _encoder_cls(config.encoder_kind).apply(config.encoder, params["encoder"], obs, **kw)

    @staticmethod
    def apply(config: NetworkConfig, params: Dict, obs: Any, **kw) -> torch.Tensor:
        latent = EvolvableNetwork.encode(config, params, obs, **kw)
        return EvolvableMLP.apply(config.head, params["head"], latent)

    def __call__(self, obs: Any, **kw):
        return type(self).apply(self.config, self.params, obs, **kw)

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {"observation_space": self.observation_space, "config": self.config,
                "device": self.device}

    # -- mutation namespace --------------------------------------------- #
    def mutation_methods(self) -> List[str]:
        enc_cls = _encoder_cls(self.config.encoder_kind)
        names = ["add_latent_node", "remove_latent_node"]
        names += [f"encoder.{n}" for n in enc_cls.get_mutation_methods()]
        names += [f"head.{n}" for n in EvolvableMLP.get_mutation_methods()]
        return names

    def _scope_cls(self, scope: str):
        return _encoder_cls(self.config.encoder_kind) if scope == "encoder" else EvolvableMLP

    def mutation_method_kind(self, name: str) -> Optional[str]:
        """"layer" | "node" of a namespaced mutation method."""
        if name in ("add_latent_node", "remove_latent_node"):
            return "node"
        if "." not in name:
            return None
        scope, bottom = name.split(".", 1)
        cls = self._scope_cls(scope)
        if bottom in cls.layer_mutation_methods():
            return "layer"
        if bottom in cls.node_mutation_methods():
            return "node"
        return None

    def resolve_mutation_method(self, name: str, kind: Optional[str] = None) -> Optional[str]:
        """The method itself if this net has it, else an analogous one (same
        scope, kind and direction), else None."""
        if name in self.mutation_methods():
            return name
        if "." not in name:
            return None
        scope, bottom = name.split(".", 1)
        cls = self._scope_cls(scope)
        if kind == "layer":
            pool = cls.layer_mutation_methods()
        elif kind == "node":
            pool = cls.node_mutation_methods()
        else:
            pool = list(cls.get_mutation_methods())
        direction = bottom.split("_", 1)[0]
        same_dir = [m for m in pool if m.split("_", 1)[0] == direction]
        return f"{scope}.{same_dir[0]}" if same_dir else None

    def sample_mutation_method(self, new_layer_prob: float = 0.2,
                               rng: Optional[np.random.Generator] = None) -> str:
        rng = derive_rng(rng)
        enc_cls = _encoder_cls(self.config.encoder_kind)
        layer_methods = [f"encoder.{n}" for n in enc_cls.layer_mutation_methods()]
        layer_methods += [f"head.{n}" for n in EvolvableMLP.layer_mutation_methods()]
        node_methods = ["add_latent_node", "remove_latent_node"]
        node_methods += [f"encoder.{n}" for n in enc_cls.node_mutation_methods()]
        node_methods += [f"head.{n}" for n in EvolvableMLP.node_mutation_methods()]
        if layer_methods and rng.random() < new_layer_prob:
            return str(rng.choice(layer_methods))
        return str(rng.choice(node_methods))

    def apply_mutation(self, name: str, rng: Optional[np.random.Generator] = None) -> Dict:
        """Apply a mutation by namespaced name; returns its metadata."""
        rng = derive_rng(rng)
        self.last_mutation_attr = name
        if name == "add_latent_node":
            return self._change_latent(+int(rng.choice([8, 16, 32])))
        if name == "remove_latent_node":
            return self._change_latent(-int(rng.choice([8, 16, 32])))
        scope, method = name.split(".", 1)
        if scope == "encoder":
            sub = self._materialise(_encoder_cls(self.config.encoder_kind),
                                    self.config.encoder, self.params["encoder"])
            info = sub.apply_mutation(method, rng=rng)
            self.config = config_replace(self.config, encoder=sub.config)
            self.params["encoder"] = sub.params
        else:
            sub = self._materialise(EvolvableMLP, self.config.head, self.params["head"])
            info = sub.apply_mutation(method, rng=rng)
            self.config = config_replace(self.config, head=sub.config)
            self.params["head"] = sub.params
        self.last_mutation = info
        return info

    def _materialise(self, cls, cfg, params) -> EvolvableModule:
        sub = object.__new__(cls)
        sub.config = cfg
        sub._key = split_key(self._key)
        sub.device = self.device
        sub.params = params
        sub.last_mutation_attr = None
        sub.last_mutation = {}
        return sub

    # subclasses whose head consumes latent + extra features set this offset
    _head_extra_inputs: int = 0

    def _change_latent(self, delta: int) -> Dict:
        cfg = self.config
        new_latent = int(np.clip(cfg.latent_dim + delta, cfg.min_latent_dim, cfg.max_latent_dim))
        if new_latent == cfg.latent_dim:
            return {"numb_new_nodes": 0}
        enc_cfg = config_replace(cfg.encoder, num_outputs=new_latent)
        head_cfg = config_replace(cfg.head, num_inputs=new_latent + self._head_extra_inputs)
        new_cfg = config_replace(cfg, encoder=enc_cfg, head=head_cfg, latent_dim=new_latent)
        preserved = preserve_params(self.params, self.init_params(self._next_key(), new_cfg))
        # extra top-level groups (StochasticActor's "dist") are kept as they are
        for k, v in self.params.items():
            if k not in preserved:
                preserved[k] = v
        self.params = preserved
        self.config = new_cfg
        self.last_mutation = {"numb_new_nodes": abs(delta)}
        return self.last_mutation

    def change_activation(self, activation: str, output: bool = False) -> None:
        """Swap the activation in the encoder and head configs (no shapes change)."""

        def maybe(cfg):
            changes = {}
            if hasattr(cfg, "activation"):
                changes["activation"] = activation
            if hasattr(cfg, "sub_configs"):
                changes["sub_configs"] = tuple((n, k, maybe(sc)) for n, k, sc in cfg.sub_configs)
            return config_replace(cfg, **changes) if changes else cfg

        self.config = config_replace(self.config, encoder=maybe(self.config.encoder),
                                     head=maybe(self.config.head))

    # -- cloning / state ------------------------------------------------ #
    def clone(self) -> "EvolvableNetwork":
        new = object.__new__(type(self))
        new.__dict__.update({k: v for k, v in self.__dict__.items() if k != "params"})
        new._key = copy_key(self._key)
        new.params = tree_copy(self.params)
        return new

    def state_dict(self) -> Dict:
        return self.params

    def extra_template(self) -> Dict:
        """The parameter groups outside ``init_params`` (for ``params_from_numpy``)."""
        return {}

    def load_state_dict(self, params: Dict) -> None:
        self.params = params


def params_from_numpy(tree: Mapping, config: NetworkConfig, device=None,
                      extra: Optional[Mapping[str, Any]] = None, init=None) -> Dict:
    """A JAX network's parameters (a numpy tree:
    ``jax.tree_util.tree_map(np.asarray, net.params)``) as f32 tensors on
    ``device``, after checking that their paths and shapes are those of
    ``config``'s own init (``init``, a network class's ``init_params``:
    ``EvolvableNetwork.init_params`` when None; ``RainbowQNetwork``'s adds
    the value stream) plus ``extra`` (``{"dist": ...}`` of a
    StochasticActor). Noisy layers carry ``kernel_mu`` / ``kernel_sigma`` /
    ``bias_mu`` / ``bias_sigma`` by the same rule. Raises ``ValueError`` on
    any difference."""
    from agilerl_tpu_torch.llm.convert import f32_tree_from_numpy

    init = init or EvolvableNetwork.init_params
    template = init(torch.Generator().manual_seed(0), config)
    template.update(dict(extra or {}))
    want = {p: tuple(v.shape) for p, v in _flatten_with_paths(template).items()}
    got = {p: tuple(np.shape(v)) for p, v in _numpy_paths(tree).items()}
    if want != got:
        missing = sorted(map(str, set(want) - set(got)))
        unknown = sorted(map(str, set(got) - set(want)))
        shapes = sorted(str(p) for p in set(want) & set(got) if want[p] != got[p])
        raise ValueError(f"parameter tree does not fit {config}: missing {missing}, "
                         f"unknown {unknown}, shape mismatches {shapes}")
    return f32_tree_from_numpy(tree, device)


def _numpy_paths(tree: Any, prefix: Tuple = ()) -> Dict[Tuple, Any]:
    if isinstance(tree, Mapping):
        out: Dict[Tuple, Any] = {}
        for k, v in tree.items():
            out.update(_numpy_paths(v, prefix + (k,)))
        return out
    return {prefix: tree}
