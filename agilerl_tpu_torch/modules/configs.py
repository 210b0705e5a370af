"""Net-config aliases and loaders: the port of ``agilerl_tpu/modules/configs.py``.

The per-module configs live beside their modules; this module names them
as the user-facing net configs (``MlpNetConfig``, ``CnnNetConfig``,
``LstmNetConfig``, ``MultiInputNetConfig``, ``SimBaNetConfig``) and loads
the ``net_config`` kwargs every algorithm takes. YAML goes through PyYAML,
imported only when a path is loaded (the card's machine has no PyYAML:
pass dicts there).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

from agilerl_tpu_torch.modules.cnn import CNNConfig as CnnNetConfig  # noqa: F401
from agilerl_tpu_torch.modules.lstm import LSTMConfig as LstmNetConfig  # noqa: F401
from agilerl_tpu_torch.modules.mlp import MLPConfig as MlpNetConfig  # noqa: F401
from agilerl_tpu_torch.modules.multi_input import (  # noqa: F401
    MultiInputConfig as MultiInputNetConfig,
)
from agilerl_tpu_torch.modules.simba import SimBaConfig as SimBaNetConfig  # noqa: F401

_KNOWN_KEYS = {"latent_dim", "encoder_config", "head_config", "simba", "recurrent",
               "min_latent_dim", "max_latent_dim"}


def load_net_config(source: Union[str, Path, Dict[str, Any], None]) -> Dict[str, Any]:
    """A net_config dict from a YAML path or a dict: known keys only (any
    case), lists in sub-dicts as the tuples the frozen configs need."""
    if source is None:
        return {}
    if isinstance(source, (str, Path)):
        import yaml

        with open(source) as f:
            source = yaml.safe_load(f) or {}
    out: Dict[str, Any] = {}
    for k, v in source.items():
        key = k.lower()
        if key not in _KNOWN_KEYS:
            continue
        if isinstance(v, dict):
            v = {sk: tuple(sv) if isinstance(sv, list) else sv for sk, sv in v.items()}
        out[key] = v
    return out


def _tuplify(x):
    """YAML sequences arrive as lists; the frozen configs need tuples."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, dict):
        return {k: _tuplify(v) for k, v in x.items()}
    return x


def load_yaml_config(path: Union[str, Path]) -> Dict[str, Any]:
    """A full training YAML (INIT_HP / MUTATION_PARAMS / NET_CONFIG)."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    for section in ("NET_CONFIG", "MODEL"):
        if section in cfg:
            cfg[section] = _tuplify(cfg[section])
    return cfg
