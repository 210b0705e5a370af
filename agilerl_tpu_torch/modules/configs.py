"""Net-config aliases and loaders: the port of ``agilerl_tpu/modules/configs.py``.

``MlpNetConfig`` names ``MLPConfig``; the CNN, LSTM, multi-input and SimBa
aliases come with their modules. ``load_yaml_config`` reads YAML through
PyYAML, imported only when it is called (the card's machine has no PyYAML:
pass dicts there).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

from agilerl_tpu_torch.modules.mlp import MLPConfig as MlpNetConfig  # noqa: F401


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
