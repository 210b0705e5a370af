"""Weights from the JAX package's parameter trees, through numpy.

Both packages use the same keys and the ``[in, out]`` layout, so no
transposes are needed. The JAX tree is handed over as numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``); nothing here imports jax.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from agilerl_tpu_torch.llm.model import GPTConfig, Params, head_dtype_of
from agilerl_tpu_torch.ops import DeviceLike, resolve_device


def _tensor(x: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device=device, dtype=dtype)


def params_from_numpy(tree: Mapping, config: GPTConfig,
                      device: DeviceLike = None) -> Params:
    """Model parameters stored as ``llm/model.init_params`` stores them:
    block weights and norms in ``config.dtype``, the head in f32."""
    dev = resolve_device(device)
    out: Params = {}
    for name, x in tree.items():
        if name == "blocks":
            out["blocks"] = {i: {k: _tensor(w, config.dtype, dev) for k, w in blk.items()}
                             for i, blk in x.items()}
        else:
            out[name] = _tensor(x, head_dtype_of(config, name), dev)
    return out


def lora_from_numpy(tree: Mapping, device: DeviceLike = None) -> Params:
    """LoRA adapter tree ({"blocks": {i: {target: {"A", "B"}}}}) in f32."""
    dev = resolve_device(device)
    return {"blocks": {i: {t: {k: _tensor(w, torch.float32, dev) for k, w in ab.items()}
                           for t, ab in layer.items()}
                       for i, layer in tree["blocks"].items()}}
