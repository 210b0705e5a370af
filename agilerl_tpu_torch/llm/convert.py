"""Weights from the JAX package's parameter trees, through numpy.

Both packages use the same keys and the ``[in, out]`` layout, so no
transposes are needed. MoE blocks carry their stacked ``[E, ...]`` expert
weights and their ``router`` like any other block weight. The JAX tree is
handed over as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``);
nothing here imports jax.

``tensor_to_host`` / ``tensor_from_host`` carry one tensor through a pickle
that a process without a card can read (the fleet's KV transfers): numpy has
no bfloat16, so a bf16 tensor travels as its ``uint16`` bit pattern with the
dtype's name and comes back bit for bit.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

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
    return f32_tree_from_numpy(tree, device)


def f32_tree_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Any nested dict of arrays as f32 tensors: the trainable trees of ILQL
    and BC_LM (``{"gpt": model tree, "v_head", "q_head", "q2_head"}``, each
    head ``{"kernel", "bias"}``) and ILQL's target-Q tree. They train the
    whole model, so every weight stays f32 and is cast to ``config.dtype`` at
    use, as the JAX package keeps them."""
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        return {k: f32_tree_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor(tree, torch.float32, dev)


def tensor_to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host numpy array, dtype name) for ``t``; a bf16 tensor becomes its
    ``uint16`` bit pattern."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16), "bfloat16"
    return t.cpu().numpy(), str(t.dtype).replace("torch.", "")


def tensor_from_host(a: np.ndarray, dtype: Optional[str] = None,
                     device: DeviceLike = None) -> torch.Tensor:
    """The inverse of ``tensor_to_host``: ``dtype`` None keeps the array's own
    dtype."""
    dev = resolve_device(device)
    a = np.asarray(a)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    t = torch.from_numpy(a.copy())
    return t.to(device=dev, dtype=getattr(torch, dtype) if dtype else t.dtype)
