"""Algorithm utilities: the port of ``agilerl_tpu/utils/algo_utils.py``
(observation preprocessing lives in ``utils/spaces.py``, module and
checkpoint helpers in ``algorithms/core/base.py``; the dataclass below
mirrors the reference's config objects).

``VLLMConfig`` has no counterpart by design: generation is the port's own
decode loop (``llm/generate.py``, ``llm/serving.py``), configured by
``GenerationConfig``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from agilerl_tpu_torch.algorithms.core.optimizer import CosineLRScheduleConfig  # noqa: F401
from agilerl_tpu_torch.ops import DeviceLike, resolve_device
from agilerl_tpu_torch.utils.spaces import (  # noqa: F401
    action_dim,
    obs_dim,
    preprocess_observation,
)


@dataclasses.dataclass
class GenerationConfig:
    """Decode-loop settings for LLM algorithms (replaces ``VLLMConfig``)."""

    max_new_tokens: int = 64
    temperature: float = 0.9
    top_k: Optional[int] = None
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0


def chkpt_attribute_to_device(chkpt: Any, device: DeviceLike = None) -> Any:
    """Every array of a checkpoint tree (numpy arrays and scalars, tensors)
    as a tensor on ``device``, dtypes kept; other leaves are kept. Dicts,
    lists and tuples are walked. ``device=None`` means the card, and raises
    without one."""
    dev = resolve_device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(move(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, (np.ndarray, np.generic)):
            return torch.from_numpy(np.array(x)).to(dev)
        return x

    return move(chkpt)


def key_in_nested_dict(d: dict, key: str) -> bool:
    """Whether ``key`` is a key of ``d`` or of any dict nested in it."""
    if key in d:
        return True
    return any(isinstance(v, dict) and key_in_nested_dict(v, key) for v in d.values())
