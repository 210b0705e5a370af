"""Type aliases and the shared enums of the evolvable modules: the port of
``agilerl_tpu/typing.py`` (``MutationType``, ``MutationMethod``)."""

from __future__ import annotations

import enum
from typing import Any, Callable, Dict, Tuple, Union

import numpy as np
import torch

ArrayLike = Union[torch.Tensor, np.ndarray, float, int]
Params = Any  # a tree of tensors (nested dicts)
PyTree = Any
KeyArray = torch.Generator  # the port's counterpart of a JAX PRNG key
ObservationType = Union[torch.Tensor, np.ndarray, Dict[str, Any], Tuple[Any, ...]]
ExperiencesType = Dict[str, Any]
GymSpaceType = Any  # a space of the port or of gymnasium (utils/spaces.space_kind)
ApplyFn = Callable[..., Any]


class MutationType(enum.Enum):
    """Classes of architecture mutation a module method can implement."""

    LAYER = "layer"
    NODE = "node"
    ACTIVATION = "activation"


class MutationMethod:
    """Metadata that the ``@mutation`` decorator attaches to a method."""

    __slots__ = ("fn", "mutation_type", "shrink_params")

    def __init__(self, fn, mutation_type: MutationType, shrink_params: bool = False):
        self.fn = fn
        self.mutation_type = mutation_type
        self.shrink_params = shrink_params
