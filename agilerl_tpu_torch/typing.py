"""Shared enums of the evolvable modules: the port of ``MutationType`` and
``MutationMethod`` in ``agilerl_tpu/typing.py``."""

from __future__ import annotations

import enum


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
