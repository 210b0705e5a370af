"""DummyEvolvable: the port of ``agilerl_tpu/modules/dummy.py``. It wraps an
arbitrary ``(init_fn, apply_fn, config)`` into the EvolvableModule
interface with no mutation methods, so a network that does not evolve (a
frozen pretrained encoder) slots into the algorithms unchanged."""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from agilerl_tpu_torch.modules.base import EvolvableModule
from agilerl_tpu_torch.utils.rng import derive_key


class DummyEvolvable(EvolvableModule):
    def __init__(self, init_fn: Callable[[torch.Generator], Any], apply_fn: Callable[..., Any],
                 config: Any = None, key: Optional[torch.Generator] = None, device=None):
        self._init_fn = init_fn
        self._apply_fn = apply_fn
        super().__init__(config, derive_key(key), device)

    def init_params(self, gen, config):  # type: ignore[override]
        return self._init_fn(gen)

    def apply(self, config, params, x, **kw):  # type: ignore[override]
        return self._apply_fn(params, x, **kw)

    def __call__(self, x, **kw):
        return self._apply_fn(self.params, x, **kw)

    @classmethod
    def get_mutation_methods(cls):
        return {}

    def sample_mutation_method(self, new_layer_prob=0.2, rng=None):
        raise ValueError("DummyEvolvable has no mutation methods")
