"""Evolvable-module core: the port of ``agilerl_tpu/modules/base.py``.

A module is a frozen config plus a dict-of-tensors parameter tree, as in
the JAX package. A mutation builds a new config, initialises fresh
parameters for it and copies every overlapping slab of the old weights in
(``preserve_params``). The JAX key becomes a CPU ``torch.Generator``:
``_next_key`` draws a seed from it and returns a generator on the module's
device, so the same seed gives other numbers than JAX does, and grown
slabs compare by distribution only; preserved slabs are bit-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from agilerl_tpu_torch.ops import resolve_device
from agilerl_tpu_torch.typing import MutationMethod, MutationType
from agilerl_tpu_torch.utils.rng import derive_rng
from agilerl_tpu_torch.utils.tree import tree_copy

Params = Any

_SEED_BOUND = 2 ** 62


def split_key(key: torch.Generator, device=None) -> torch.Generator:
    """A fresh generator on ``device`` seeded from ``key``'s stream (the
    counterpart of ``jax.random.split``)."""
    seed = int(torch.randint(0, _SEED_BOUND, (1,), generator=key))
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(seed)


def copy_key(key: torch.Generator) -> torch.Generator:
    """An independent generator in ``key``'s state."""
    out = torch.Generator(device=key.device)
    out.set_state(key.get_state())
    return out


# --------------------------------------------------------------------------- #
# Mutation decorator + discovery
# --------------------------------------------------------------------------- #


def mutation(mutation_type: MutationType, shrink_params: bool = False):
    """Mark a method as an architecture mutation. The wrapped method returns
    a dict of mutation metadata (possibly empty); the wrapper records
    ``last_mutation_attr`` / ``last_mutation`` on the module."""

    def decorator(fn: Callable) -> Callable:
        def wrapper(self, *args, **kwargs):
            result = fn(self, *args, **kwargs)
            self.last_mutation_attr = fn.__name__
            self.last_mutation = result if isinstance(result, dict) else {}
            return self.last_mutation

        wrapper.__name__ = fn.__name__
        wrapper.__doc__ = fn.__doc__
        wrapper._mutation = MutationMethod(fn, mutation_type, shrink_params)
        return wrapper

    return decorator


class EvolvableModule:
    """Base class for all evolvable neural modules.

    Subclasses define a frozen dataclass ``Config``,
    ``init_params(gen, config) -> params`` and
    ``apply(config, params, x, **kw)`` (static), and mutation methods
    decorated with ``@mutation(...)`` that call ``self._morph(new_config)``.
    Parameters live on ``device`` (the card when None, raising without one).
    """

    def __init__(self, config, key: torch.Generator, device=None):
        self.config = config
        self._key = key
        self.device = resolve_device(device)
        self.params = self.init_params(self._next_key(), config)
        self.last_mutation_attr: Optional[str] = None
        self.last_mutation: Dict[str, Any] = {}

    def _next_key(self) -> torch.Generator:
        return split_key(self._key, self.device)

    @staticmethod
    def init_params(gen: torch.Generator, config) -> Params:  # pragma: no cover
        raise NotImplementedError

    @staticmethod
    def apply(config, params: Params, x, **kwargs):  # pragma: no cover
        raise NotImplementedError

    def __call__(self, x, **kwargs):
        return type(self).apply(self.config, self.params, x, **kwargs)

    def forward(self, x, **kwargs):
        return self(x, **kwargs)

    @property
    def init_dict(self) -> Dict[str, Any]:
        return {"config": self.config}

    # -- mutation machinery ------------------------------------------------- #
    @classmethod
    def get_mutation_methods(cls) -> Dict[str, MutationMethod]:
        out: Dict[str, MutationMethod] = {}
        for name in dir(cls):
            meta = getattr(getattr(cls, name, None), "_mutation", None)
            if meta is not None:
                out[name] = meta
        return out

    @classmethod
    def layer_mutation_methods(cls) -> List[str]:
        return [n for n, m in cls.get_mutation_methods().items()
                if m.mutation_type == MutationType.LAYER]

    @classmethod
    def node_mutation_methods(cls) -> List[str]:
        return [n for n, m in cls.get_mutation_methods().items()
                if m.mutation_type == MutationType.NODE]

    def sample_mutation_method(self, new_layer_prob: float = 0.2,
                               rng: Optional[np.random.Generator] = None) -> str:
        """A mutation method name: a layer method with probability
        ``new_layer_prob``, else a node method (the JAX package's draws)."""
        rng = derive_rng(rng)
        layers = self.layer_mutation_methods()
        nodes = self.node_mutation_methods()
        if layers and (not nodes or rng.random() < new_layer_prob):
            return str(rng.choice(layers))
        if nodes:
            return str(rng.choice(nodes))
        raise ValueError(f"{type(self).__name__} has no mutation methods")

    def apply_mutation(self, name: str, rng: Optional[np.random.Generator] = None) -> Dict:
        method = getattr(self, name)
        try:
            return method(rng=rng)
        except TypeError:
            return method()

    def _morph(self, new_config) -> None:
        """Fresh parameters for ``new_config`` with the old weights kept."""
        new_params = self.init_params(self._next_key(), new_config)
        self.params = preserve_params(self.params, new_params)
        self.config = new_config

    # -- cloning / state ---------------------------------------------------- #
    def clone(self) -> "EvolvableModule":
        new = object.__new__(type(self))
        new.__dict__.update({k: v for k, v in self.__dict__.items() if k != "params"})
        new._key = copy_key(self._key)
        new.params = tree_copy(self.params)
        return new

    def state_dict(self) -> Params:
        return self.params

    def load_state_dict(self, params: Params) -> None:
        self.params = params

    def param_count(self) -> int:
        return sum(int(p.numel()) for p in _flatten_with_paths(self.params).values())


# --------------------------------------------------------------------------- #
# Weight-preserving tree surgery
# --------------------------------------------------------------------------- #


@torch.no_grad()
def preserve_params(old: Params, new: Params) -> Params:
    """Copy every overlapping slab of ``old`` into ``new`` where tree paths
    match: the leading ``min(old.shape, new.shape)`` block of each shared
    leaf of the same rank; a grown region keeps its fresh initialisation, a
    leaf of equal shape is taken over whole."""
    old_flat = _flatten_with_paths(old)
    new_flat = _flatten_with_paths(new)
    out = dict(new_flat)
    for path, old_leaf in old_flat.items():
        new_leaf = new_flat.get(path)
        if new_leaf is None or old_leaf.dim() != new_leaf.dim():
            continue
        if old_leaf.shape == new_leaf.shape:
            out[path] = old_leaf
            continue
        slices = tuple(slice(0, min(o, n)) for o, n in zip(old_leaf.shape, new_leaf.shape))
        leaf = new_leaf.clone()
        leaf[slices] = old_leaf[slices].to(leaf.dtype)
        out[path] = leaf
    return _unflatten_from_paths(out, new)


def _flatten_with_paths(tree: Params, prefix: Tuple = ()) -> Dict[Tuple, torch.Tensor]:
    flat: Dict[Tuple, torch.Tensor] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten_with_paths(v, prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten_with_paths(v, prefix + (i,)))
    elif tree is not None:
        flat[prefix] = tree
    return flat


def _unflatten_from_paths(flat: Dict[Tuple, torch.Tensor], template: Params,
                          prefix: Tuple = ()) -> Params:
    if isinstance(template, dict):
        return {k: _unflatten_from_paths(flat, v, prefix + (k,)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_from_paths(flat, v, prefix + (i,))
                              for i, v in enumerate(template))
    if template is None:
        return None
    return flat.get(prefix, template)


# --------------------------------------------------------------------------- #
# ModuleDict (per-agent nets of the multi-agent algorithms)
# --------------------------------------------------------------------------- #


class ModuleDict:
    """An ordered dict of EvolvableModules keyed by agent id."""

    def __init__(self, modules: Dict[str, EvolvableModule]):
        self._modules = dict(modules)

    def __getitem__(self, k: str) -> EvolvableModule:
        return self._modules[k]

    def __setitem__(self, k: str, v: EvolvableModule) -> None:
        self._modules[k] = v

    def __iter__(self):
        return iter(self._modules)

    def __len__(self):
        return len(self._modules)

    def keys(self):
        return self._modules.keys()

    def values(self):
        return self._modules.values()

    def items(self):
        return self._modules.items()

    @property
    def params(self) -> Dict[str, Params]:
        return {k: m.params for k, m in self._modules.items()}

    def load_params(self, params: Dict[str, Params]) -> None:
        for k, p in params.items():
            self._modules[k].params = p

    def clone(self) -> "ModuleDict":
        return ModuleDict({k: m.clone() for k, m in self._modules.items()})


def config_replace(config, **changes):
    """dataclasses.replace for frozen config dataclasses."""
    return dataclasses.replace(config, **changes)


def tuple_insert(t: Tuple, idx: int, value) -> Tuple:
    lst = list(t)
    lst.insert(idx, value)
    return tuple(lst)


def tuple_remove(t: Tuple, idx: int) -> Tuple:
    lst = list(t)
    lst.pop(idx)
    return tuple(lst)


def tuple_set(t: Tuple, idx: int, value) -> Tuple:
    lst = list(t)
    lst[idx] = value
    return tuple(lst)
