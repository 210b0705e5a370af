"""Observation and action spaces: the port of ``agilerl_tpu/utils/spaces.py``.

The port carries minimal space classes of its own (``Box``, ``Discrete``,
``MultiDiscrete``, ``MultiBinary``, ``Dict``, ``Tuple``) so that nothing on
its path needs gymnasium. Every helper here duck-types a space by the name
of its class (``space_kind``), so gymnasium's spaces of the same names work
too. ``preprocess_observation`` turns raw observations (numpy arrays or
tensors) into network-ready tensors: Discrete one-hot, MultiDiscrete
concatenated one-hots, channels-first images moved to NHWC, Dict and Tuple
recursed.
"""

from __future__ import annotations

from typing import Any, Dict as TDict, Optional, Sequence, Tuple as TTuple

import numpy as np
import torch
import torch.nn.functional as F

_KINDS = {"Box": "box", "Discrete": "discrete", "MultiDiscrete": "multidiscrete",
          "MultiBinary": "multibinary", "Dict": "dict", "Tuple": "tuple"}


def space_kind(space: Any) -> Optional[str]:
    """"box" | "discrete" | "multidiscrete" | "multibinary" | "dict" | "tuple"
    for a space of the port or of gymnasium (by class name, subclasses
    included); None for anything else."""
    for cls in type(space).__mro__:
        kind = _KINDS.get(cls.__name__)
        if kind is not None:
            return kind
    return None


def _draw(generator: Optional[torch.Generator], shape, fn) -> np.ndarray:
    return fn(tuple(shape), generator=generator, dtype=torch.float64).numpy()


class Box:
    """A (possibly unbounded) box in R^shape."""

    def __init__(self, low, high, shape: Optional[Sequence[int]] = None, dtype=np.float32):
        self.dtype = np.dtype(dtype)
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        self.shape = tuple(int(s) for s in shape)
        self.low = np.broadcast_to(np.asarray(low, self.dtype), self.shape).copy()
        self.high = np.broadcast_to(np.asarray(high, self.dtype), self.shape).copy()

    def sample(self, generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Uniform where bounded on both sides, normal where unbounded,
        shifted exponential where bounded on one side (gymnasium's rule)."""
        low, high = self.low.astype(np.float64), self.high.astype(np.float64)
        lo_b, hi_b = np.isfinite(low), np.isfinite(high)
        u = _draw(generator, self.shape, torch.rand)
        n = _draw(generator, self.shape, torch.randn)
        e = -np.log1p(-_draw(generator, self.shape, torch.rand))
        out = np.where(lo_b & hi_b, low + u * (np.where(hi_b, high, 0) - np.where(lo_b, low, 0)),
                       np.where(lo_b, np.where(lo_b, low, 0) + e,
                                np.where(hi_b, np.where(hi_b, high, 0) - e, n)))
        if np.issubdtype(self.dtype, np.integer):
            out = np.floor(out)
        return out.astype(self.dtype)

    def __repr__(self) -> str:
        return f"Box({self.low.min()}, {self.high.max()}, {self.shape}, {self.dtype})"


class Discrete:
    def __init__(self, n: int, start: int = 0):
        self.n = int(n)
        self.start = int(start)
        self.shape: TTuple[int, ...] = ()
        self.dtype = np.dtype(np.int64)

    def sample(self, generator: Optional[torch.Generator] = None) -> np.int64:
        return np.int64(self.start + int(torch.randint(0, self.n, (1,), generator=generator)))

    def __repr__(self) -> str:
        return f"Discrete({self.n})"


class MultiDiscrete:
    def __init__(self, nvec: Sequence[int]):
        self.nvec = np.asarray(nvec, np.int64)
        self.shape = tuple(self.nvec.shape)
        self.dtype = np.dtype(np.int64)

    def sample(self, generator: Optional[torch.Generator] = None) -> np.ndarray:
        u = _draw(generator, self.shape, torch.rand)
        return np.floor(u * self.nvec).astype(np.int64)

    def __repr__(self) -> str:
        return f"MultiDiscrete({self.nvec.tolist()})"


class MultiBinary:
    def __init__(self, n):
        self.n = n
        self.shape = (int(n),) if np.isscalar(n) else tuple(int(s) for s in n)
        self.dtype = np.dtype(np.int8)

    def sample(self, generator: Optional[torch.Generator] = None) -> np.ndarray:
        return (_draw(generator, self.shape, torch.rand) < 0.5).astype(np.int8)

    def __repr__(self) -> str:
        return f"MultiBinary({self.n})"


class Dict:
    """Subspaces by key, sorted by key as gymnasium sorts them."""

    def __init__(self, spaces: TDict[str, Any]):
        self.spaces = dict(sorted(dict(spaces).items()))
        self.shape = None
        self.dtype = None

    def sample(self, generator: Optional[torch.Generator] = None) -> TDict[str, Any]:
        return {k: s.sample(generator) for k, s in self.spaces.items()}

    def __getitem__(self, key: str):
        return self.spaces[key]

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {s}" for k, s in self.spaces.items()) + ")"


class Tuple:
    def __init__(self, spaces: Sequence[Any]):
        self.spaces = tuple(spaces)
        self.shape = None
        self.dtype = None

    def sample(self, generator: Optional[torch.Generator] = None) -> tuple:
        return tuple(s.sample(generator) for s in self.spaces)

    def __repr__(self) -> str:
        return "Tuple(" + ", ".join(str(s) for s in self.spaces) + ")"


def sample_obs(space: Any, batch: int = 1) -> Any:
    """A batched numpy observation sample (for smoke tests and tracing): a
    dict or tuple space gives a dict or tuple of batches."""
    kind = space_kind(space)
    if kind == "dict":
        return {k: sample_obs(s, batch) for k, s in space.spaces.items()}
    if kind == "tuple":
        return tuple(sample_obs(s, batch) for s in space.spaces)
    return np.stack([space.sample() for _ in range(batch)])


# --------------------------------------------------------------------------- #
# Introspection
# --------------------------------------------------------------------------- #


def is_image_space(space: Any) -> bool:
    return space_kind(space) == "box" and len(space.shape) == 3


def is_vector_space(space: Any) -> bool:
    kind = space_kind(space)
    return kind in ("discrete", "multidiscrete", "multibinary") or (
        kind == "box" and len(space.shape) <= 1)


def obs_dim(space: Any) -> int:
    """Flat feature dimension of a non-image space."""
    kind = space_kind(space)
    if kind == "discrete":
        return int(space.n)
    if kind == "multidiscrete":
        return int(np.sum(space.nvec))
    if kind == "multibinary":
        return int(np.prod(space.shape))
    if kind == "box":
        return int(np.prod(space.shape)) if space.shape else 1
    raise TypeError(f"Unsupported observation space {type(space)}")


def image_shape_nhwc(space: Any) -> TTuple[int, int, int]:
    """(H, W, C) of an image box given CHW (a leading dim <= 4 before two
    equal dims) or HWC."""
    s = space.shape
    assert len(s) == 3
    if s[0] <= 4 and s[1] == s[2]:
        return (s[1], s[2], s[0])
    return (s[0], s[1], s[2])


def action_dim(space: Any) -> int:
    kind = space_kind(space)
    if kind == "discrete":
        return int(space.n)
    if kind == "multidiscrete":
        return int(np.sum(space.nvec))
    if kind in ("multibinary", "box"):
        return int(np.prod(space.shape))
    raise TypeError(f"Unsupported action space {type(space)}")


def as_tensor(x: Any, device=None) -> torch.Tensor:
    """A tensor of ``x``: tensors keep their device unless ``device`` is
    given; numpy and Python values go to ``device`` (the CPU when None)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


def preprocess_observation(space: Any, obs: Any, device=None) -> Any:
    """Network-ready tensors from raw observations, vectorised over any
    number of leading batch dimensions."""
    kind = space_kind(space)
    if kind == "dict":
        return {k: preprocess_observation(space.spaces[k], obs[k], device) for k in space.spaces}
    if kind == "tuple":
        return tuple(preprocess_observation(s, o, device) for s, o in zip(space.spaces, obs))
    x = as_tensor(obs, device)
    if kind == "discrete":
        return F.one_hot(x.long(), int(space.n)).float()
    if kind == "multidiscrete":
        parts = [F.one_hot(x[..., i].long(), int(n)) for i, n in enumerate(space.nvec)]
        return torch.cat(parts, dim=-1).float()
    if kind == "multibinary":
        return x.float().reshape(*x.shape[: x.dim() - len(space.shape)], -1)
    if kind == "box":
        if len(space.shape) == 3:
            s = space.shape
            if s[0] <= 4 and s[1] == s[2] and tuple(x.shape[-3:]) == tuple(s):
                x = torch.movedim(x, -3, -1)  # channels-first -> NHWC
            return x
        flat_from = x.dim() - len(space.shape) if space.shape else x.dim()
        if len(space.shape) > 1:
            x = x.reshape(*x.shape[:flat_from], -1)
        elif space.shape == ():
            x = x[..., None]
        return x.float()
    raise TypeError(f"Unsupported observation space {type(space)}")


def is_single_observation(pre: Any, space: Any) -> bool:
    """Is the preprocessed observation ``pre`` one unbatched observation of
    ``space``? By the rank of its first leaf, as the JAX package decides."""
    kind = space_kind(space)
    if kind == "dict":
        leaf, sub = next(iter(pre.values())), next(iter(space.spaces.values()))
    elif kind == "tuple":
        leaf, sub = pre[0], space.spaces[0]
    else:
        leaf, sub = pre, space
    if space_kind(sub) == "box":
        base = len(sub.shape) if len(sub.shape) != 3 else 3
        return leaf.dim() == (1 if len(sub.shape) == 0 else base)
    return leaf.dim() == 1

