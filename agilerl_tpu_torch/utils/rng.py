"""RNG derivation: the port of ``agilerl_tpu/utils/rng.py``.

The one place the global numpy stream is drawn. Components that need
randomness take a threaded ``np.random.Generator`` (or a ``torch.Generator``
where the JAX package takes a key); a caller that passes neither gets a
fallback seed drawn here from the global numpy stream, so
``np.random.seed(s)`` at run start makes every unseeded fallback
reproducible. The numpy streams are the JAX package's own, draw for draw, so
selection and mutation replay exactly; a JAX key becomes a ``torch.Generator``
(the two give different numbers from one seed).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = ["global_seed", "derive_rng", "derive_key", "generator_to_host",
           "generator_from_host"]


def global_seed(bound: int = 2 ** 31 - 1) -> int:
    """Draw a fallback seed from the global numpy stream."""
    return int(np.random.randint(0, bound))


def derive_rng(rng: Optional[np.random.Generator] = None,
               seed: Optional[int] = None) -> np.random.Generator:
    """Return ``rng`` unchanged when given; otherwise a Generator seeded from
    ``seed`` (when given) or the global stream."""
    if rng is not None:
        return rng
    return np.random.default_rng(seed if seed is not None else global_seed())


def derive_key(key: Optional[torch.Generator] = None,
               seed: Optional[int] = None) -> torch.Generator:
    """Return ``key`` unchanged when given; otherwise a CPU ``torch.Generator``
    seeded from ``seed`` or the global stream (one draw, as the JAX version
    draws one for its key)."""
    if key is not None:
        return key
    return torch.Generator().manual_seed(seed if seed is not None else global_seed())


def generator_to_host(gen: torch.Generator) -> Dict[str, Any]:
    """A picklable capture of a ``torch.Generator``: its device type and its
    state as a numpy byte array (the counterpart of the JAX package's
    ``key_to_host``)."""
    return {"device": gen.device.type, "state": gen.get_state().numpy().copy()}


def generator_from_host(gen: torch.Generator, blob: Dict[str, Any]) -> torch.Generator:
    """Set ``gen`` to a ``generator_to_host`` capture, in place. A state
    restores only into a generator of the device type it was taken from (a
    CUDA generator's state is a seed and an offset, a CPU one's a Mersenne
    Twister): any other pairing raises rather than re-seed quietly."""
    if blob["device"] != gen.device.type:
        raise ValueError(f"a {blob['device']} generator's state cannot restore into a "
                         f"{gen.device.type} generator")
    gen.set_state(torch.from_numpy(np.asarray(blob["state"], np.uint8).copy()))
    return gen
