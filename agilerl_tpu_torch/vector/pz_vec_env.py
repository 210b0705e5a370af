"""``sanitize_ma_transition``: the port of the function of that name in
``agilerl_tpu/vector/pz_vec_env.py`` (the PettingZoo vector env itself is
not ported yet).

Dead or inactive agents of a PettingZoo vector env arrive as NaN
placeholder observations and rewards; the standard multi-agent loops have
no notion of inactivity, so the placeholders become zeros before they can
reach a buffer or a fitness sum. A device tensor is cleaned with
``torch.where(torch.isnan(x), 0, x)`` and no host read; a host array keeps
the JAX package's ``np.nan_to_num(x, nan=0.0)`` where it holds a NaN. The
one difference: ``np.nan_to_num`` also clamps +-inf to the dtype's largest
finite values in an array that holds a NaN, where the tensor path leaves
+-inf as it is.
"""

from __future__ import annotations

import numpy as np
import torch


def _clean(v):
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(_clean(x) for x in v)
    if isinstance(v, torch.Tensor):
        if not v.is_floating_point():
            return v
        return torch.where(torch.isnan(v), torch.zeros((), dtype=v.dtype, device=v.device), v)
    arr = np.asarray(v)
    if np.issubdtype(arr.dtype, np.floating) and np.isnan(arr).any():
        return np.nan_to_num(arr, nan=0.0)
    return v


def sanitize_ma_transition(obs_dict, reward_dict):
    """(obs, rewards) with every NaN placeholder replaced by zero."""
    return ({a: _clean(v) for a, v in obs_dict.items()},
            {a: _clean(v) for a, v in reward_dict.items()})
