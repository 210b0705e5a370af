"""Nested-dict parameter trees: the few ``jax.tree_util`` operations the port
needs. A tree is a tensor (a leaf), or a dict, list or tuple of trees."""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over matching leaves of one or more trees of the same shape;
    ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") else type(tree)(*out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the order ``tree_map`` visits them."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_copy(tree: Any) -> Any:
    """A copy of every tensor leaf (``jnp.copy``); other leaves are kept."""
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def tree_to_numpy(tree: Any) -> Any:
    """Every tensor leaf as a host numpy array (``jax.device_get``); other
    leaves are kept (a DTensor as its whole value). A pickle of the result
    loads without a card."""
    return tree_map(lambda x: _whole(x).detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else x, tree)


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (through ``parallel/comm.gather_dtensor``,
    not DTensor's own all-gather); a plain tensor as it is."""
    if not hasattr(x, "full_tensor"):
        return x
    from agilerl_tpu_torch.parallel.comm import gather_dtensor

    return gather_dtensor(x).to_local()


def tree_from_numpy(tree: Any, device) -> Any:
    """The inverse of ``tree_to_numpy``: every numpy leaf as a tensor of the
    same dtype on ``device``; other leaves are kept."""
    return tree_map(
        lambda x: torch.from_numpy(x.copy()).to(device) if isinstance(x, np.ndarray) else x,
        tree)
