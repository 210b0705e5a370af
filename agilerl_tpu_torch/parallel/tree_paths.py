"""Path strings over the port's parameter trees: the port of
``agilerl_tpu/parallel/tree_paths.py``.

The rule engine (``parallel/plan.py``) matches regex rules against the
``/``-joined path of every leaf, so one ordered rule list covers params,
optimizer moments (whose paths embed the param path, e.g.
``1/inner_state/0/mu/blocks/0/wq/A``), batches and KV caches. A tree is a
dict (its keys), a NamedTuple (its field names), a list or tuple (its
indices) or a leaf; the names are the ones the JAX key paths render to.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple, Union

PyTree = Any


def _children(tree: Any):
    """``[(name, child), ...]`` of a container, None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _rebuild(tree: Any, values: List[Any]) -> Any:
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), values))
    if hasattr(tree, "_fields"):
        return type(tree)(*values)
    return type(tree)(values)


def path_entry_to_string(key: Any) -> str:
    """One path entry (a dict key, a NamedTuple field name or a sequence
    index) as its bare string name."""
    return str(key)


def tree_path_to_string(path: Tuple[str, ...], sep: Optional[str] = "/"
                        ) -> Union[str, Tuple[str, ...]]:
    """A path's names joined by ``sep`` (the tuple itself when ``sep`` is None)."""
    return tuple(path) if sep is None else sep.join(path)


def named_tree_map(f: Callable[..., Any], tree: PyTree, *rest: PyTree,
                   is_leaf: Optional[Callable[[Any], bool]] = None,
                   sep: Optional[str] = "/") -> PyTree:
    """``tree_map`` where ``f`` receives ``(name, leaf, *rest)`` with ``name``
    the leaf's path rendered through ``sep``. ``None`` stays ``None``."""

    def walk(path, node, *others):
        kids = None if (is_leaf is not None and is_leaf(node)) else _children(node)
        if kids is None:
            if node is None:
                return None
            return f(tree_path_to_string(path, sep), node, *others)
        other_kids = [dict(_children(o)) for o in others]
        out = [walk(path + (name,), child, *(ok[name] for ok in other_kids))
               for name, child in kids]
        return _rebuild(node, out)

    return walk((), tree, *rest)


def tree_paths(tree: PyTree, sep: Optional[str] = "/") -> list:
    """All leaf paths of ``tree`` (rendered through ``sep``), in visiting order."""
    out: List[Any] = []
    named_tree_map(lambda name, leaf: out.append(name), tree, sep=sep)
    return out
