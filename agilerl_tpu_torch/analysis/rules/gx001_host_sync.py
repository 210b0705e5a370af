"""GX001 — host↔device sync inside a hot-path loop.

The JAX rule's catalogue, unchanged: ``float()``/``int()``/``bool()`` on a
device value, ``.item()``/``.tolist()``, and ``np.asarray``/``np.array``/
``np.ascontiguousarray`` block the host until the device value is ready.
Inside the loop body of a hot module (``training/``, ``parallel/``,
``components/``, ``llm/serving.py``) that is a per-step pipeline stall.

The torch spellings that block the same way are added:

- ``.cpu()`` and ``.numpy()`` (a device→host copy; ``.numpy()``, ``.item()``
  or ``.tolist()`` chained onto a ``.cpu()`` are one sync, reported once at
  the ``.cpu()``), and ``torch.cuda.synchronize()``;
- a Python branch on a tensor: an ``if``, ``while`` or conditional
  expression whose test calls ``.any()``, ``.all()``, ``torch.equal`` or
  ``torch.allclose`` (the branch reads the value on the host);
- data-dependent shapes: ``.nonzero()`` / ``torch.nonzero``,
  ``masked_select`` and ``torch.unique`` (the output size is read back
  before the next launch).

The check is syntactic (no interprocedural dataflow): conversions whose
argument is obviously host-side (a literal, ``len(...)``, ``time.time()``,
``os.environ`` lookups, string parses, the ``numpy`` module itself) are
skipped; everything else in a hot loop is flagged and either fixed,
pragma'd with a justification, or baselined.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..findings import Finding
from .base import FileContext, Rule

#: builtins that force a device scalar to host
_SYNC_BUILTINS = {"float", "int", "bool"}
#: methods that force a device array to host
_SYNC_METHODS = {"item", "tolist"}
#: numpy entry points that materialise a device array on host
_SYNC_NUMPY = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
#: torch methods that copy to the host
_COPY_METHODS = {"cpu", "numpy"}
#: calls whose value a Python branch reads on the host
_BRANCH_METHODS = {"any", "all"}
_BRANCH_CALLS = {"torch.equal", "torch.allclose"}
#: torch calls whose output shape depends on the data
_SHAPE_METHODS = {"nonzero", "masked_select", "unique"}

#: call roots whose results are host values — conversions of these are fine
_HOST_CALLS = {"len", "time.time", "time.monotonic", "time.perf_counter",
               "os.getenv", "str", "repr", "round", "min", "max", "sum",
               "abs", "ord", "id", "hash"}
_HOST_ROOTS = ("os.environ", "os.path", "math.")


def _is_host_value(ctx: FileContext, node: ast.AST) -> bool:
    """Cheap 'obviously not a device array' filter for conversion arguments."""
    if isinstance(node, (ast.Constant, ast.JoinedStr, ast.Dict, ast.List,
                         ast.Tuple, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        dotted = ctx.dotted(node.func)
        if dotted and (dotted in _HOST_CALLS
                       or any(dotted.startswith(r) for r in _HOST_ROOTS)):
            return True
    if isinstance(node, (ast.Name, ast.Attribute, ast.Subscript)):
        dotted = ctx.dotted(node)
        if dotted and any(dotted.startswith(r) for r in _HOST_ROOTS):
            return True
    if isinstance(node, ast.BinOp):
        return (_is_host_value(ctx, node.left)
                and _is_host_value(ctx, node.right))
    return False


def _is_numpy_module(ctx: FileContext, node: ast.AST) -> bool:
    """``np`` / ``numpy`` / ``np.linalg``: a host module, never a tensor."""
    dotted = ctx.dotted(node) if isinstance(node, (ast.Name,
                                                   ast.Attribute)) else None
    return bool(dotted) and (dotted == "numpy" or dotted.startswith("numpy."))


def _after_cpu(node: ast.AST) -> bool:
    """True when ``node`` is, or is reached through a method chain from, a
    ``.cpu()`` call: the copy there is the sync, so what follows is host."""
    cur = node
    while isinstance(cur, ast.Call) and isinstance(cur.func, ast.Attribute):
        if cur.func.attr == "cpu":
            return True
        cur = cur.func.value
    return False


def _branch_tests(tree: ast.AST):
    """Every call inside the test of an ``if`` / ``while`` / conditional
    expression."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call):
                    yield sub


class HostSyncInHotLoop(Rule):
    id = "GX001"
    name = "host-sync-in-hot-loop"
    hint = ("keep the value on the device (torch ops / a device-side "
            "reduction) or move the sync to eval/generation cadence; "
            "host-mirror counters")

    def _conversion(self, ctx: FileContext, node: ast.Call):
        """The JAX catalogue plus the torch copies; None when not a sync."""
        # float(x) / int(x) / bool(x)
        if (isinstance(node.func, ast.Name)
                and node.func.id in _SYNC_BUILTINS
                and len(node.args) == 1 and not node.keywords
                and not _is_host_value(ctx, node.args[0])
                and not _after_cpu(node.args[0])):
            return (f"{node.func.id}(...) in a hot loop blocks on a device "
                    f"value (host↔device sync per iteration)")
        dotted = ctx.dotted(node.func)
        # np.asarray / np.array
        if dotted in _SYNC_NUMPY and node.args \
                and not _is_host_value(ctx, node.args[0]) \
                and not _after_cpu(node.args[0]):
            return (f"{dotted}(...) in a hot loop copies a device array to "
                    f"host every iteration")
        if dotted == "torch.cuda.synchronize":
            return ("torch.cuda.synchronize() in a hot loop waits for the "
                    "whole device queue every iteration")
        if not isinstance(node.func, ast.Attribute):
            return None
        attr, receiver = node.func.attr, node.func.value
        if _is_host_value(ctx, receiver) or _is_numpy_module(ctx, receiver):
            return None
        # .item() / .tolist(): dict.items() is ubiquitous and never matches
        if attr in _SYNC_METHODS and not node.args and not node.keywords \
                and not _after_cpu(receiver):
            return (f".{attr}() in a hot loop forces a blocking "
                    f"device→host transfer")
        # .cpu() / .numpy()
        if attr in _COPY_METHODS and not node.args \
                and not (attr == "numpy" and _after_cpu(receiver)):
            return (f".{attr}() in a hot loop copies a tensor to the host "
                    f"every iteration")
        # .nonzero() / torch.nonzero / masked_select / torch.unique
        if attr in _SHAPE_METHODS:
            return (f"{attr}(...) in a hot loop has a data-dependent output "
                    f"shape: the size is read back on the host")
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.is_hot():
            return
        flagged = set()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not ctx.in_loop(node):
                continue
            message = self._conversion(ctx, node)
            if message is not None:
                flagged.add(id(node))
                yield self.finding(ctx, node, message)
        # a Python branch on a tensor (bool() of the test is the sync)
        for node in _branch_tests(ctx.tree):
            if id(node) in flagged or not ctx.in_loop(node):
                continue
            parent = ctx.parents.get(id(node))
            if isinstance(parent, ast.Call) and id(parent) in flagged:
                continue  # bool(x.any()): reported at the conversion
            dotted = ctx.dotted(node.func)
            if dotted in _BRANCH_CALLS:
                name = dotted
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _BRANCH_METHODS
                  and not _is_host_value(ctx, node.func.value)
                  and not _is_numpy_module(ctx, node.func.value)
                  and not _after_cpu(node.func.value)):
                name = f".{node.func.attr}()"
            else:
                continue
            flagged.add(id(node))
            yield self.finding(
                ctx, node,
                f"a Python branch on {name} in a hot loop reads a device "
                f"value on the host every iteration")
