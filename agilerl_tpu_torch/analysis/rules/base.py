"""Rule base class + the per-file AST context every rule shares (the port's
copy of ``agilerl_tpu/analysis/rules/base.py``: the same path categories,
read over ``agilerl_tpu_torch/``).

``FileContext`` does the one pass of bookkeeping rules would otherwise each
repeat: a parent map (ast has no parent pointers), an import-alias table so
``np.random.randint`` / ``numpy.random.randint`` / ``from numpy.random import
randint`` all resolve to the same dotted name, and path-category predicates
(hot module, durability module) that match on **path segments** so the same
rules fire on fixture trees under ``tests/fixtures/analysis_torch/`` as on
the real package.
"""

from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Dict, Iterator, List, Optional, Tuple

from ..findings import Finding

#: loop-shaped nodes — rule checks about "inside a loop body" include
#: comprehensions (a listcomp over device values syncs per element just like a
#: for loop does)
LOOP_NODES = (ast.For, ast.AsyncFor, ast.While,
              ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)

#: hot-path categories (GX001/GX002 loop checks): any file under these
#: segments, or the serving module itself
HOT_SEGMENTS = ("training", "parallel", "components")
HOT_FILES = ("llm/serving.py",)

#: durability categories (GX004): modules that write snapshot/export-adjacent
#: state and must route through resilience/atomic.py
DURABILITY_SEGMENTS = ("resilience", "observability")
DURABILITY_FILES = ("utils/checkpoint.py", "parallel/plan.py",
                    "parallel/elastic.py", "parallel/compile_cache.py")
#: the protocol implementation itself is exempt from GX004
DURABILITY_EXEMPT = ("resilience/atomic.py",)


def _segments(relpath: str) -> Tuple[str, ...]:
    return PurePosixPath(relpath).parts


def _endswith(relpath: str, suffixes: Tuple[str, ...]) -> bool:
    return any(relpath == s or relpath.endswith("/" + s) for s in suffixes)


class FileContext:
    """Everything a rule needs to know about one parsed source file."""

    def __init__(self, relpath: str, source: str, tree: ast.AST):
        self.relpath = relpath.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: Dict[int, ast.AST] = {}
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[id(child)] = parent
        #: name bound by ``import X as a`` / ``import X`` -> dotted module
        self.module_aliases: Dict[str, str] = {}
        #: name bound by ``from M import X as a`` -> dotted ``M.X``
        self.from_imports: Dict[str, str] = {}
        self._collect_imports()

    # -- imports ----------------------------------------------------------- #
    def _module_name(self) -> str:
        """Dotted module name of this file relative to the scan root — used
        to resolve relative imports (``from .multihost import barrier``)."""
        parts = list(_segments(self.relpath))
        if parts and parts[-1].endswith(".py"):
            parts[-1] = parts[-1][:-3]
        if parts and parts[-1] == "__init__":
            parts.pop()
        return ".".join(parts)

    def _collect_imports(self) -> None:
        mod_parts = self._module_name().split(".")
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    self.module_aliases[alias.asname or
                                        alias.name.split(".")[0]] = (
                        alias.name if alias.asname else
                        alias.name.split(".")[0])
                    if alias.asname:
                        self.module_aliases[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    # relative import: resolve against this file's package
                    base = mod_parts[:-node.level] if node.level <= len(
                        mod_parts) else []
                    prefix = ".".join(base + ([node.module]
                                              if node.module else []))
                else:
                    prefix = node.module or ""
                for alias in node.names:
                    if alias.name == "*":
                        continue
                    full = f"{prefix}.{alias.name}" if prefix else alias.name
                    self.from_imports[alias.asname or alias.name] = full

    # -- name resolution ---------------------------------------------------- #
    def dotted(self, node: ast.AST) -> Optional[str]:
        """``Name``/``Attribute`` chain -> dotted string with the root name
        expanded through the import tables: ``np.random.randint`` (under
        ``import numpy as np``) -> ``numpy.random.randint``."""
        parts: List[str] = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = cur.id
        expanded = (self.module_aliases.get(root)
                    or self.from_imports.get(root) or root)
        parts.append(expanded)
        return ".".join(reversed(parts))

    # -- structural helpers -------------------------------------------------- #
    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(id(node))
        while cur is not None:
            yield cur
            cur = self.parents.get(id(cur))

    def in_loop(self, node: ast.AST) -> bool:
        """True when ``node`` executes repeatedly: any ancestor is a loop (or
        comprehension). Function bodies *inside* the loop still count; a
        nested ``def`` does NOT (its body runs when called, not per
        iteration — the call site is what a loop check should flag)."""
        for anc in self.ancestors(node):
            if isinstance(anc, LOOP_NODES):
                return True
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return False
        return False

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def span(self, node: ast.AST) -> Tuple[int, int]:
        """Physical (first, last) line of the statement containing ``node`` —
        the range a line pragma may appear on. For a node in a COMPOUND
        statement's header (``with open(...)``, ``for x in draws()``, ...)
        the span stops at the header: a pragma on a body line must not
        suppress a header finding (body nodes resolve to their own inner
        statement first, so only header nodes reach the compound here)."""
        stmt = node
        for anc in self.ancestors(node):
            stmt = anc
            if isinstance(anc, ast.stmt):
                break
        first = getattr(stmt, "lineno", getattr(node, "lineno", 1))
        last = getattr(stmt, "end_lineno", first) or first
        body = getattr(stmt, "body", None)
        if isinstance(body, list) and body and hasattr(body[0], "lineno"):
            last = max(first, body[0].lineno - 1)
        return first, last

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # -- path categories ----------------------------------------------------- #
    def is_hot(self) -> bool:
        segs = _segments(self.relpath)[:-1]
        return (any(s in segs for s in HOT_SEGMENTS)
                or _endswith(self.relpath, HOT_FILES))

    def is_durability(self) -> bool:
        if _endswith(self.relpath, DURABILITY_EXEMPT):
            return False
        segs = _segments(self.relpath)[:-1]
        return (any(s in segs for s in DURABILITY_SEGMENTS)
                or _endswith(self.relpath, DURABILITY_FILES))


class Rule:
    """One hazard class. Subclasses set ``id``/``name``/``hint`` and implement
    :meth:`check` yielding findings (without fingerprints — the engine assigns
    them after pragma filtering)."""

    id: str = ""
    name: str = ""
    hint: str = ""

    def check(self, ctx: FileContext) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST, message: str,
                hint: Optional[str] = None) -> Finding:
        lineno = getattr(node, "lineno", 1)
        return Finding(
            rule=self.id,
            path=ctx.relpath,
            line=lineno,
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=hint or self.hint,
            text=ctx.line_text(lineno),
            span=ctx.span(node),
        )
