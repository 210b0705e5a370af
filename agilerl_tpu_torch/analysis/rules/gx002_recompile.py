"""GX002 — steady-state recompilation hazards.

The JAX rule's first two sub-patterns, mapped to what compiles or captures
a program in torch:

- ``torch.compile``, ``torch.jit.script`` / ``torch.jit.trace``, or a CUDA
  graph capture (``torch.cuda.CUDAGraph()`` / ``torch.cuda.graph(...)``)
  built inside a **loop body** — a fresh compiled (or captured) program per
  iteration instead of one cached at init/module scope.
- ``torch.compile(lambda ...)`` inside a **function body** — every call of
  the enclosing function builds a new lambda object, so the compile cache
  (keyed on the function object) never hits across calls. Module-scope
  ``torch.compile(lambda ...)`` binds once and is fine.

The JAX rule's third sub-pattern (a step jitted without
``donate_argnums``) is dropped: an eager torch step updates its tensors in
place and has no donation to forget, so it cannot double peak memory that
way.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..findings import Finding
from .base import FileContext, Rule

_COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.jit.trace_module", "torch.cuda.CUDAGraph",
                  "torch.cuda.graph", "torch.cuda.graphs.CUDAGraph",
                  "torch.cuda.graphs.graph"}


class RecompileHazard(Rule):
    id = "GX002"
    name = "recompile-hazard"
    hint = ("compile (or capture) once at init/module scope and reuse the "
            "one object for the life of the program")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func)
            if dotted not in _COMPILE_NAMES:
                continue
            if ctx.in_loop(node):
                yield self.finding(
                    ctx, node,
                    f"{dotted} called inside a loop body — a fresh compiled "
                    f"or captured program per iteration instead of reusing "
                    f"one cached program")
                continue
            first = node.args[0] if node.args else None
            if dotted == "torch.compile" and isinstance(first, ast.Lambda) \
                    and ctx.enclosing_function(node) is not None:
                yield self.finding(
                    ctx, node,
                    "torch.compile(lambda ...) inside a function body — each "
                    "call creates a fresh closure, so the compile cache never "
                    "hits across calls")
