"""GX005 — retry-wrapped collectives.

The collectives-fail-fast invariant: ``call_with_retries``/``RetryPolicy``
must never wrap a collective. A per-host retry desynchronises the pod (the
other hosts already entered the collective once); the sanctioned recovery
is snapshot-resume, and the sanctioned timeout wrapper is
``call_with_collective_timeout`` (which raises ``MembershipChange`` instead
of retrying). This rule flags any retry-entry-point call whose argument
subtree references a collective: the JAX rule's ``multihost`` module (the
port's ``parallel/multihost.py``), plus the port's hand-run collectives in
``parallel/comm.py`` and ``torch.distributed`` itself.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..findings import Finding
from .base import FileContext, Rule

_RETRY_ENTRY_POINTS = {"call_with_retries", "RetryPolicy", "RetryingEnv"}
#: module names whose members are collectives
_COLLECTIVE_MODULES = ("multihost", "comm")
_TORCH_DISTRIBUTED = "torch.distributed"


class RetryWrappedCollective(Rule):
    id = "GX005"
    name = "retry-wrapped-collective"
    hint = ("collectives fail fast: use call_with_collective_timeout + "
            "snapshot-resume (MembershipChange), never a per-host retry")

    def _references_collective(self, ctx: FileContext,
                               node: ast.AST) -> bool:
        for sub in ast.walk(node):
            dotted = ctx.dotted(sub) if isinstance(
                sub, (ast.Attribute, ast.Name)) else None
            if not dotted:
                continue
            if dotted == _TORCH_DISTRIBUTED or dotted.startswith(
                    _TORCH_DISTRIBUTED + "."):
                return True  # dist.all_reduce under import torch.distributed
            parts = dotted.split(".")
            if any(m in parts[:-1] for m in _COLLECTIVE_MODULES):
                return True  # multihost.barrier / parallel.comm.sum_to_all
            if isinstance(sub, ast.Name):
                resolved = ctx.from_imports.get(sub.id, "")
                if any(f".{m}." in f".{resolved}"
                       for m in _COLLECTIVE_MODULES):
                    return True  # from .multihost import barrier; barrier
        return False

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func) or ""
            leaf = dotted.rsplit(".", 1)[-1]
            if leaf not in _RETRY_ENTRY_POINTS:
                continue
            args = list(node.args) + [kw.value for kw in node.keywords]
            if any(self._references_collective(ctx, a) for a in args):
                yield self.finding(
                    ctx, node,
                    f"{leaf}(...) wraps a collective — a per-host retry "
                    f"desynchronises the pod (collectives-fail-fast "
                    f"invariant)")
