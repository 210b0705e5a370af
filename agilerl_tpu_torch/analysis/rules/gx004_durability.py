"""GX004 — non-atomic durability writes.

In durability-relevant modules (``resilience/``, ``observability/``,
``utils/checkpoint.py``, ``parallel/plan.py``, ``parallel/elastic.py``,
``parallel/compile_cache.py``), a bare ``open(path, "w")`` /
``Path.write_text`` / raw ``os.replace`` / ``torch.save(obj, <path>)`` bypasses
the tmp + fsync + manifest commit protocol in ``resilience/atomic.py`` — a
kill mid-write leaves a torn file that a reader later trusts (the
torn-write bug class). Append-mode opens (``"a"``) are exempt: JSONL
telemetry streams tolerate a torn tail line by design. ``resilience/atomic.py``
itself — the protocol implementation — is exempt wholesale.

``torch.save`` is the port's addition: it opens and truncates its target
when given a path. Its second argument counts as a path when it is a string
(literal or f-string), a path expression (``a / b``, ``a + b``), a
``Path(...)`` / ``os.path.join(...)`` / ``str(...)`` / ``os.fspath(...)``
call, or a name whose identifier says so (``*path*``, ``*file*``,
``*dir*``, ``*dest*``, ``*dst*``, ``*target*``); a buffer or an open handle
(``io.BytesIO()``, ``fh``) is not flagged — the write that publishes it is.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from ..findings import Finding
from .base import FileContext, Rule

_RENAMES = {"os.replace", "os.rename", "shutil.move"}
_PATH_WRITES = {"write_text", "write_bytes"}
_TORCH_SAVE = "torch.save"
_PATH_CALLS = {"pathlib.Path", "Path", "os.path.join", "str", "os.fspath",
               "pathlib.PurePath"}
_PATH_WORDS = ("path", "file", "dir", "dest", "dst", "target")


def _open_mode(node: ast.Call) -> Optional[str]:
    """Literal mode string of an ``open(...)`` call, or None when absent or
    dynamic."""
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant) \
            and isinstance(node.args[1].value, str):
        return node.args[1].value
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant) \
                and isinstance(kw.value.value, str):
            return kw.value.value
    return None


def _save_target(node: ast.Call) -> Optional[ast.AST]:
    if len(node.args) >= 2:
        return node.args[1]
    for kw in node.keywords:
        if kw.arg == "f":
            return kw.value
    return None


def _is_path_like(ctx: FileContext, node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str)
    if isinstance(node, (ast.JoinedStr, ast.BinOp)):
        return True
    if isinstance(node, ast.Call):
        return ctx.dotted(node.func) in _PATH_CALLS
    ident = (node.id if isinstance(node, ast.Name)
             else node.attr if isinstance(node, ast.Attribute) else "")
    return any(w in ident.lower() for w in _PATH_WORDS)


class NonAtomicDurabilityWrite(Rule):
    id = "GX004"
    name = "non-atomic-durability-write"
    hint = ("route through resilience.atomic (atomic_write_bytes / "
            "atomic_pickle for single files, staged_* + commit_dir for "
            "snapshot directories)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.is_durability():
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            # bare truncating/creating open()
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _open_mode(node)
                if mode and any(c in mode for c in "wx"):
                    yield self.finding(
                        ctx, node,
                        f"bare open(..., {mode!r}) in a durability module — "
                        f"a kill mid-write leaves a torn file readers will "
                        f"trust")
                continue
            dotted = ctx.dotted(node.func)
            # raw rename outside the commit protocol
            if dotted in _RENAMES:
                yield self.finding(
                    ctx, node,
                    f"raw {dotted}(...) outside the atomic commit protocol — "
                    f"no fsync before publish, no manifest after")
                continue
            # torch.save(obj, <path>): torch opens and truncates the target
            if dotted == _TORCH_SAVE and _is_path_like(
                    ctx, _save_target(node)):
                yield self.finding(
                    ctx, node,
                    "torch.save(..., <path>) in a durability module writes "
                    "the file in place with no tmp+fsync+replace commit")
                continue
            # Path(...).write_text / write_bytes
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _PATH_WRITES):
                yield self.finding(
                    ctx, node,
                    f".{node.func.attr}(...) in a durability module writes "
                    f"in place with no tmp+fsync+replace commit")
