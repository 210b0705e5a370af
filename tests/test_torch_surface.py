"""The port's public surface against the JAX package's, by their source
alone: every public top-level name (function, class or assignment) of a
module of ``agilerl_tpu/`` has a counterpart in the port's module of the
same path (defined there or imported into it), and every public method a
JAX class defines has a counterpart on the port's class of the same name
(a method, a property or an attribute it sets, its own or a base class's
in the port). The only exceptions are ``DECIDED``, one reason each. Both
packages are read with ``ast``; neither is imported."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT, PORT_ROOT = ROOT / "agilerl_tpu", ROOT / "agilerl_tpu_torch"

_COMPILE_CACHE = ("XLA executables: the port's compile cache stores the nvcc-built kernel "
                  "libraries, and its store internals were decided with it (a ROADMAP decision)")

#: (module path, name or Class.method) -> why the port has no counterpart
DECIDED = {
    ("compat.py", None): "a shim over jax's API; the port imports no jax",
    ("ops/kernel_mode.py", None): "Pallas's interpret / disable switch; the device rule "
                                  "replaces it (ROADMAP decision)",
    ("ops/__init__.py", "pallas_enabled"): "the Pallas switch of ops/kernel_mode.py; the "
                                           "device rule replaces it",
    ("envs/core.py", "JaxEnv"): "the port's TorchEnv",
    ("envs/core.py", "JaxVecEnv"): "the port's TorchVecEnv",
    ("envs/multi_agent.py", "SimpleSpreadJax"): "the port's SimpleSpreadTorch",
    ("envs/multi_agent.py", "MultiAgentJaxVecEnv"): "the port's MultiAgentTorchVecEnv",
    ("utils/hbm_budget.py", "HBM_PER_CHIP"): "TPU HBM sizes; the port's budget reads the "
                                             "card's memory",
    ("utils/profiling.py", "achieved_flops_metrics"): "XLA's cost analysis of a compiled "
                                                      "program; the port compiles none",
    ("llm/model.py", "use_chunked_decode"): "AGILERL_TPU_DISABLE_CHUNKED_DECODE, an XLA "
                                            "compile-time switch (ROADMAP decision)",
    ("llm/serving.py", "measured_cache_size"): "counts XLA's jit caches; the port's counterpart "
                                               "is analysis/runtime.CompileGuard",
    ("resilience/snapshot.py", "key_to_host"): "JAX PRNG keys; the port's generators travel "
                                               "as their states (utils/rng.py)",
    ("resilience/snapshot.py", "key_from_host"): "JAX PRNG keys (see key_to_host)",
    ("parallel/compile_cache.py", "abstract_signature"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "deserialize_payload"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "plan_digest"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "runtime_versions"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "serialize_compiled"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "topology_desc"): _COMPILE_CACHE,
    ("parallel/compile_cache.py", "CachedFunction.prepare"): _COMPILE_CACHE,
}


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _imported(node: ast.AST) -> set:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return {(a.asname or a.name).split(".")[0] for a in node.names}
    return set().union(*map(_imported, _nested(node)))


def _nested(node: ast.AST) -> list:
    """The statements of a module-level if / try."""
    if not isinstance(node, (ast.If, ast.Try)):
        return []
    body = node.body + node.orelse + getattr(node, "finalbody", [])
    return body + [s for h in getattr(node, "handlers", []) for s in h.body]


def _assigned(node: ast.AST) -> set:
    """Names a statement defines or assigns (descending into if / try)."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return {node.name}
    if isinstance(node, (ast.Assign, ast.AnnAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        return {n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name)}
    return set().union(*map(_assigned, _nested(node)))


def _own_names(tree: ast.Module) -> set:
    """A JAX module's public names: what it defines or assigns, but not a
    name it imports (nor the fallback value of a ``try: import``)."""
    own = set().union(*map(_assigned, tree.body)) - set().union(*map(_imported, tree.body))
    return {n for n in own if not n.startswith("_")}


def _bound(tree: ast.Module) -> set:
    """Every name a port module binds, imports included."""
    return set().union(*map(_assigned, tree.body), *map(_imported, tree.body))


def _classes(tree: ast.Module) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _own_methods(cls: ast.ClassDef) -> set:
    return {s.name for s in cls.body
            if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)) and not s.name.startswith("_")}


def _members(cls: ast.ClassDef) -> set:
    """Methods, class-level names and the attributes its methods set on self."""
    out = set()
    for s in cls.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(s.name)
            out |= {n.attr for n in ast.walk(s) if isinstance(n, ast.Attribute)
                    and isinstance(n.ctx, ast.Store) and isinstance(n.value, ast.Name)
                    and n.value.id == "self"}
        else:
            out |= _assigned(s)
    return out


def _base_names(cls: ast.ClassDef) -> list:
    return [b.id if isinstance(b, ast.Name) else b.attr for b in cls.bases
            if isinstance(b, (ast.Name, ast.Attribute))]


@pytest.fixture(scope="module")
def port():
    """Every port module's tree by its path, and every port class by name (a
    name may be defined in several modules)."""
    trees = {p.relative_to(PORT_ROOT).as_posix(): _parse(p) for p in PORT_ROOT.rglob("*.py")}
    classes = {}
    for tree in trees.values():
        for name, node in _classes(tree).items():
            classes.setdefault(name, []).append(node)
    return trees, classes


def _all_members(cls: ast.ClassDef, classes: dict, memo: dict, seen=()) -> set:
    """``_members`` of the class and of its bases in the port (``memo``: by
    class node, for the classes many others derive from)."""
    if cls not in memo:
        memo[cls] = _members(cls)
    out = set(memo[cls])
    for base in _base_names(cls):
        if base not in seen:
            for node in classes.get(base, []):
                out |= _all_members(node, classes, memo, seen + (base,))
    return out


def test_every_public_name_of_the_jax_package_has_a_counterpart(port):
    trees, classes = port
    missing, used, memo = [], set(), {}
    for jpath in sorted(JAX_ROOT.rglob("*.py")):
        rel = jpath.relative_to(JAX_ROOT).as_posix()
        if rel not in trees:
            (used.add((rel, None)) if (rel, None) in DECIDED else missing.append((rel, None)))
            continue
        jtree, ptree = _parse(jpath), trees[rel]
        wanted = [(rel, n) for n in sorted(_own_names(jtree) - _bound(ptree))]
        pcls = _classes(ptree)
        for name, node in sorted(_classes(jtree).items()):
            if name.startswith("_") or name not in pcls or not _own_methods(node):
                continue
            have = _all_members(pcls[name], classes, memo)
            wanted += [(rel, f"{name}.{m}") for m in sorted(_own_methods(node) - have)]
        for key in wanted:
            (used.add(key) if key in DECIDED else missing.append(key))
    assert not missing, f"public names of the JAX package with no counterpart: {missing}"
    assert used == set(DECIDED), f"decided names that are no longer missing: {set(DECIDED) - used}"
