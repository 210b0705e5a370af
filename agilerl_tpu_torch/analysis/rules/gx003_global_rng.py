"""GX003 — global-RNG draws.

Module-level ``np.random.*`` / stdlib ``random.*`` draws break kill-resume
determinism (a clone that draws the *global* numpy stream makes a resumed
run diverge unless the global state was captured too) and make seeded runs
depend on hidden global stream positions. The JAX rule's catalogue is kept
as it is; the torch draws on the global stream are added:

- ``torch.rand`` / ``randn`` / ``randint`` / ``randperm`` / ``multinomial`` /
  ``bernoulli`` / ``normal`` / ``poisson`` without ``generator=``;
- the ``*_like`` draws (``rand_like``, ``randn_like``, ``randint_like``),
  which take no generator at all;
- the in-place draws ``.uniform_`` / ``.normal_`` / ``.bernoulli_`` /
  ``.exponential_`` / ``.random_`` (and ``.cauchy_`` / ``.log_normal_`` /
  ``.geometric_``) without ``generator=``;
- ``torch.manual_seed`` / ``torch.cuda.manual_seed(_all)`` / ``torch.seed``
  (reseeding the global stream from a library).

RNG must flow through threaded ``np.random.Generator`` /
``torch.Generator`` objects; the one sanctioned root lives in
``utils/rng.py`` (allowlisted) so the global stream is consumed in exactly
one audited place. State management (``seed``/``get_state``/``set_state``
on numpy) and constructors (``default_rng``/``Generator``/``SeedSequence``,
``torch.Generator(...).manual_seed(...)``) are not draws and are not
flagged.
"""

from __future__ import annotations

import ast
from typing import Iterator

from ..findings import Finding
from .base import FileContext, Rule, _endswith

#: files allowed to draw the global stream (the audited derivation root)
ALLOW_FILES = ("utils/rng.py",)

_NUMPY_DRAWS = {
    "beta", "binomial", "bytes", "chisquare", "choice", "dirichlet",
    "exponential", "f", "gamma", "geometric", "gumbel", "hypergeometric",
    "laplace", "logistic", "lognormal", "logseries", "multinomial",
    "multivariate_normal", "negative_binomial", "noncentral_chisquare",
    "noncentral_f", "normal", "pareto", "permutation", "poisson", "power",
    "rand", "randint", "randn", "random", "random_integers", "random_sample",
    "ranf", "rayleigh", "sample", "shuffle", "standard_cauchy",
    "standard_exponential", "standard_gamma", "standard_normal", "standard_t",
    "triangular", "uniform", "vonmises", "wald", "weibull", "zipf",
}
_STDLIB_DRAWS = {
    "betavariate", "choice", "choices", "expovariate", "gammavariate",
    "gauss", "getrandbits", "lognormvariate", "normalvariate",
    "paretovariate", "randbytes", "randint", "random", "randrange", "sample",
    "shuffle", "triangular", "uniform", "vonmisesvariate", "weibullvariate",
}
#: torch draws that take ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "multinomial",
                "bernoulli", "normal", "poisson"}
#: torch draws with no generator parameter
_TORCH_LIKE_DRAWS = {"rand_like", "randn_like", "randint_like"}
#: in-place tensor draws that take ``generator=``
_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "exponential_",
                  "random_", "cauchy_", "log_normal_", "geometric_"}
#: reseeding the global torch stream
_TORCH_RESEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
                  "torch.random.seed", "torch.cuda.manual_seed",
                  "torch.cuda.manual_seed_all", "torch.cuda.seed",
                  "torch.cuda.seed_all"}


def _has_generator(node: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in node.keywords)


class GlobalRngDraw(Rule):
    id = "GX003"
    name = "global-rng-draw"
    hint = ("thread an np.random.Generator / torch.Generator through the "
            "call path; derive unseeded fallbacks via utils/rng.py so the "
            "draw is captured by the resilience RNG protocol")

    @staticmethod
    def _imported_stdlib_random(ctx: FileContext) -> bool:
        """Only trust a ``random.*`` resolution when the file really imported
        the stdlib module (``import random`` or ``from random import ...``) —
        a local Generator variable that happens to be named ``random`` must
        not trip the rule."""
        return (ctx.module_aliases.get("random") == "random"
                or any(v == "random" or v.startswith("random.")
                       for v in ctx.from_imports.values()))

    def _torch_draw(self, ctx: FileContext, node: ast.Call, dotted: str):
        """Message for a global-stream torch draw, or None."""
        if dotted in _TORCH_RESEEDS:
            return (f"{dotted}(...) reseeds the GLOBAL torch stream from "
                    f"library code — every other draw's position moves")
        if dotted.startswith("torch.") and dotted.count(".") == 1:
            leaf = dotted[len("torch."):]
            if leaf in _TORCH_LIKE_DRAWS:
                return (f"{dotted}(...) draws the GLOBAL torch stream (the "
                        f"*_like draws take no generator)")
            if leaf in _TORCH_DRAWS and not _has_generator(node):
                return (f"{dotted}(...) without generator= draws the GLOBAL "
                        f"torch stream — kill-resume determinism depends on "
                        f"hidden global state")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _INPLACE_DRAWS
                and not _has_generator(node)):
            return (f".{node.func.attr}(...) without generator= draws the "
                    f"GLOBAL torch stream in place")
        return None

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if _endswith(ctx.relpath, ALLOW_FILES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = ctx.dotted(node.func) or ""
            if dotted == "numpy.random.default_rng" and not node.args \
                    and not node.keywords:
                yield self.finding(
                    ctx, node,
                    "np.random.default_rng() with no seed — an OS-entropy "
                    "Generator that escapes BOTH np.random.seed and the "
                    "resilience snapshot (unseeded runs stay "
                    "nondeterministic even when seeded)",
                    hint=("derive the fallback via utils/rng.derive_rng so "
                          "the seed comes from the captured global stream"))
            elif dotted.startswith("numpy.random.") and \
                    dotted.rsplit(".", 1)[1] in _NUMPY_DRAWS:
                yield self.finding(
                    ctx, node,
                    f"{dotted}(...) draws the GLOBAL numpy stream — "
                    f"kill-resume determinism depends on hidden global "
                    f"state (the evolution-cloning bug class)")
            elif dotted.startswith("random.") and \
                    dotted.rsplit(".", 1)[1] in _STDLIB_DRAWS and \
                    self._imported_stdlib_random(ctx):
                yield self.finding(
                    ctx, node,
                    f"{dotted}(...) draws the global stdlib random stream — "
                    f"untracked by the threaded-Generator protocol")
            else:
                message = self._torch_draw(ctx, node, dotted)
                if message is not None:
                    yield self.finding(ctx, node, message)
