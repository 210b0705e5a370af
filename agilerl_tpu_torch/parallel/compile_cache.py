"""Persistent store of the port's compiled programs: the nvcc-built kernel
libraries of ``agilerl_tpu_torch/csrc/``. The port of
``agilerl_tpu/parallel/compile_cache.py`` under the JAX module's name.

The store, its key and its load-or-compile path live in
:mod:`agilerl_tpu_torch.ops._build`, beside the kernels that load through
it (so ``ops`` never imports ``parallel``); this module re-exports them and
documents the contract there.

**Decision.** The JAX module also stores serialised XLA executables of the
jitted steps: :class:`CachedFunction`, ``jit_fn(cache=)``, serving's and the
elastic controller's ``compile_cache=`` and ``compile_step_with_plan(cache=)``.
The port runs those steps eagerly and leaves no program to store, so each
of them raises ``NotImplementedError``; the only compiled artifacts of the
port are the kernel libraries, and this store holds them.
"""

from __future__ import annotations

from agilerl_tpu_torch.ops._build import (  # noqa: F401
    CACHE_ENV,
    CACHE_TIME_BUCKETS,
    LIBRARY_FILE,
    ExecutableStore,
    build_count,
    default_store,
    fingerprint_digest,
    fingerprint_parts,
    key_flags,
    load_or_compile,
    load_or_compile_all,
    nvcc_version,
    resolve_cache,
)

_EAGER = ("{} stores XLA executables of jitted steps; the port runs its steps "
          "eagerly and leaves no program to store (its compile cache holds "
          "the nvcc-built kernel libraries: load_or_compile)")


class CachedFunction:
    """The JAX module's per-signature load-or-compile jit wrapper. Raises:
    there is no jitted callable in the port to wrap."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_EAGER.format("CachedFunction"))
