"""Runtime compile/sync guards — the dynamic half of the port's graftcheck,
the counterpart of ``agilerl_tpu/analysis/runtime.py`` (the same classes,
errors, budgets, labels, nesting and registry counters).

``CompileGuard`` asserts a guarded region makes no new program. The port
runs its steps eagerly, so what it "compiles" is of two kinds: the program
signatures a serving object has run (``compiled_programs`` on
``BucketedGenerator`` / ``ContinuousGenerator`` / ``ServingFleet``, the
counterpart of ``llm/serving.measured_cache_size``), and the nvcc builds of
the kernel libraries (counted by the compile cache,
:mod:`agilerl_tpu_torch.ops._build`, on every build: the global mode).

``SyncGuard`` counts blocking device→host transfers and emits
``analysis/host_syncs_total``. It counts two ways:

- the JAX guard's catalogue — ``float()`` / ``int()`` / ``bool()`` /
  ``.item()`` / ``.tolist()`` on a ``torch.Tensor`` — through a
  reference-counted patch of those methods (``by_kind``), which keeps
  parity with the JAX guard on the same region, on any device;
- on a CUDA device, also every synchronisation the CUDA runtime reports
  under ``torch.cuda.set_sync_debug_mode("warn")``, by site (the innermost
  three frames of the port or of torch's Python code). There the runtime's
  count is the one ``max_syncs`` is held against: it sees every sync, a
  conversion included, and also the copies (``.cpu()``, ``.numpy()``) and
  data-dependent shapes that the conversion patch cannot.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

_THIS_FILE = str(Path(__file__).resolve())


class CompileGuardError(AssertionError):
    """A guarded region made a new program (steady-state recompile)."""


class SyncGuardError(AssertionError):
    """A guarded region exceeded its blocking device→host transfer budget."""


def measured_programs(*objects: Any) -> int:
    """Total ``compiled_programs`` over ``objects`` (generators, fleets), or
    the sentinel -1 when any of them does not keep that accounting."""
    total = 0
    for obj in objects:
        n = getattr(obj, "compiled_programs", None)
        if n is None:
            return -1
        total += int(n)
    return total


def _nvcc_builds() -> int:
    from agilerl_tpu_torch.ops import _build

    return _build.build_count()


class CompileGuard:
    """Context manager asserting **zero** (or ``<= max_new``) new programs
    inside the guarded region.

    Three accounting modes, strongest available wins:

    - ``CompileGuard(gen, fleet)`` — the objects' ``compiled_programs``
      (the serving tier's contract);
    - ``CompileGuard(sizer=lambda: n)`` — any callable returning a live
      program count;
    - ``CompileGuard()`` — global: the nvcc builds of the kernel libraries,
      process-wide (what a warm process must hold at zero).

    An object without ``compiled_programs`` (sentinel ``-1``) falls back to
    global mode rather than silently passing.
    """

    def __init__(self, *objects: Any, max_new: int = 0,
                 sizer: Optional[Callable[[], int]] = None,
                 label: str = "", registry: Any = None):
        if objects and sizer is not None:
            raise ValueError("pass either objects with compiled_programs or "
                             "sizer=, not both")
        self._objects = objects
        self._sizer = sizer
        self.max_new = int(max_new)
        self.label = label
        self._registry = registry
        self._before: Optional[int] = None
        self._builds_before = 0
        self.new_compilations: Optional[int] = None

    # -- accounting --------------------------------------------------------- #
    def _measure(self) -> int:
        if self._sizer is not None:
            return int(self._sizer())
        if self._objects:
            return measured_programs(*self._objects)
        return -1  # global mode

    @property
    def global_mode(self) -> bool:
        return self._before is not None and self._before < 0

    # -- context protocol --------------------------------------------------- #
    def __enter__(self) -> "CompileGuard":
        self._before = self._measure()
        if self._before < 0:
            # global mode (requested, or the explicit accounting is
            # missing): count the store's nvcc builds instead
            self._builds_before = _nvcc_builds()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        where = f" [{self.label}]" if self.label else ""
        accounting_failure = None
        if self._before is not None and self._before >= 0:
            after = self._measure()
            if after < 0:
                # the accounting vanished mid-region: we cannot prove
                # anything — fail loudly, never silently pass
                accounting_failure = (
                    "compiled-program accounting returned the -1 sentinel at "
                    "exit — cannot prove the region did not recompile")
                self.new_compilations = None
            elif after < self._before:
                accounting_failure = (
                    f"compiled-program count shrank {self._before}→{after} "
                    f"inside the guarded region (generator reset?) — "
                    f"accounting invalid, recompiles could hide behind the "
                    f"reset")
                self.new_compilations = None
            else:
                self.new_compilations = after - self._before
        else:
            self.new_compilations = _nvcc_builds() - self._builds_before
        if self._registry is not None and self.new_compilations:
            self._registry.counter(
                "analysis/recompilations_total",
                help="new programs observed inside CompileGuard regions",
            ).inc(self.new_compilations)
        if exc_type is None:
            if accounting_failure is not None:
                raise CompileGuardError(
                    f"CompileGuard{where}: {accounting_failure}")
            if self.new_compilations > self.max_new:
                raise CompileGuardError(
                    f"CompileGuard{where}: {self.new_compilations} new "
                    f"compiled program(s) in a region budgeted for "
                    f"{self.max_new} — steady-state recompilation "
                    f"(GX002 hazard)")
        return False


class _SyncPatch:
    """Process-wide patch of the blocking conversion methods on
    ``torch.Tensor``; installed while at least one SyncGuard is active.
    Reference-counted so guards nest."""

    _lock = threading.Lock()
    #: name -> the class's own attribute, or None when it was inherited
    #: (from ``torch._C.TensorBase``): restored by deleting the override
    _originals: Dict[str, Any] = {}
    _guards: List["SyncGuard"] = []

    #: the conversions GX001 flags statically and the JAX guard counts
    _METHODS = ("__float__", "__int__", "__bool__", "item", "tolist")

    @classmethod
    def attach(cls, guard: "SyncGuard") -> None:
        with cls._lock:
            if not cls._guards:
                for name in cls._METHODS:
                    cls._originals[name] = torch.Tensor.__dict__.get(name)
                    setattr(torch.Tensor, name,
                            cls._wrap(name, getattr(torch.Tensor, name)))
            cls._guards.append(guard)

    @classmethod
    def detach(cls, guard: "SyncGuard") -> None:
        with cls._lock:
            if guard in cls._guards:
                cls._guards.remove(guard)
            if not cls._guards:
                for name, orig in cls._originals.items():
                    if orig is None:
                        delattr(torch.Tensor, name)
                    else:
                        setattr(torch.Tensor, name, orig)
                cls._originals.clear()

    @classmethod
    def _wrap(cls, name: str, orig):
        def counting(self_tensor, *args, **kwargs):
            for g in list(cls._guards):
                g._record(name)
            return orig(self_tensor, *args, **kwargs)

        counting.__name__ = f"_syncguard_{name}"
        return counting


def _sync_site() -> str:
    """The innermost three frames of the port or of torch's Python code at
    a reported sync (this module's own frames excluded)."""
    frames = [f for f in traceback.extract_stack()[:-2]
              if ("agilerl_tpu_torch" in f.filename or "/torch/" in f.filename)
              and str(Path(f.filename).resolve()) != _THIS_FILE]
    return " < ".join(f"{Path(f.filename).parent.name}/{Path(f.filename).name}"
                      f":{f.lineno}" for f in frames[::-1][:3])


class _SyncDebug:
    """Process-wide ``torch.cuda.set_sync_debug_mode("warn")`` with a
    ``warnings.showwarning`` hook that records each reported sync by site;
    installed while at least one CUDA SyncGuard is active. Warnings that
    are not syncs go on to the hook that was installed before."""

    _lock = threading.Lock()
    _guards: List["SyncGuard"] = []
    _state: Dict[str, Any] = {}
    _warmed = False

    @classmethod
    def _warm(cls) -> None:
        """Switch the debug mode on and off once, unrecorded, so a one-time
        cost of the first switch in a process lands in no guard's region."""
        if cls._warmed:
            return
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            torch.cuda.set_sync_debug_mode("warn")
            torch.cuda.set_sync_debug_mode(0)
        cls._warmed = True

    @classmethod
    def attach(cls, guard: "SyncGuard") -> None:
        with cls._lock:
            if not cls._guards:
                cls._warm()
                torch.cuda.synchronize()
                catcher = warnings.catch_warnings()
                catcher.__enter__()
                warnings.filterwarnings("always", message=".*synchroniz")
                prev = warnings.showwarning
                cls._state = dict(catcher=catcher, prev=prev,
                                  mode=torch.cuda.get_sync_debug_mode())
                warnings.showwarning = cls._show
                torch.cuda.set_sync_debug_mode("warn")
            cls._guards.append(guard)

    @classmethod
    def detach(cls, guard: "SyncGuard") -> None:
        with cls._lock:
            if guard in cls._guards:
                cls._guards.remove(guard)
            if not cls._guards and cls._state:
                state, cls._state = cls._state, {}
                try:
                    torch.cuda.set_sync_debug_mode(state["mode"])
                finally:
                    state["catcher"].__exit__(None, None, None)

    @classmethod
    def _show(cls, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            site = _sync_site()
            for g in list(cls._guards):
                g._record_site(site)
            return
        prev = cls._state.get("prev")
        if prev is not None:
            prev(message, category, filename, lineno, file, line)


class SyncGuard:
    """Count blocking device→host transfers inside a region.

    ``max_syncs=None`` only counts (and emits ``analysis/host_syncs_total``
    when a registry is attached); an integer budget raises
    :class:`SyncGuardError` when exceeded. ``device``: ``None`` is the card
    when one is present and the CPU otherwise; ``"cpu"`` counts the
    conversions only; a CUDA device also counts the runtime's syncs and
    raises when there is no card.

    After the region: ``syncs`` (the count the budget holds: the runtime's
    on a CUDA device, the conversions otherwise), ``conversions`` and
    ``by_kind`` (the patched methods), ``runtime_syncs`` and ``sites``
    (``{"dir/file.py:line < ...": n}``; CUDA only, else ``None`` and
    ``{}``).
    """

    def __init__(self, max_syncs: Optional[int] = None, label: str = "",
                 registry: Any = None, device: Any = None):
        self.max_syncs = max_syncs
        self.label = label
        self._registry = registry
        if device is None:
            self.cuda = torch.cuda.is_available()
        else:
            self.cuda = torch.device(device).type == "cuda"
            if self.cuda and not torch.cuda.is_available():
                raise RuntimeError(
                    "SyncGuard(device='cuda'): no CUDA device is available, "
                    "so the runtime's syncs cannot be counted")
        self.conversions = 0
        self.by_kind: Dict[str, int] = {}
        self.runtime_syncs: Optional[int] = None
        self.sites: Dict[str, int] = {}

    @property
    def syncs(self) -> int:
        return self.runtime_syncs if self.cuda else self.conversions

    def _record(self, kind: str) -> None:
        self.conversions += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1

    def _record_site(self, site: str) -> None:
        self.runtime_syncs += 1
        self.sites[site] = self.sites.get(site, 0) + 1

    def __enter__(self) -> "SyncGuard":
        self.conversions = 0
        self.by_kind = {}
        self.sites = {}
        self.runtime_syncs = 0 if self.cuda else None
        if self.cuda:
            _SyncDebug.attach(self)
        _SyncPatch.attach(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _SyncPatch.detach(self)
        if self.cuda:
            _SyncDebug.detach(self)
        if self._registry is not None and self.syncs:
            self._registry.counter(
                "analysis/host_syncs_total",
                help="blocking device->host transfers observed inside "
                     "SyncGuard regions",
            ).inc(self.syncs)
        if exc_type is None and self.max_syncs is not None \
                and self.syncs > self.max_syncs:
            where = f" [{self.label}]" if self.label else ""
            raise SyncGuardError(
                f"SyncGuard{where}: {self.syncs} blocking device→host "
                f"transfer(s) in a region budgeted for {self.max_syncs} "
                f"({self.by_kind}{', ' + str(self.sites) if self.cuda else ''})"
                f" — host-sync in a hot path (GX001 hazard)")
        return False
